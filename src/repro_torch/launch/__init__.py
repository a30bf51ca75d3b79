"""Launchers of the port: :mod:`repro_torch.launch.serve` runs the AI-RAN
cluster under the full HAF stack on the card and holds the external-LLM
endpoint adapter (``make_llm_complete`` / ``make_llm_agent``) that the
``haf-llm`` method of :mod:`repro_torch.eval.policies` uses;
:mod:`repro_torch.launch.train` trains a zoo model on the card or on a
device mesh; :mod:`repro_torch.launch.mesh` gives the mesh shapes of
sharding specs and device meshes of them; :mod:`repro_torch.launch.dryrun`
traces every arch × cell on the 256- and 512-device meshes without a card
and prices it with :mod:`repro_torch.launch.hlo_analysis`."""
