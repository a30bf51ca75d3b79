"""Launchers of the port: :mod:`repro_torch.launch.serve` runs the AI-RAN
cluster under the full HAF stack on the card and holds the external-LLM
endpoint adapter (``make_llm_complete`` / ``make_llm_agent``) that the
``haf-llm`` method of :mod:`repro_torch.eval.policies` uses;
:mod:`repro_torch.launch.train` trains a zoo model on the card;
:mod:`repro_torch.launch.mesh` gives the mesh shapes of sharding specs."""
