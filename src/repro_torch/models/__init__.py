"""The model zoo: the AI services that HAF places (twin of ``repro.models``).

  common       ParamDef trees, init, norms, RoPE, SwiGLU, the layer loop
  attention    GQA: full-sequence (``impl="flash"`` -> flash_attention) and
               decode
  transformer  the dense decoder-only LM stack
  ssm          the Mamba2 / SSD block (``impl="pallas"`` -> ssd_scan)
  api          ``Model`` and ``build_model``: the serving path

Ported families: ``dense`` and ``ssm``.  MoE, MLA, hybrid, encoder-decoder
and VLM follow (ROADMAP Queue A, model zoo).
"""
