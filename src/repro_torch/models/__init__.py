"""The model zoo: the AI services that HAF places (twin of ``repro.models``).

  common       ParamDef trees, init, norms, RoPE, sinusoidal positions,
               SwiGLU, the layer loop
  attention    GQA: full-sequence (``impl="flash"`` -> flash_attention),
               decode and cross-attention decode; MLA (DeepSeek): expanded
               full-sequence, absorbed decode over the compressed cache
  moe          top-k routing, capacity slots, grouped expert einsum
  transformer  the decoder-only LM stack: dense, MoE (+ MLA), VLM prefix
  ssm          the Mamba2 / SSD block (``impl="pallas"`` -> ssd_scan)
  hybrid       Zamba2: Mamba2 layers with shared attention blocks
  encdec       Whisper: bidirectional encoder, causal decoder with cross
               attention
  api          ``Model`` and ``build_model``: the serving path, the
               training loss, parameter / cache specs and axes

Every family of ``configs/`` is served and trained: ``dense``, ``ssm``,
``hybrid``, ``moe``, ``audio`` and ``vlm`` (``Model.loss``; the training
loop is ``repro_torch.train``).
"""
