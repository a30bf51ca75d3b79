"""llava-next-mistral-7b [vlm] — anyres tiling
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified].

Backbone: Mistral-7B — 32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000.
The vision tower / anyres tiling is a STUB per the assignment: ``input_specs``
provides precomputed patch embeddings (576 base-res patches, already projected
to d_model) that are concatenated ahead of the text tokens.
"""
from repro_torch.configs.base import ArchConfig, VLMConfig

CONFIG = ArchConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    head_dim=128,
    rope_theta=1_000_000.0,
    vlm=VLMConfig(num_patches=576),
    source="[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]",
)
