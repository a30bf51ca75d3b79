"""zamba2-2.7b [hybrid] — Mamba2 trunk + shared attention blocks
[arXiv:2411.15242; hf].

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64.

Faithfulness note: real Zamba2 interleaves two shared attention+MLP blocks
(with per-application LoRA adapters) every ~6 Mamba2 layers.  We implement the
shared-block structure (round-robin over ``shared_attn_blocks`` distinct
blocks, applied every ``attn_every`` SSM layers) without the LoRA adapters —
the parameter-sharing pattern that defines the architecture is preserved.
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    num_layers=54,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    d_ff=10240,
    vocab_size=32000,
    head_dim=80,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_blocks=2),
    source="[arXiv:2411.15242; hf]",
)
