"""zamba2-7b [hybrid] — Zamba2-7B-Instruct at its published widths
[hf:Zyphra/Zamba2-7B-Instruct config.json; arXiv:2411.15242].

81 Mamba2 layers, d_model=3584, vocab 32000, 4096 positions: expand 2
(d_inner 7168), 112 heads of 64, 2 groups of d_state 64, d_conv 4, chunk
256.  Two shared transformer blocks serve the 13 hybrid layers
[6, 11, 17, ..., 77] in turn: each reads concat(hidden, embeddings) (7168
wide) with 32 heads of 224 (MHA, RoPE theta 10000), has a gated-GELU MLP of
14336 whose input product carries a rank-128 LoRA of each application's own,
and each application ends in a linear of its own (``HybridConfig``'s
published form).  The head is tied to the embedding (``Zamba2Config``'s
default; the published config omits the key).
"""
from repro_torch.configs.base import ArchConfig, HybridConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b",
    family="hybrid",
    num_layers=81,
    d_model=3584,
    num_heads=32,
    num_kv_heads=32,
    d_ff=14336,
    vocab_size=32000,
    head_dim=224,
    rope_theta=10_000.0,
    norm_eps=1e-5,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=64, d_conv=4, expand=2, head_dim=64,
                  n_groups=2, chunk_size=256),
    hybrid=HybridConfig(attn_every=6, shared_attn_blocks=2,
                        layer_ids=(6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65,
                                   71, 77),
                        adapter_rank=128),
    source="[hf:Zyphra/Zamba2-7B-Instruct; arXiv:2411.15242]",
)
