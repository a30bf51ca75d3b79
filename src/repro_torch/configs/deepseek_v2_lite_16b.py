"""deepseek-v2-lite-16b [moe] — MLA kv_lora=512 [arXiv:2405.04434; hf].

27L d_model=2048 16H d_ff(expert)=1408 vocab=102400, MoE 64e top-6.

Note: the assignment line mentions both "MoE 64e top-6" and "2 shared + 160
routed top-6"; the latter describes full DeepSeek-V2.  V2-*Lite* (the 16B
model named here) has 64 routed experts, top-6, 2 shared experts, q_lora=0
(direct q projection), first layer dense with d_ff=10944 — we follow the HF
config for V2-Lite.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v2-lite-16b",
    family="moe",
    num_layers=27,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=10944,           # dense-layer d_ff
    vocab_size=102400,
    moe=MoEConfig(num_experts=64, top_k=6, d_ff_expert=1408,
                  num_shared_experts=2, d_ff_shared=1408,
                  capacity_factor=1.25, first_dense_layers=1,
                  d_ff_dense=10944),
    mla=MLAConfig(q_lora_rank=0, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    source="[arXiv:2405.04434; hf]",
)
