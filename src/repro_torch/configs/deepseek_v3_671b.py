"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP
[arXiv:2412.19437; hf].

61L d_model=7168 128H d_ff(expert)=2048 vocab=129280, MoE 256e top-8.
MLA: q_lora=1536, kv_lora=512, qk_nope=128, qk_rope=64, v_head=128.
First 3 layers are dense (d_ff=18432) per the HF config.
"""
from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,     # MLA: latent cache, head count used for q/v heads
    d_ff=18432,           # dense-layer d_ff
    vocab_size=129280,
    moe=MoEConfig(num_experts=256, top_k=8, d_ff_expert=2048,
                  num_shared_experts=1, d_ff_shared=2048,
                  capacity_factor=1.25, first_dense_layers=3,
                  d_ff_dense=18432),
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    mtp=True,
    source="[arXiv:2412.19437; hf]",
)
