"""mamba2-130m [ssm] — SSD (state-space duality) [arXiv:2405.21060; unverified].

24L d_model=768, attention-free, vocab=50280, ssm_state=128.
Small-AI service class for HAF (sub-GB weights, sub-second reload).
"""
from repro_torch.configs.base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="mamba2-130m",
    family="ssm",
    num_layers=24,
    d_model=768,
    num_heads=0,          # attention-free
    num_kv_heads=0,
    d_ff=0,
    vocab_size=50280,
    tie_embeddings=True,
    ssm=SSMConfig(d_state=128, d_conv=4, expand=2, head_dim=64,
                  n_groups=1, chunk_size=256),
    source="[arXiv:2405.21060; unverified]",
)
