"""qwen2-0.5b [dense] — GQA, QKV bias [arXiv:2407.10671; hf].

24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151936.
Small-AI service class for HAF (sub-GB weights in bf16... ~1GB with the large
embedding; we classify by non-embedding weights, sub-second reload).
"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-0.5b",
    family="dense",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151936,
    head_dim=64,
    qkv_bias=True,
    tie_embeddings=True,
    source="[arXiv:2407.10671; hf]",
)
