"""whisper-medium [audio] — enc-dec, conv frontend (stub)
[arXiv:2212.04356; unverified].

24L (decoder; encoder also 24L) d_model=1024 16H (kv=16) d_ff=4096 vocab=51865.
The conv/mel frontend is a STUB per the assignment: ``input_specs`` provides
precomputed frame embeddings [B, encoder_frames, d_model].
"""
from repro_torch.configs.base import ArchConfig, EncDecConfig

CONFIG = ArchConfig(
    name="whisper-medium",
    family="audio",
    num_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    d_ff=4096,
    vocab_size=51865,
    head_dim=64,
    encdec=EncDecConfig(encoder_layers=24, encoder_frames=1500),
    source="[arXiv:2212.04356; unverified]",
)
