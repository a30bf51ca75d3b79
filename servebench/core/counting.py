"""The yardstick's arithmetic: the card's published peaks and the operations
and bytes of a kernel call, from its shapes alone.

``flash_bound``, ``ssd_bound`` and ``bound_of`` are the functions the
kernel table of PERF.md was priced with: each input and output counted once
in its own dtype; causal attention at S(S+1)/2 score entries; the SSD at
the configuration's chunk, its quadratic form on and below each chunk's
diagonal plus the state's contribution and update.  A kernel's share of its
roofline is its bound over its device time.
"""
from __future__ import annotations

# published dense peaks of one card (NVIDIA data sheet, SXM part, 700 W),
# by the name torch.cuda.get_device_name() gives
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "f32_flops": 67e12,
                              "hbm_bytes_per_s": 3.35e12},
}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]
BF16_TC_FLOPS = H100["bf16_flops"]
F32_FLOPS = H100["f32_flops"]
HBM_BYTES_PER_S = H100["hbm_bytes_per_s"]


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind``; a card with no entry raises
    rather than be priced at another's rates."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}; add its data "
                       f"sheet's rates to PEAKS")
    return PEAKS[kind]


def flash_bound(B, S, H, KV, d, elem):
    bytes_ = B * S * (2 * H + 2 * KV) * d * elem        # q, k, v in; o out
    flops = 4 * B * H * d * (S * (S + 1) // 2)          # causal q.k and p.v
    return bytes_, flops, BF16_TC_FLOPS if elem == 2 else F32_FLOPS


def ssd_bound(b, s, h, g, p, n, chunk, elem):
    # x, y, dt, A, B, C and the final state, all in the inputs' dtype
    bytes_ = (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
              + b * h * p * n) * elem
    flops = 0
    for c0 in range(0, s, chunk):
        l = min(chunk, s - c0)
        tri = l * (l + 1) // 2
        # (C B^T) on and below the diagonal, its product with x, the carried
        # state's contribution and the state update
        flops += 2 * tri * (n + p) + 2 * l * n * p * 2
    return bytes_, flops * b * h, BF16_TC_FLOPS if elem == 2 else F32_FLOPS


def bound_of(bytes_, flops, peak):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_, "flops": flops, "peak_flops": peak}


def causal_attention_flops(B, S, H, d) -> int:
    """q kᵀ and p v over the S(S+1)/2 entries on and below the diagonal."""
    return 4 * B * H * d * (S * (S + 1) // 2)
