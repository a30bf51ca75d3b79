"""The Mamba2 SSD chunked scan as hand-written CUDA kernels.

Twin of the reference's ``kernels/ssd_scan.py`` (a Pallas TPU kernel, grid
``(b*h, chunks)`` with the ``[p, n]`` state carried across the sequential
chunk axis).  The kernels are ``csrc/ssd_scan.cu``; this module is their
launcher.  The element type decides the design: float32 inputs run one
CUDA-core kernel that walks every ``(batch, head)`` over its chunks in order
(held to 1e-4 against the recurrence); bfloat16 inputs run the
state-passing form on the tensor cores — every chunk's own state, the float32
passing of the state across chunks (its own launch past two chunks, folded
into the output kernel up to two), every chunk's outputs.
The plain versions are :func:`repro_torch.kernels.ref.ssd_scan_sequential_ref`
(the recurrence, a different algorithm on purpose) and
:func:`repro_torch.kernels.ref.ssd_scan_chunked_ref` (the bf16 design's
algorithm and, with ``bf16_points=True``, its rounding).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build

# widest head and state the kernels cover (csrc/ssd_scan.cu)
MAX_P = 64
MAX_N = 128
# at most this many chunks the bf16 route needs no pass kernel: the state
# kernel writes in_1 = delta_0 and the output kernel the final state
# (FOLD_CHUNKS in csrc/ssd_scan.cu)
FOLD_CHUNKS = 2


def state_cols(nx: int, heads_per_group: int) -> int:
    """The bf16 route's tile width NT for a state dim padded to ``nx``
    columns: 64 up to 64 where the heads share a group evenly (two heads a
    block of the output kernel), else 128 (``launch_tc`` in
    csrc/ssd_scan.cu)."""
    return 64 if nx <= 64 and heads_per_group % 2 == 0 else MAX_N


def _rows_of_8(t: torch.Tensor) -> torch.Tensor:
    """``t`` with its last dim zero-padded to a multiple of 8 (a TMA map's
    rows must be a multiple of 16 bytes) and 16-byte aligned."""
    pad = -t.shape[-1] % 8
    return F.pad(t, (0, pad)) if pad else _build.aligned16(t)


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Launch the kernel(s) on the current stream of ``x``'s device.

    ``x`` ``[b, S, h, p]``, ``dt`` ``[b, S, h]``, ``A`` ``[h]``, ``B, C``
    ``[b, S, g, n]``: contiguous, one dtype, as
    :func:`repro_torch.kernels.ops.ssd_scan` checks; ``chunk`` divides ``S``.
    Allocates ``y`` and the final state ``[b, h, p, n]`` (``x``'s dtype: the
    state is carried in float32 and rounded once) and scratch (the float32
    chunk cumsums; for bf16 also the chunk states and totals, and the
    incoming states as hi / lo bf16 pairs); does not synchronise.  Returns
    ``(y, state)``.
    """
    b, S, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dev = x.device
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=x.dtype, device=dev)
    csum = torch.empty((b * h, S), dtype=torch.float32, device=dev)
    null = torch.empty(0, device=dev)
    delta = totals = in_hi = in_lo = null
    px, nx = p, n
    if x.dtype == torch.bfloat16:
        x, B, C = (_rows_of_8(t) for t in (x, B, C))
        px, nx = x.shape[-1], B.shape[-1]
        nc = -(-S // chunk)
        tile = (b * h * nc, MAX_P, state_cols(nx, h // g))
        delta = torch.empty(tile, dtype=torch.float32, device=dev)
        totals = torch.empty(b * h * nc, dtype=torch.float32, device=dev)
        in_hi = torch.empty(tile, dtype=torch.bfloat16, device=dev)
        in_lo = torch.empty_like(in_hi)
    with torch.cuda.device(dev):
        _build.launch(
            "ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
            csum.data_ptr(), delta.data_ptr(), totals.data_ptr(),
            in_hi.data_ptr(), in_lo.data_ptr(), b, S, h, g, p, px, n, nx,
            chunk,
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return y, state
