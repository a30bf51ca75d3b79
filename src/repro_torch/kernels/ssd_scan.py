"""The Mamba2 SSD chunked scan as a hand-written CUDA kernel.

Twin of the reference's ``kernels/ssd_scan.py`` (a Pallas TPU kernel, grid
``(b*h, chunks)`` with the ``[p, n]`` state carried across the sequential
chunk axis): one launch runs every ``(batch, head)`` over all its chunks,
intra-chunk quadratic form plus carried state, and returns ``y`` and the
final float32 state.  The kernel is ``csrc/ssd_scan.cu``; this module is its
launcher.  The plain version is
:func:`repro_torch.kernels.ref.ssd_scan_sequential_ref` (the recurrence, a
different algorithm on purpose).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# widest head and state the kernel's thread layout covers (csrc/ssd_scan.cu)
MAX_P = 64
MAX_N = 128


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  B: torch.Tensor, C: torch.Tensor, chunk: int):
    """Launch the kernel on the current stream of ``x``'s device.

    ``x`` ``[b, S, h, p]``, ``dt`` ``[b, S, h]``, ``A`` ``[h]``, ``B, C``
    ``[b, S, g, n]``: contiguous, one dtype, as
    :func:`repro_torch.kernels.ops.ssd_scan` checks; ``chunk`` divides ``S``.
    Allocates ``y`` (``x``'s dtype), the float32 final state ``[b, h, p, n]``
    and a float32 ``[b*h, S]`` scratch row for the chunk cumsums; does not
    synchronise.  Returns ``(y, state)``.
    """
    b, S, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    dev = x.device
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    csum = torch.empty((b * h, S), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "ssd_scan", x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            B.data_ptr(), C.data_ptr(), y.data_ptr(), state.data_ptr(),
            csum.data_ptr(), b, S, h, g, p, n, chunk,
            _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(dev).cuda_stream)
    return y, state
