"""RMSNorm as a hand-written CUDA kernel.

Twin of the reference's ``kernels/rmsnorm.py`` (a Pallas TPU kernel over
128-row blocks): one launch normalises every row of ``x [rows, d]`` with
float32 statistics and writes the result in ``x``'s dtype, one warp per row
with the row in registers.  The kernel is ``csrc/rmsnorm.cu``; this module is
its launcher.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.  No model of either package
calls it: the models normalise with ``models.common.rms_norm``, and the
kernel is the library entry point ``ops.rmsnorm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor,
                 eps: float) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s device.

    ``x``: contiguous ``[rows, d]``, float32 or bfloat16; ``weight``:
    contiguous float32 ``[d]``, as :func:`repro_torch.kernels.ops.rmsnorm`
    prepares them.  Allocates the output, does not synchronise.
    """
    rows, d = x.shape
    x, weight = _build.aligned16(x), _build.aligned16(weight)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _build.launch(
            "rmsnorm", x.data_ptr(), weight.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _build.DTYPE_CODES[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    return out
