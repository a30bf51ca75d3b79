"""RMSNorm as a hand-written CUDA kernel.

Twin of the reference's ``kernels/rmsnorm.py`` (a Pallas TPU kernel over
128-row blocks): one launch normalises every row of ``x [rows, d]`` with
float32 statistics and writes the result in ``x``'s dtype, one warp per row
with the row in registers.  The kernel is ``csrc/rmsnorm.cu``; this module is
its launcher.  The plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref`.  The port's models reach it
through ``models.common.rms_norm``, which hands every norm of a kernel
lowering (``impl="flash"`` or ``"pallas"``: each prefill, forward and
decode step of every family) to ``ops.rmsnorm``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def rmsnorm_cuda(x: torch.Tensor, weight: torch.Tensor, eps: float,
                 groups: int = 1) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s device.

    ``x``: contiguous ``[rows, d]``; ``weight``: contiguous ``[groups *
    d]``, row ``r`` scaled by its part ``r % groups``; each float32 or
    bfloat16 (the kernel reads the weight in its own dtype), as
    :func:`repro_torch.kernels.ops.rmsnorm` prepares them.  Allocates the
    output, does not synchronise.
    """
    rows, d = x.shape
    x, weight = _build.aligned16(x), _build.aligned16(weight)
    out = torch.empty_like(x)
    dev = x.device
    with _build.on_device(dev):
        _build.launch(
            "rmsnorm", x.data_ptr(), weight.data_ptr(), out.data_ptr(),
            rows, d, float(eps), _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[weight.dtype], groups,
            _build.current_stream(dev))
    return out
