"""Mamba2's depthwise causal convolution, bias and SiLU as one hand-written
CUDA kernel.

No TPU kernel of the reference does this: its ``models/ssm.py`` writes the
convolution as static shifts and XLA fuses them with the SiLU.  One launch
computes ``silu(bias + Σ_k w[k] · x[t − (K−1) + k])`` over ``x [B, S, C]``
with float32 accumulation and writes the result in ``x``'s dtype, each thread
walking a strip of rows of 8 channels with the last K−1 rows in registers.
The kernel is ``csrc/causal_conv_silu.cu``; this module is its launcher.  The
plain version is :func:`repro_torch.kernels.ref.causal_conv_silu_ref`.  The
port's models reach it through ``models.ssm``, whose prefill under a kernel
lowering (``impl="flash"`` or ``"pallas"``) hands each of a mixer's three
convolutions (x, B and C) to ``ops.causal_conv_silu``.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# the convolution widths the kernel is instantiated for (d_conv of every
# configuration of the port)
KERNEL_SIZES = (4,)
# channels a thread: C must be a multiple
CHANNELS = 8


def causal_conv_silu_cuda(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on the current stream of ``x``'s device.

    ``x``: contiguous ``[B, S, C]``; ``w``: contiguous ``[K, C]``; ``b``:
    contiguous ``[C]`` in ``w``'s dtype; each float32 or bfloat16, as
    :func:`repro_torch.kernels.ops.causal_conv_silu` checks them.  Allocates
    the output, does not synchronise.
    """
    B, S, C = x.shape
    x, w, b = (_build.aligned16(t) for t in (x, w, b))
    out = torch.empty_like(x)
    dev = x.device
    with _build.on_device(dev):
        _build.launch(
            "causal_conv_silu", x.data_ptr(), w.data_ptr(), b.data_ptr(),
            out.data_ptr(), B, S, C, w.shape[0], _build.DTYPE_CODES[x.dtype],
            _build.DTYPE_CODES[w.dtype], _build.current_stream(dev))
    return out
