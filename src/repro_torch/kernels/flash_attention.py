"""Causal grouped-query flash attention as a hand-written CUDA kernel.

Twin of the reference's ``kernels/flash_attention.py`` (a Pallas TPU kernel,
grid ``(B*H, q blocks, k blocks)``): one launch computes
``softmax(q k^T / sqrt(d)) v`` for every head by blockwise online softmax,
reading the ``[B, S, H, d]`` / ``[B, S, KV, d]`` layouts of the model zoo
directly (no head transposes, no repeated KV heads).  The kernel is
``csrc/flash_attention.cu``: bfloat16 inputs run on the tensor cores
(``wgmma`` fed by TMA, P rounded to bfloat16 before ``P v``), float32 inputs
on the CUDA cores in float32; head dims 80 (zamba2's) and 128 (llava's) run
on both routes, the bf16 one in designs of their own: at 80, tiles exactly
80 columns wide (a 64-column and a 16-column TMA box), 128 query rows a
block in two warpgroups that share each key / value tile; at 128, one
persistent block an SM walking (head, 128 query rows) items, fed by a
producer warp; at 224 (zamba2-7b's shared attention), tiles exactly 224
columns wide (three 64-column boxes and a 32-column one), 128 query rows a
block in two warpgroups over a two-stage ring of 64-key tiles, each stage
refilled by the warpgroup that releases it last.  ``scale`` multiplies the
scores (``1 / sqrt(d)`` unless the model gives its own).  This module is
its launcher.
The plain
version is :func:`repro_torch.kernels.ref.attention_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# head dims the kernel is instantiated for (csrc/flash_attention.cu)
HEAD_DIMS = (16, 32, 64, 80, 128, 224)


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool, scale: float) -> torch.Tensor:
    """Launch the kernel on the current stream of ``q``'s device.

    ``q`` ``[B, S, H, d]``, ``k, v`` ``[B, S, KV, d]``: contiguous, one dtype
    (float32 or bfloat16), ``H % KV == 0``, ``d`` in :data:`HEAD_DIMS`, as
    :func:`repro_torch.kernels.ops.flash_attention` checks; ``scale``
    multiplies the scores.  Allocates the output ``[B, S, H, d]`` in
    ``q``'s dtype, does not synchronise.
    """
    B, S, H, d = q.shape
    KV = k.shape[2]
    q, k, v = (_build.aligned16(t) for t in (q, k, v))
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        _build.launch(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), B, S, H, KV, d, float(scale), int(causal),
            _build.DTYPE_CODES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    return out
