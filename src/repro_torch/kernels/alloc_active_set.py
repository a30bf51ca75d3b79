"""The closed-form deadline-aware allocator as a hand-written CUDA kernel.

Twin of the reference's ``kernels/alloc_active_set.py`` (a Pallas TPU
kernel, one grid step per node): one launch solves the Eq. 17-19 active-set
fixed point for every (node, resource) row of a fleet.  The kernel is
``csrc/alloc_active_set.cu`` and is f32 by design, held to the f64 host
solver by tolerance; this module is its launcher.  The plain version is
:func:`repro_torch.kernels.ref.alloc_active_set_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build

# longest row one launch takes: 8 lanes on each of 1024 threads
# (MAX_LPT * MAX_THREADS in csrc/alloc_active_set.cu)
MAX_S = 8192


def alloc_active_set_cuda(psi: torch.Tensor, omega: torch.Tensor,
                          floors: torch.Tensor, capacity: torch.Tensor,
                          mask: torch.Tensor):
    """Launch the kernel on the current stream of the inputs' device.

    Inputs are prepared by :func:`repro_torch.kernels.ops.alloc_active_set`
    (contiguous f32 ``[N, S]``, ``capacity`` f32 ``[N]``, ``mask`` bool).
    Allocates the outputs, does not synchronise.  Returns ``(alloc f32,
    feasible bool [N], pinned bool [N, S])``.
    """
    N, S = psi.shape
    dev = psi.device
    alloc = torch.empty((N, S), dtype=torch.float32, device=dev)
    feasible = torch.empty(N, dtype=torch.uint8, device=dev)
    pinned = torch.empty((N, S), dtype=torch.uint8, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "alloc_active_set",
            psi.data_ptr(), omega.data_ptr(), floors.data_ptr(),
            capacity.data_ptr(), mask.view(torch.uint8).data_ptr(),
            alloc.data_ptr(), feasible.data_ptr(), pinned.data_ptr(), N, S,
            torch.cuda.current_stream(dev).cuda_stream)
    return alloc, feasible.view(torch.bool), pinned.view(torch.bool)
