"""The batched event-engine step as a hand-written CUDA kernel.

Twin of the reference's ``kernels/event_step.py`` (a Pallas TPU kernel, one
grid row per replica): one launch moves the whole ``[B, S]`` block of a
``Simulator.run_batch`` tick — per-row completion scan (masked min +
first-index argmin) fused with the advance-to-next-event update.  The kernel
is ``csrc/event_step.cu``; this module is its launcher.  The plain version
is :func:`repro_torch.kernels.ref.event_step_ref`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build


def event_step_cuda(rem_g: torch.Tensor, rem_c: torch.Tensor,
                    alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                    avail: torch.Tensor, t: torch.Tensor,
                    t_ev: torch.Tensor, live: torch.Tensor):
    """Launch the kernel on the current stream of the inputs' device.

    Inputs are checked by :func:`repro_torch.kernels.ops.event_step`
    (contiguous, one CUDA device, f64 / bool).  Allocates the five outputs,
    does not synchronise.  Returns ``(rem_g', rem_c', started bool,
    t_comp, sid int32)``.
    """
    B, S = rem_g.shape
    dev = rem_g.device
    rg_out = torch.empty_like(rem_g)
    rc_out = torch.empty_like(rem_c)
    started = torch.empty((B, S), dtype=torch.uint8, device=dev)
    t_comp = torch.empty(B, dtype=torch.float64, device=dev)
    sid = torch.empty(B, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.launch(
            "event_step",
            rem_g.data_ptr(), rem_c.data_ptr(), alloc_g.data_ptr(),
            alloc_c.data_ptr(), avail.view(torch.uint8).data_ptr(),
            t.data_ptr(), t_ev.data_ptr(), live.view(torch.uint8).data_ptr(),
            rg_out.data_ptr(), rc_out.data_ptr(), started.data_ptr(),
            t_comp.data_ptr(), sid.data_ptr(), B, S,
            torch.cuda.current_stream(dev).cuda_stream)
    return rg_out, rc_out, started.view(torch.bool), t_comp, sid
