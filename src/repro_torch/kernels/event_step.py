"""The batched event-engine step as a hand-written CUDA kernel.

Twin of the reference's ``kernels/event_step.py`` (a Pallas TPU kernel, one
grid row per replica): one launch moves the whole ``[B, S]`` block of a
``Simulator.run_batch`` tick — per-row completion scan (masked min +
first-index argmin) fused with the advance-to-next-event update.  The kernel
is ``csrc/event_step.cu``: each row is split across a thread-block cluster,
one lane per thread held in registers across both phases
(:func:`event_step_geometry` chooses the split).  This module is its
launcher.  The plain version is :func:`repro_torch.kernels.ref.event_step_ref`.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import _build

MAX_CLUSTER = 8          # the portable thread-block cluster size
MAX_THREADS = 1024       # threads per CTA


class Geometry(NamedTuple):
    cluster: int         # CTAs per replica row
    threads: int         # threads per CTA, a multiple of 32


def event_step_geometry(B: int, S: int,
                        sms: int = _build.H100_SMS) -> Geometry:
    """How the kernel splits a ``[B, S]`` block: each row takes a cluster
    of ``c`` CTAs — as many as keep the B clusters within the card's
    ``sms`` SMs, at most 8, and no more than the row has 32-lane warps —
    and each CTA is wide enough to give every lane of the row one thread,
    up to 1024 threads.  Thread ``tid`` of CTA ``rank`` holds lane
    ``rank * threads + tid`` in registers; lanes past ``c * threads`` go to
    a strided loop, ``c * threads`` apart.  At ``[32, 1440]`` on 132 SMs:
    4 CTAs of 384 threads per row, 128 CTAs."""
    if B < 1 or S < 1:
        raise ValueError(f"event_step_geometry: B={B}, S={S} must be >= 1")
    warps = -(-S // 32)
    c = max(1, min(MAX_CLUSTER, sms // B, warps))
    threads = min(MAX_THREADS, 32 * -(-warps // c))
    return Geometry(c, threads)


def event_step_cuda(rem_g: torch.Tensor, rem_c: torch.Tensor,
                    alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                    avail: torch.Tensor, t: torch.Tensor,
                    t_ev: torch.Tensor, live: torch.Tensor):
    """Launch the kernel on the current stream of the inputs' device.

    Inputs are checked by :func:`repro_torch.kernels.ops.event_step`
    (contiguous, one CUDA device, f64 / bool); the split is
    :func:`event_step_geometry` on this card.  Allocates the five outputs,
    does not synchronise.  Returns ``(rem_g', rem_c', started bool,
    t_comp, sid int32)``.
    """
    B, S = rem_g.shape
    dev = rem_g.device
    geom = event_step_geometry(B, S, _build.sm_count(dev.index))
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
            t_comp.data_ptr(), sid.data_ptr(), B, S, geom.cluster,
            geom.threads, torch.cuda.current_stream(dev).cuda_stream)
    return rg_out, rc_out, started.view(torch.bool), t_comp, sid
