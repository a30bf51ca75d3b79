"""Public wrappers for the hand-written kernels.

A wrapper checks dtype, shape, contiguity and device, launches its kernel
and adds one to its launch count.  It takes the kernel's plain version
(:mod:`repro_torch.kernels.ref`) only for tensors that lie on the CPU; on
CUDA tensors it launches the kernel or raises — there is no fallback.  The
kernels mask the ragged edge themselves, so nothing is padded here.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref as kref
from repro_torch.kernels.alloc_active_set import MAX_S, alloc_active_set_cuda
from repro_torch.kernels.event_step import event_step_cuda

# kernel launches per wrapper since the last reset — incremented only where
# a kernel is launched, never on the plain (CPU) path
_launches: Dict[str, int] = {"event_step": 0, "alloc_active_set": 0}


def launch_counts() -> Dict[str, int]:
    """A copy of the per-kernel launch counts."""
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape,
           device: torch.device) -> None:
    if x.dtype != dtype or tuple(x.shape) != tuple(shape) \
            or x.device != device or not x.is_contiguous():
        raise ValueError(
            f"{name}: expected contiguous {dtype} {tuple(shape)} on {device}, "
            f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            f"{'' if x.is_contiguous() else ' (not contiguous)'}")


def event_step(rem_g: torch.Tensor, rem_c: torch.Tensor,
               alloc_g: torch.Tensor, alloc_c: torch.Tensor,
               avail: torch.Tensor, t: torch.Tensor, t_ev: torch.Tensor,
               live: torch.Tensor):
    """One ``[B, S]`` lockstep tick.

    ``rem_g, rem_c, alloc_g, alloc_c``: f64 ``[B, S]``; ``avail``: bool
    ``[B, S]``; ``t, t_ev``: f64 ``[B]``; ``live``: bool ``[B]``; all
    contiguous and on one device (checked, never copied silently).
    Returns ``(rem_g', rem_c', started [B,S] bool, t_comp [B] f64,
    sid [B] int32)``.
    """
    if rem_g.dim() != 2 or rem_g.shape[0] < 1 or rem_g.shape[1] < 1:
        raise ValueError(f"event_step: rem_g must be a non-empty [B, S] "
                         f"block, got {tuple(rem_g.shape)}")
    B, S = rem_g.shape
    dev = rem_g.device
    for name, x in (("rem_g", rem_g), ("rem_c", rem_c),
                    ("alloc_g", alloc_g), ("alloc_c", alloc_c)):
        _check(f"event_step {name}", x, torch.float64, (B, S), dev)
    _check("event_step avail", avail, torch.bool, (B, S), dev)
    _check("event_step t", t, torch.float64, (B,), dev)
    _check("event_step t_ev", t_ev, torch.float64, (B,), dev)
    _check("event_step live", live, torch.bool, (B,), dev)
    if dev.type == "cpu":
        return kref.event_step_ref(rem_g, rem_c, alloc_g, alloc_c, avail,
                                   t, t_ev, live)
    out = event_step_cuda(rem_g, rem_c, alloc_g, alloc_c, avail, t, t_ev,
                          live)
    _launches["event_step"] += 1
    return out


def alloc_active_set(psi: torch.Tensor, omega: torch.Tensor,
                     floors: torch.Tensor, capacity: torch.Tensor,
                     mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[N, S]`` fleet allocation, f32 like the reference kernel: inputs
    are cast to float32 (``mask`` to bool) and made contiguous.  Returns
    ``(alloc [N,S] f32, feasible [N] bool, pinned [N,S] bool)``."""
    if psi.dim() != 2 or psi.shape[0] < 1 or psi.shape[1] < 1:
        raise ValueError(f"alloc_active_set: psi must be a non-empty [N, S] "
                         f"block, got {tuple(psi.shape)}")
    N, S = psi.shape
    if S > MAX_S:
        raise ValueError(f"alloc_active_set: S={S} exceeds the kernel's "
                         f"row limit of {MAX_S} lanes")
    dev = psi.device
    psi32, omega32, floors32 = (
        x.to(torch.float32).contiguous() for x in (psi, omega, floors))
    cap32 = capacity.to(torch.float32).reshape(N).contiguous()
    mask_b = mask.to(torch.bool).contiguous()
    for name, x in (("psi", psi32), ("omega", omega32),
                    ("floors", floors32)):
        _check(f"alloc_active_set {name}", x, torch.float32, (N, S), dev)
    _check("alloc_active_set capacity", cap32, torch.float32, (N,), dev)
    _check("alloc_active_set mask", mask_b, torch.bool, (N, S), dev)
    if dev.type == "cpu":
        return kref.alloc_active_set_ref(psi32, omega32, floors32, cap32,
                                         mask_b)
    out = alloc_active_set_cuda(psi32, omega32, floors32, cap32, mask_b)
    _launches["alloc_active_set"] += 1
    return out
