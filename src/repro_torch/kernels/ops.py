"""Public wrappers for the hand-written kernels.

A wrapper checks dtype, shape, contiguity and device, launches its kernel
and adds one to its launch count.  It takes the kernel's plain version
(:mod:`repro_torch.kernels.ref`) only for tensors that lie on the CPU; on
CUDA tensors it launches the kernel or raises — there is no fallback.  The
kernels mask the ragged edge themselves, so nothing is padded here.

No kernel has a backward pass (neither has the reference's: it cannot
differentiate through its Pallas kernels).  A kernel writes into a fresh
tensor outside autograd, so its output would silently be a constant to a
backward pass; ``flash_attention``, ``ssd_scan``, ``rmsnorm`` and
``causal_conv_silu``, which the models reach, therefore raise where grad
mode is on and an input requires grad, on every device, so that the CPU's
differentiable plain path and the card agree.  Training takes
``impl="xla"``, as in the reference.  On a device mesh ``flash_attention``
and ``rmsnorm`` take ``DTensor``s and launch on each rank's shard (the
models hand ``causal_conv_silu`` each rank's local rows and channels).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import _build
from repro_torch.kernels import ref as kref
from repro_torch.kernels.alloc_active_set import MAX_S, alloc_active_set_cuda
from repro_torch.kernels.causal_conv_silu import (CHANNELS, KERNEL_SIZES,
                                                  causal_conv_silu_cuda)
from repro_torch.kernels.event_step import event_step_cuda
from repro_torch.kernels.flash_attention import (HEAD_DIMS,
                                                 flash_attention_cuda)
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.kernels.ssd_scan import MAX_N, MAX_P, ssd_scan_cuda

# kernel launches per wrapper since the last reset — incremented only where
# a kernel is launched, never on the plain (CPU) path
_launches: Dict[str, int] = {name: 0 for name in _build.KERNELS}


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


def _as_contiguous(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` itself where it is a contiguous ``dtype`` tensor (no dispatch),
    else a contiguous ``dtype`` copy."""
    if x.dtype == dtype and x.is_contiguous():
        return x
    return x.to(dtype).contiguous()


def alloc_active_set(psi: torch.Tensor, omega: torch.Tensor,
                     floors: torch.Tensor, capacity: torch.Tensor,
                     mask: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[N, S]`` fleet allocation, f32 like the reference kernel: inputs
    are cast to float32 (``mask`` to bool) and made contiguous where they
    are not already.  Returns ``(alloc [N,S] f32, feasible [N] bool,
    pinned [N,S] bool)``."""
    if psi.dim() != 2 or psi.shape[0] < 1 or psi.shape[1] < 1:
        raise ValueError(f"alloc_active_set: psi must be a non-empty [N, S] "
                         f"block, got {tuple(psi.shape)}")
    N, S = psi.shape
    if S > MAX_S:
        raise ValueError(f"alloc_active_set: S={S} exceeds the kernel's "
                         f"row limit of {MAX_S} lanes")
    dev = psi.device
    psi32, omega32, floors32 = (_as_contiguous(x, torch.float32)
                                for x in (psi, omega, floors))
    cap32 = _as_contiguous(capacity if capacity.shape == (N,)
                           else capacity.reshape(N), torch.float32)
    mask_b = _as_contiguous(mask, torch.bool)
    # dtype and contiguity hold by construction: shape and device remain
    for name, x in (("omega", omega32), ("floors", floors32),
                    ("mask", mask_b)):
        if x.shape != psi.shape or x.device != dev:
            raise ValueError(f"alloc_active_set {name}: expected {(N, S)} on "
                             f"{dev}, got {tuple(x.shape)} on {x.device}")
    if cap32.device != dev:
        raise ValueError(f"alloc_active_set capacity: expected {dev}, got "
                         f"{cap32.device}")
    if dev.type == "cpu":
        return kref.alloc_active_set_ref(psi32, omega32, floors32, cap32,
                                         mask_b)
    out = alloc_active_set_cuda(psi32, omega32, floors32, cap32, mask_b)
    _launches["alloc_active_set"] += 1
    return out


def _refuse_autograd(name: str, *tensors: Optional[torch.Tensor]) -> None:
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the kernel has no backward pass, and an input requires "
            f"grad; differentiate the impl='xla' path (as the reference's "
            f"training does) or run the kernel under torch.no_grad()")


def _check_model_dtype(name: str, dtype: torch.dtype) -> None:
    if dtype not in _build.DTYPE_CODES:
        raise ValueError(f"{name}: the kernel takes float32 or bfloat16, "
                         f"got {dtype}")


def _check_same(name: str, ref: torch.Tensor, **others: torch.Tensor) -> None:
    for key, t in others.items():
        if t.dtype != ref.dtype or t.device != ref.device:
            raise ValueError(
                f"{name}: {key} is {t.dtype} on {t.device}, expected "
                f"{ref.dtype} on {ref.device} like the first input")


# --------------------------------------------------------------------------- #
# model kernels
# --------------------------------------------------------------------------- #
def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q [B,S,H,d]; k,v [B,S,KV,d] -> [B,S,H,d] in q's dtype (blockwise
    online softmax, float32 statistics) of ``softmax(scale q kᵀ) v``,
    ``scale`` ``1 / sqrt(d)`` unless given.  Inputs are made contiguous;
    any ``S`` is taken as it is (the kernel masks the tails).  Raises under
    autograd (see the module docstring).

    ``DTensor`` inputs on a device mesh: each rank launches the kernel on
    its own shard, which must hold whole heads and the whole sequence
    (batch and heads may be sharded, q, k and v alike, and the KV heads
    must divide the heads' shards so that no query group straddles two);
    any other layout raises ``ValueError`` naming it."""
    if isinstance(q, DTensor):
        return _flash_on_shards(q, k, v, causal, scale)
    _refuse_autograd("flash_attention", q, k, v)
    if q.dim() != 4 or k.dim() != 4 or q.numel() == 0:
        raise ValueError(f"flash_attention: expected non-empty q [B,S,H,d] "
                         f"and k, v [B,S,KV,d], got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}")
    B, S, H, d = q.shape
    KV = k.shape[2]
    if tuple(k.shape) != (B, S, KV, d) or tuple(v.shape) != (B, S, KV, d) \
            or H % KV:
        raise ValueError(f"flash_attention: k, v must be [B,S,KV,d] with "
                         f"H % KV == 0; got q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {d} not in {HEAD_DIMS}")
    _check_model_dtype("flash_attention", q.dtype)
    _check_same("flash_attention", q, k=k, v=v)
    if q.device.type == "cpu":
        return kref.attention_ref(q.float(), k.float(), v.float(),
                                  causal=causal, scale=scale).to(q.dtype)
    out = flash_attention_cuda(q.contiguous(), k.contiguous(), v.contiguous(),
                               causal, 1.0 / math.sqrt(d) if scale is None
                               else scale)
    _launches["flash_attention"] += 1
    return out


def _flash_on_shards(q, k, v, causal: bool, scale) -> DTensor:
    """:func:`flash_attention` of each rank's shard (see there)."""
    if not (isinstance(k, DTensor) and isinstance(v, DTensor)):
        raise ValueError("flash_attention: q is a DTensor and k, v are not")
    mesh, pl = q.device_mesh, q.placements
    for name, t in (("k", k), ("v", v)):
        if t.device_mesh != mesh or t.placements != pl:
            raise ValueError(f"flash_attention: {name} is placed "
                             f"{t.placements}, q {pl}; they must agree")
    for dim_name, p in zip(mesh.mesh_dim_names, pl):
        if not (isinstance(p, Replicate)
                or isinstance(p, Shard) and p.dim in (0, 2)):
            raise ValueError(
                f"flash_attention: placement {p} on mesh dim {dim_name!r} "
                f"splits a head or the sequence (or is partial); the kernel "
                f"takes shards of batch (dim 0) and whole heads (dim 2) only")
        if isinstance(p, Shard) and p.dim == 2 and \
                k.shape[2] % mesh.size(mesh.mesh_dim_names.index(dim_name)):
            raise ValueError(
                f"flash_attention: heads sharded on {dim_name!r} "
                f"({mesh.size(mesh.mesh_dim_names.index(dim_name))} ways) "
                f"with {k.shape[2]} KV heads would split a query group")
    out = flash_attention(q.to_local(), k.to_local(), v.to_local(),
                          causal=causal, scale=scale)
    return DTensor.from_local(out, mesh, pl, run_check=False)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, chunk: int = 256,
             initial_state: Optional[torch.Tensor] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n] -> (y [b,s,h,p],
    state [b,h,p,n]), both in x's dtype (the state is carried in float32).

    As in the reference wrapper: the B/C group of head ``h`` is ``h // (h //
    g)`` (resolved here by index, never copied); ``chunk`` is halved until it
    divides ``s``; an ``initial_state`` is not supported (decode uses the
    O(1) recurrence instead).  All five inputs share one dtype.  Raises
    under autograd (see the module docstring).
    """
    _refuse_autograd("ssd_scan", x, dt, A, B, C, initial_state)
    if initial_state is not None:
        raise NotImplementedError("initial_state handled by decode path")
    if x.dim() != 4 or x.numel() == 0:
        raise ValueError(f"ssd_scan: x must be a non-empty [b,s,h,p], got "
                         f"{tuple(x.shape)}")
    b, s, h, p = x.shape
    if B.dim() != 4 or tuple(B.shape[:2]) != (b, s) \
            or tuple(C.shape) != tuple(B.shape):
        raise ValueError(f"ssd_scan: B, C must be [b,s,g,n]; got "
                         f"{tuple(B.shape)}, {tuple(C.shape)}")
    g, n = B.shape[2], B.shape[3]
    if tuple(dt.shape) != (b, s, h) or tuple(A.shape) != (h,) or h % g:
        raise ValueError(f"ssd_scan: expected dt [b,s,h], A [h], h % g == 0;"
                         f" got dt {tuple(dt.shape)}, A {tuple(A.shape)}, "
                         f"g={g}")
    if p > MAX_P or n > MAX_N:
        raise ValueError(f"ssd_scan: head_dim {p} / d_state {n} above the "
                         f"kernel's {MAX_P} / {MAX_N}")
    _check_model_dtype("ssd_scan", x.dtype)
    _check_same("ssd_scan", x, dt=dt, A=A, B=B, C=C)
    while s % chunk:
        chunk //= 2
    if x.device.type == "cpu":
        return kref.ssd_scan_sequential_ref(x, dt, A, B, C)
    y, state = ssd_scan_cuda(x.contiguous(), dt.contiguous(), A.contiguous(),
                             B.contiguous(), C.contiguous(), chunk)
    _launches["ssd_scan"] += 1
    return y, state


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
            groups: int = 1) -> torch.Tensor:
    """x [..., d]; weight [d] -> x's shape and dtype (float32 statistics).
    ``groups`` > 1: each of the ``groups`` equal parts of the last dim is
    normalised by its own statistics (Mamba2's grouped gate norm), the
    weight applied whole.  ``x`` and ``weight`` may each be float32 or
    bfloat16; the kernel reads each in its own dtype and widens it to
    float32 (exact), so no cast is launched before it.  Raises under
    autograd (see the module docstring).

    A ``DTensor`` ``x`` on a device mesh: its rows are made whole (a shard
    of the last dim, or a partial sum, gathered; batch and sequence shards
    kept), the weight replicated, and each rank launches the kernel on its
    rows; the result is placed as those rows are."""
    if isinstance(x, DTensor):
        return _rmsnorm_on_shards(x, weight, eps, groups)
    _refuse_autograd("rmsnorm", x, weight)
    if x.dim() < 1 or x.numel() == 0:
        raise ValueError(f"rmsnorm: x must be non-empty [..., d], got "
                         f"{tuple(x.shape)}")
    d = x.shape[-1]
    if tuple(weight.shape) != (d,) or weight.device != x.device:
        raise ValueError(f"rmsnorm: weight must be [{d}] on {x.device}, got "
                         f"{tuple(weight.shape)} on {weight.device}")
    if groups < 1 or d % groups:
        raise ValueError(f"rmsnorm: {groups} groups do not divide d = {d}")
    _check_model_dtype("rmsnorm", x.dtype)
    _check_model_dtype("rmsnorm weight", weight.dtype)
    G = d // groups
    if x.device.type == "cpu":
        return kref.rmsnorm_ref(x.reshape(*x.shape[:-1], groups, G),
                                weight.reshape(groups, G), eps
                                ).reshape(x.shape)
    out = rmsnorm_cuda(x.contiguous().reshape(-1, G), weight.contiguous(),
                       eps, groups)
    _launches["rmsnorm"] += 1
    return out.reshape(x.shape)


def _rmsnorm_on_shards(x: DTensor, weight: torch.Tensor, eps: float,
                       groups: int) -> DTensor:
    """:func:`rmsnorm` of each rank's whole rows (see there)."""
    _refuse_autograd("rmsnorm", x, weight)
    mesh, last = x.device_mesh, x.dim() - 1
    rows = [Replicate() if p.is_partial()
            or isinstance(p, Shard) and p.dim % x.dim() == last else p
            for p in x.placements]
    if isinstance(weight, DTensor):
        weight = weight.redistribute(
            weight.device_mesh, [Replicate()] * weight.device_mesh.ndim
        ).to_local()
    out = rmsnorm(x.redistribute(mesh, rows).to_local(), weight, eps, groups)
    return DTensor.from_local(out, mesh, rows, run_check=False)


def causal_conv_silu(x: torch.Tensor, w: torch.Tensor,
                     b: torch.Tensor) -> torch.Tensor:
    """x [B,S,C]; w [K,C]; b [C] -> ``silu(b + Σ_k w[k] · x[t − (K−1) +
    k])`` per channel, x zero before t = 0: Mamba2's depthwise causal
    convolution with its bias and SiLU, in x's dtype (float32 accumulation,
    one rounding).  ``x`` and ``w`` may each be float32 or bfloat16, ``b``
    in ``w``'s dtype; C a multiple of 8 and K in ``KERNEL_SIZES``.  Raises
    under autograd (see the module docstring)."""
    _refuse_autograd("causal_conv_silu", x, w, b)
    if x.dim() != 3 or x.numel() == 0:
        raise ValueError(f"causal_conv_silu: x must be a non-empty [B,S,C], "
                         f"got {tuple(x.shape)}")
    C = x.shape[2]
    if w.dim() != 2 or w.shape[1] != C or tuple(b.shape) != (C,):
        raise ValueError(f"causal_conv_silu: expected w [K,{C}] and b [{C}], "
                         f"got {tuple(w.shape)} and {tuple(b.shape)}")
    if w.shape[0] not in KERNEL_SIZES:
        raise ValueError(f"causal_conv_silu: width K = {w.shape[0]} not in "
                         f"{KERNEL_SIZES}")
    if C % CHANNELS:
        raise ValueError(f"causal_conv_silu: C = {C} is not a multiple of "
                         f"{CHANNELS}")
    _check_model_dtype("causal_conv_silu", x.dtype)
    _check_model_dtype("causal_conv_silu weight", w.dtype)
    for name, t in (("w", w), ("b", b)):
        if t.device != x.device:
            raise ValueError(f"causal_conv_silu: {name} is on {t.device}, x "
                             f"on {x.device}")
    if b.dtype != w.dtype:
        raise ValueError(f"causal_conv_silu: b is {b.dtype}, w {w.dtype}; "
                         f"they must agree")
    if x.device.type == "cpu":
        return kref.causal_conv_silu_ref(x, w, b)
    out = causal_conv_silu_cuda(x.contiguous(), w.contiguous(),
                                b.contiguous())
    _launches["causal_conv_silu"] += 1
    return out
