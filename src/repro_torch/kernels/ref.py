"""Plain torch versions of the hand-written kernels (and of the solo pair).

These are the expressions of the reference's ``kernels/event_core.py``
(``next_completion``, ``advance``, ``event_step``) and of
``core/allocator.solve_resource`` vectorised over rows, written as eager
tensor code.  They run on whatever device their inputs lie on; the CPU tests
and the eager ``"torch"`` engine use them, and the CUDA kernels are held
against them on the card.

The event functions are float64 by contract: the event schedule is a chain
of IEEE-754 double divisions, and float32 desyncs the engines within a
handful of events.  Every product is rounded before it is subtracted
(eager torch does not contract multiply-adds), so on float64 inputs
:func:`event_step_ref` reproduces the numpy batched core bit for bit.
"""
from __future__ import annotations

from typing import Tuple

import torch

EPS = 1e-9


def _stage_time(rem: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """``rem / rate`` where a stage is pending, else 0.  A pending stage
    with zero rate divides to +inf (never NaN: 0/0 lanes are replaced by 0
    before anything reads them) and can never win the completion min."""
    return torch.where(rem > 0.0, rem / rate, torch.zeros_like(rem))


def first_index_of(cand: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """First index along the last axis where ``cand == value`` —
    ``np.argmin``'s tie-break, which ``torch.argmin`` does not promise."""
    S = cand.shape[-1]
    lane = torch.arange(S, device=cand.device)
    hit = torch.where(cand == value.unsqueeze(-1), lane, S)
    return torch.min(hit, dim=-1).values


def next_completion_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                        alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                        avail: torch.Tensor, t: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Earliest head completion under GPU-then-CPU stage ordering over
    ``[S]`` vectors.  Returns ``(t_next, sid)``; ``t_next`` is +inf when
    nothing can complete (``sid`` is then 0, the first index)."""
    cand = t + (_stage_time(rem_g, alloc_g) + _stage_time(rem_c, alloc_c))
    cand = torch.where(avail, cand, torch.full_like(cand, torch.inf))
    t_next, _ = torch.min(cand, dim=0)
    sid = first_index_of(cand, t_next)
    return t_next, sid


def advance_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                act: torch.Tensor, dt
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Progress served heads by ``dt`` without crossing the GPU->CPU stage
    boundary; a stalled GPU stage freezes its head.  ``dt`` is a float or a
    tensor that broadcasts against the residuals.  Returns
    ``(rem_g', rem_c', started)``."""
    zero = torch.zeros_like(rem_g)
    dt = torch.as_tensor(dt, dtype=rem_g.dtype, device=rem_g.device)
    gpu_need = rem_g > 0.0
    run_g = act & gpu_need & (alloc_g > 0.0) & (dt > 0.0)
    stalled = act & gpu_need & (alloc_g <= 0.0)
    tg = torch.where(run_g, torch.minimum(dt, rem_g / alloc_g), zero)
    rg_new = rem_g - torch.where(run_g, alloc_g * tg, zero)
    rem_dt = torch.where(run_g, dt - tg, dt + zero)
    cpu_ok = (act & ~stalled & (rg_new <= 0.0) & (rem_dt > 0.0)
              & (rem_c > 0.0) & (alloc_c > 0.0))
    tc = torch.where(cpu_ok, torch.minimum(rem_dt, rem_c / alloc_c), zero)
    rc_new = rem_c - torch.where(cpu_ok, alloc_c * tc, zero)
    return rg_new, rc_new, run_g | cpu_ok


def event_step_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                   alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                   avail: torch.Tensor, t: torch.Tensor, t_ev: torch.Tensor,
                   live: torch.Tensor):
    """Fused batched step over ``[B, S]`` blocks: per-row completion scan +
    advance-to-next-event with per-replica clocks ``t[b]`` and heap heads
    ``t_ev[b]``; rows with ``live[b]`` down advance by ``dt = 0``.

    Returns ``(rem_g', rem_c', started [B,S] bool, t_comp [B], sid [B]
    int32)`` — the contract of the ``event_step`` kernel.
    """
    t_col = t[:, None]
    cand = t_col + (_stage_time(rem_g, alloc_g) + _stage_time(rem_c, alloc_c))
    cand = torch.where(avail, cand, torch.full_like(cand, torch.inf))
    t_comp = torch.min(cand, dim=1).values
    sid = first_index_of(cand, t_comp).to(torch.int32)

    t_next = torch.minimum(t_comp, t_ev)
    dt = torch.where(live & torch.isfinite(t_next), t_next - t,
                     torch.zeros_like(t))
    rg_new, rc_new, started = advance_ref(rem_g, rem_c, alloc_g, alloc_c,
                                          avail, dt[:, None])
    return rg_new, rc_new, started, t_comp, sid


def _active_set(psi, omega, floors, capacity, mask):
    """The Eq. 17-19 fixed point; returns ``(alloc, feasible, pinned,
    rounds [N])`` where ``rounds[n]`` counts the rounds row ``n`` needed:
    those that pinned something new in it, plus the one that found it
    settled."""
    S = psi.shape[-1]
    zero = torch.zeros_like(psi)
    mask = mask.to(torch.bool)
    cap = capacity.to(psi.dtype)[:, None]
    psi = torch.where(mask, psi.clamp_min(0.0), zero)
    omega = torch.where(mask, omega.to(psi.dtype).clamp_min(0.0), zero)
    floors = torch.where(mask, floors.to(psi.dtype).clamp_min(0.0), zero)

    w = torch.sqrt(omega * psi)                                   # Eq. 17
    floor_sum = floors.sum(dim=1, keepdim=True)
    feasible = floor_sum <= cap + 1e-6
    # infeasible floors degrade gracefully: scaled down to fit the node
    scale = torch.where(feasible, torch.ones_like(cap),
                        cap / floor_sum.clamp_min(EPS))
    floors_eff = floors * scale

    def shares(pinned):
        rem = cap - torch.where(pinned, floors_eff, zero).sum(1, keepdim=True)
        denom = torch.where(pinned, zero, w).sum(1, keepdim=True)
        return w * rem.clamp_min(0.0) / denom.clamp_min(EPS)      # Eq. 18-19

    pinned = w <= 0.0        # zero weight can never exceed its floor
    rounds = torch.ones(psi.shape[0], dtype=torch.int64, device=psi.device)
    for _ in range(S):
        grown = pinned | (shares(pinned) < floors_eff)
        grew = (grown != pinned).any(dim=1)
        if not bool(grew.any()):
            break
        rounds += grew
        pinned = grown
    alloc = torch.where(pinned, floors_eff, shares(pinned))
    alloc = torch.where(mask, alloc, zero)
    return alloc, feasible[:, 0], pinned & mask, rounds


def alloc_active_set_ref(psi: torch.Tensor, omega: torch.Tensor,
                         floors: torch.Tensor, capacity: torch.Tensor,
                         mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[N, S]`` closed-form active-set allocation (Eq. 17-19), one
    (node, resource) problem per row; ``capacity`` is ``[N]``.  The dtype
    follows ``psi``.  Returns ``(alloc [N,S], feasible [N] bool, pinned
    [N,S] bool)``.

    The pinned set only grows, so iterating until a round pins nothing new
    gives what the reference's fixed S rounds give.
    """
    return _active_set(psi, omega, floors, capacity, mask)[:3]


def alloc_active_set_rounds(psi: torch.Tensor, omega: torch.Tensor,
                            floors: torch.Tensor, capacity: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Fixed-point rounds each row of this data needs (``[N]`` int64) —
    the data-dependent part of the solve's operation count."""
    return _active_set(psi, omega, floors, capacity, mask)[3]
