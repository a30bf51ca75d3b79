"""Deadline-aware closed-form GPU/CPU allocation (paper §III-C, Eq. 13–19).

The allocation layer solves, per node n and per resource r ∈ {GPU, CPU},

    min_{x_s}  Σ_s ω_s · Ψ_s / x_s      s.t.  Σ_s x_s ≤ R_n,  x_s ≥ floor_s,

whose KKT stationarity gives the square-root workload–urgency proportional
rule  x_s ∝ √(ω_s Ψ_s)  (Eq. 17), with lower-bound (capacity-floor)
constraints handled by **active-set clipping** (Eq. 18–19): instances whose
proportional share falls below their floor are fixed at the floor and the
residual capacity is re-shared among the rest.  Because fixing a set at
floors only *increases* everyone else's share, the floored set grows
monotonically and the iteration converges in ≤ S steps.

Plain functions on tensors: the dtype and the device follow the inputs.
The fleet-wide solve :func:`allocate_cluster` goes through the hand-written
``alloc_active_set`` CUDA kernel when its tensors lie on a CUDA device and
through the plain version (:func:`repro_torch.kernels.ref.alloc_active_set_ref`)
when they lie on the CPU.

Shapes: S = number of instances (fixed); masks select residents.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

EPS = 1e-9


class AllocResult(NamedTuple):
    alloc: torch.Tensor      # [..., S] allocated capacity per instance
    feasible: torch.Tensor   # [...] bool — Σ floors ≤ capacity
    floored: torch.Tensor    # [..., S] bool — instance pinned at its floor


def solve_resource(psi: torch.Tensor, omega: torch.Tensor,
                   floors: torch.Tensor, capacity,
                   mask: Optional[torch.Tensor] = None) -> AllocResult:
    """Closed-form active-set solve for ONE resource on ONE node.

    Args:
      psi:      [S] residual workload Ψ_s ≥ 0 (FLOPs or core-seconds).
      omega:    [S] urgency weights ω_s ≥ 0 (Eq. 14).
      floors:   [S] minimum capacities (Eq. 15); 0 for non-RAN instances.
      capacity: scalar node capacity (G_n or C_n), a float or 0-dim tensor.
      mask:     [S] bool residency; non-resident ⇒ allocation 0.

    Returns AllocResult with Σ alloc ≤ capacity (up to float error).
    """
    if mask is None:
        mask = torch.ones(psi.shape[-1], dtype=torch.bool, device=psi.device)
    cap = torch.as_tensor(capacity, dtype=psi.dtype,
                          device=psi.device).reshape(1)
    alloc, feasible, floored = kref.alloc_active_set_ref(
        psi[None], omega[None], floors[None], cap, mask[None])
    return AllocResult(alloc[0], feasible[0], floored[0])


def allocate_node(psi_g: torch.Tensor, psi_c: torch.Tensor,
                  omega: torch.Tensor, floors_g: torch.Tensor,
                  floors_c: torch.Tensor, gpu_capacity, cpu_capacity,
                  mask: Optional[torch.Tensor] = None
                  ) -> Tuple[AllocResult, AllocResult]:
    """Both sub-problems of Eq. 16 for one node (they decouple additively)."""
    g = solve_resource(psi_g, omega, floors_g, gpu_capacity, mask)
    c = solve_resource(psi_c, omega, floors_c, cpu_capacity, mask)
    return g, c


def allocate_cluster(psi_g: torch.Tensor, psi_c: torch.Tensor,
                     omega: torch.Tensor, floors_g: torch.Tensor,
                     floors_c: torch.Tensor, gpu_capacity: torch.Tensor,
                     cpu_capacity: torch.Tensor, mask: torch.Tensor,
                     use_kernel: Optional[bool] = None
                     ) -> Tuple[AllocResult, AllocResult]:
    """Fleet-wide allocation: everything is [N, S]; capacities are [N].

    ``use_kernel=None`` (default) takes the ``alloc_active_set`` CUDA kernel
    (f32, one warp per node row, two launches: GPU and CPU problem)
    when the tensors lie on a CUDA device, and the plain version in the
    inputs' dtype when they lie on the CPU.  ``use_kernel=True`` demands the
    kernel and raises on CPU tensors; ``use_kernel=False`` asks for the
    plain version wherever the tensors are.
    """
    if use_kernel is None:
        use_kernel = psi_g.is_cuda
    if use_kernel:
        if not psi_g.is_cuda:
            raise RuntimeError(
                "allocate_cluster(use_kernel=True) needs CUDA tensors: the "
                f"alloc_active_set kernel does not run on {psi_g.device}")
        solve = kops.alloc_active_set
    else:
        solve = kref.alloc_active_set_ref
    g = AllocResult(*solve(psi_g, omega, floors_g, gpu_capacity, mask))
    c = AllocResult(*solve(psi_c, omega, floors_c, cpu_capacity, mask))
    return g, c


# --------------------------------------------------------------------------- #
# floors + urgency from request-level state (Eq. 14–15)
# --------------------------------------------------------------------------- #
def urgency(deadline_remaining: torch.Tensor, active: torch.Tensor,
            eps: float = 1e-3) -> torch.Tensor:
    """ω contribution per request (Eq. 14): 1/max(τ − (t−a), ε)."""
    u = 1.0 / deadline_remaining.clamp_min(eps)
    return torch.where(active, u, torch.zeros_like(u))


def ran_floor(psi: torch.Tensor, min_remaining: torch.Tensor,
              capacity: torch.Tensor, has_pending: torch.Tensor,
              eps: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity floor (Eq. 15) for one RAN instance's dominant resource.

    Args:
      psi:           residual RAN-only workload Ψ at (n, s).
      min_remaining: min over pending RAN-only q of (τ_q − (t−a_q) − δ − α̂_down).
      capacity:      node capacity (used to cap runaway floors).
      has_pending:   Q^r_{n,s}(t) non-empty (floor is 0 otherwise).

    Returns (floor, deadline_infeasible).
    """
    infeasible = has_pending & (min_remaining <= 0.0)
    floor = psi / min_remaining.clamp_min(eps)
    floor = torch.where(has_pending, torch.minimum(floor, capacity),
                        torch.zeros_like(floor))
    return floor, infeasible


# --------------------------------------------------------------------------- #
# numeric oracle (projected gradient on the true convex objective) — used by
# tests to certify the closed form is the actual argmin of Eq. 16.
# --------------------------------------------------------------------------- #
def objective(alloc: torch.Tensor, psi: torch.Tensor, omega: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """Σ ω Ψ / x over resident instances with work (Eq. 16a, one resource)."""
    want = mask & (psi > 0) & (omega > 0)
    cost = omega * psi / alloc.clamp_min(EPS)
    return torch.where(want, cost, torch.zeros_like(cost)).sum()


def solve_numeric(psi: torch.Tensor, omega: torch.Tensor,
                  floors: torch.Tensor, capacity: float,
                  mask: Optional[torch.Tensor] = None, steps: int = 4000,
                  lr: float = 0.05) -> torch.Tensor:
    """Slow numeric solve of Eq. 16 (one resource) by projected gradient:
    a normalised gradient step on the objective, then projection onto
    {x ≥ floor, Σx ≤ C}.  Reference-quality only; used in tests.
    """
    if mask is None:
        mask = torch.ones(psi.shape[-1], dtype=torch.bool, device=psi.device)
    zero = torch.zeros_like(psi)
    psi = torch.where(mask, psi, zero)
    omega = torch.where(mask, omega, zero)
    floors = torch.where(mask, floors, zero)
    want = mask & (psi * omega > 0)
    room = max(float(capacity) - float(floors.sum()), 0.0)

    def project(x):
        x = torch.maximum(x, floors)
        if float(x.sum()) <= capacity:
            return x
        # waterfill down any excess above the floors proportionally
        slack = x - floors
        return floors + slack * room / slack.sum().clamp_min(EPS)

    x = project(torch.where(want, capacity / max(int(want.sum()), 1) + zero,
                            floors))
    for _ in range(steps):
        x = x.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(objective(x, psi, omega, mask), x)
        x = project(x.detach() - lr * capacity * g / (g.abs().max() + EPS))
    return x.detach()
