"""NumPy twin of :mod:`repro_torch.core.allocator` for the simulator's hot path.

The discrete-event simulator re-allocates on every arrival/completion/epoch/
migration event (tens of thousands of times per run); going through tensor
dispatch each time would dominate the runtime.  This module implements the
*identical* active-set closed form (Eq. 17–19) in NumPy.  Equality with the
torch version (and with the CUDA kernel's plain version) is asserted by
the parity tests.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

EPS = 1e-9


def active_set_np(w: np.ndarray, floors: np.ndarray, capacity: float,
                  mask: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, bool, np.ndarray]:
    """Generic floors-respecting proportional allocation by active-set clip.

    Shares the capacity proportionally to the non-negative weights ``w``
    subject to per-instance lower bounds ``floors``; the paper's allocator
    uses w = √(ωΨ) (Eq. 17), baselines reuse this with their own weights
    (equal-share, market bids) so that "all baselines use the same RAN floor
    reservations" (paper §IV-2).
    """
    S = w.shape[0]
    if mask is None:
        mask = np.ones(S, bool)
    mask = mask.astype(bool)
    w = np.where(mask, np.maximum(w, 0.0), 0.0)
    floors = np.where(mask, np.maximum(floors, 0.0), 0.0)

    floor_sum = float(np.sum(floors))
    feasible = floor_sum <= capacity + 1e-6
    if not feasible and floor_sum > 0:
        floors = floors * (capacity / floor_sum)

    pinned = w <= 0.0
    for _ in range(S):
        rem = capacity - float(np.sum(floors[pinned]))
        denom = float(np.sum(w[~pinned]))
        prop = w * max(rem, 0.0) / max(denom, EPS)
        new_pinned = pinned | (prop < floors)
        if np.array_equal(new_pinned, pinned):
            break
        pinned = new_pinned

    rem = capacity - float(np.sum(floors[pinned]))
    denom = float(np.sum(w[~pinned]))
    share = w * max(rem, 0.0) / max(denom, EPS)
    alloc = np.where(pinned, floors, share)
    alloc = np.where(mask, alloc, 0.0)
    return alloc, feasible, pinned & mask


def solve_resource_np(psi: np.ndarray, omega: np.ndarray, floors: np.ndarray,
                      capacity: float, mask: Optional[np.ndarray] = None
                      ) -> Tuple[np.ndarray, bool, np.ndarray]:
    """Active-set closed-form allocation for one resource on one node.

    Mirrors ``allocator.solve_resource``; see there for semantics.
    Returns (alloc [S], feasible, floored [S] bool).
    """
    S = psi.shape[0]
    if mask is None:
        mask = np.ones(S, bool)
    mask = mask.astype(bool)
    psi = np.where(mask, np.maximum(psi, 0.0), 0.0)
    omega = np.where(mask, np.maximum(omega, 0.0), 0.0)
    w = np.sqrt(omega * psi)                    # Eq. 17
    return active_set_np(w, floors, capacity, mask)


def allocate_cluster_np(psi_g, psi_c, omega, floors_g, floors_c,
                        gpu_capacity, cpu_capacity, mask):
    """[N, S] batched version. Returns (g_alloc, c_alloc, feasible[N])."""
    N = psi_g.shape[0]
    g_out = np.zeros_like(psi_g)
    c_out = np.zeros_like(psi_c)
    feas = np.ones(N, bool)
    for n in range(N):
        g, fg, _ = solve_resource_np(psi_g[n], omega[n], floors_g[n],
                                     float(gpu_capacity[n]), mask[n])
        c, fc, _ = solve_resource_np(psi_c[n], omega[n], floors_c[n],
                                     float(cpu_capacity[n]), mask[n])
        g_out[n], c_out[n] = g, c
        feas[n] = fg and fc
    return g_out, c_out, feas
