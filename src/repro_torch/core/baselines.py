"""The five baselines of Table III (paper §IV-2).

  * HAF-Static   — StaticPlacement + the paper's allocation layer.
  * Round-Robin  — StaticPlacement + equal-share residual allocation and
                   round-robin AI dispatch.
  * Lyapunov     — single-layer drift-plus-penalty placement + MaxWeight
                   residual allocation.
  * Game Theory  — best-response placement + proportional market clearing.
  * CAORA [12]   — DRL α-split reproduced: one scalar α per node divides
                   compute between the RAN and AI classes (full capacity
                   where one class resides alone); placement static.

All baselines keep the paper's RAN floor reservations (Eq. 15) so the hard
constraint (5b) is enforced consistently across methods.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.allocator_np import active_set_np
from repro_torch.core.placement import candidate_actions
from repro_torch.sim.cluster import (ClusterState, _active_set_rows,
                               _pow2_at_least)
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import InstanceCategory, MigrationAction


# --------------------------------------------------------------------------- #
# allocation policies
# --------------------------------------------------------------------------- #
class _FloorsAllocationBase:
    """Shared scaffolding: compact per-node Eq. 13–15 inputs + weights.

    Like the deadline-aware hot path, the baselines solve over the busy
    instances of each dirty node only (``node_alloc_inputs``) instead of
    materializing full ``[N, S]`` allocator inputs per event — idle and
    unavailable instances get zero by construction, which is exactly what
    the masked full-width solve produced.  The weight hooks receive the
    compact per-busy-instance vectors aligned with ``sids``.
    """

    def _weights_g(self, cluster, n, sids, psi_g, psi_c,
                   omega):  # pragma: no cover
        raise NotImplementedError

    def _weights_c(self, cluster, n, sids, psi_g, psi_c,
                   omega):  # pragma: no cover
        raise NotImplementedError

    def allocate(self, cluster: ClusterState, t: float, nodes=None) -> None:
        if nodes is None:
            cluster.alloc_g.fill(0.0)
            cluster.alloc_c.fill(0.0)
        else:
            zero = [s for n in nodes for s in cluster._node_sids[n]]
            if zero:
                zi = np.asarray(zero, np.int64)
                cluster.alloc_g[zi] = 0.0
                cluster.alloc_c[zi] = 0.0
        for n in (range(cluster.N) if nodes is None else nodes):
            sids, psi_g, psi_c, omega, fg, fc = \
                cluster.node_alloc_inputs(n, t)
            if not sids:
                continue
            wg = self._weights_g(cluster, n, sids, psi_g, psi_c, omega)
            wc = self._weights_c(cluster, n, sids, psi_g, psi_c, omega)
            k = len(sids)
            K = _pow2_at_least(k)
            w = np.zeros((2, K))
            fl = np.zeros((2, K))
            w[0, :k] = wg
            w[1, :k] = wc
            fl[0, :k] = fg
            fl[1, :k] = fc
            alloc = _active_set_rows(
                w, fl, np.array([float(cluster.gpu_eff[n]),
                                 float(cluster.cpu_eff[n])]))
            idx = np.asarray(sids, np.int64)
            cluster.alloc_g[idx] = alloc[0, :k]
            cluster.alloc_c[idx] = alloc[1, :k]


class EqualShareAllocation(_FloorsAllocationBase):
    """Residual capacity split equally among instances with queued work."""
    name = "equal-share"

    def _weights_g(self, cluster, n, sids, psi_g, psi_c, omega):
        return (psi_g > 0).astype(float)

    def _weights_c(self, cluster, n, sids, psi_g, psi_c, omega):
        return (psi_c > 0).astype(float)


class MaxWeightAllocation(_FloorsAllocationBase):
    """Lyapunov-style MaxWeight: residual to the largest ω·Ψ backlog."""
    name = "maxweight"

    @staticmethod
    def _winner(sids, vals):
        """One-hot at the max bid; ties break to the smallest sid, the
        tie-break the full-width argmax had."""
        out = np.zeros(len(vals))
        best_i, best_v = -1, 0.0
        for i in sorted(range(len(sids)), key=sids.__getitem__):
            if vals[i] > best_v:
                best_i, best_v = i, float(vals[i])
        if best_i >= 0:
            out[best_i] = 1.0
        return out

    def _weights_g(self, cluster, n, sids, psi_g, psi_c, omega):
        return self._winner(sids, omega * psi_g)

    def _weights_c(self, cluster, n, sids, psi_g, psi_c, omega):
        return self._winner(sids, omega * psi_c)


class MarketAllocation(_FloorsAllocationBase):
    """Proportional market clearing: share ∝ bid = ω·Ψ (not the √ rule)."""
    name = "market"

    def _weights_g(self, cluster, n, sids, psi_g, psi_c, omega):
        return omega * psi_g

    def _weights_c(self, cluster, n, sids, psi_g, psi_c, omega):
        return omega * psi_c


class AlphaSplitAllocation:
    """CAORA [12]: per-node scalar α ∈ [0,1] splits residual compute between
    the RAN class (α) and the AI class (1−α); equal share within a class;
    either class takes everything where it resides alone."""
    name = "caora-alpha"

    def __init__(self, alpha):
        self.alpha = alpha                      # float or [N] array

    def _alpha(self, n: int) -> float:
        a = self.alpha
        return float(a[n]) if np.ndim(a) else float(a)

    def allocate(self, cluster: ClusterState, t: float, nodes=None) -> None:
        psi_g, psi_c, omega, fg, fc, mask = cluster.allocator_inputs(t, nodes)
        N, S = psi_g.shape
        is_ran = np.array([inst.category.is_ran
                           for inst in cluster.instances])
        g_ns = np.zeros((N, S))
        c_ns = np.zeros((N, S))
        rows = range(N) if nodes is None else nodes
        for n in rows:
            a = self._alpha(n)
            for (res_psi, floors, cap, out) in (
                    (psi_g[n], fg[n], float(cluster.gpu_eff[n]), g_ns),
                    (psi_c[n], fc[n], float(cluster.cpu_eff[n]), c_ns)):
                ran_w = ((res_psi > 0) & is_ran & mask[n]).astype(float)
                ai_w = ((res_psi > 0) & ~is_ran & mask[n]).astype(float)
                has_ran, has_ai = ran_w.any(), ai_w.any()
                if has_ran and has_ai:
                    w = a * ran_w / max(ran_w.sum(), 1.0) \
                        + (1 - a) * ai_w / max(ai_w.sum(), 1.0)
                else:                       # a class alone takes everything
                    w = ran_w + ai_w
                out[n], _, _ = active_set_np(w, floors, cap, mask[n])
        cluster.apply_allocation(g_ns, c_ns, nodes)


# --------------------------------------------------------------------------- #
# placement policies
# --------------------------------------------------------------------------- #
# Per the paper (§IV-2), the single-layer baselines' migrations "are
# confined to DU, CU-UP, and small-AI services, and the large-AI placement
# remains unchanged": their source formulations treat heavyweight stateful
# services with second-scale reloads as non-migratable.
BASELINE_MOVABLE = (InstanceCategory.DU, InstanceCategory.CUUP,
                    InstanceCategory.SMALL_AI)


class LyapunovPlacement:
    """Drift-plus-penalty: migrate when the queue-drift reduction beats the
    V-scaled reconfiguration penalty (MaxWeight allocation underneath)."""

    def __init__(self, V: float = 0.25):
        self.V = V
        self.name = "lyapunov"
        self.last_shortlist: List[MigrationAction] = []

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        self.last_shortlist = []
        best, best_score = None, 0.0
        for a in candidate_actions(snap, movable=BASELINE_MOVABLE):
            if a is None:
                continue
            inst = snap.instances[a.sid]
            demand = float(snap.psi_g[a.sid])
            src_press = _pressure(snap, a.src)
            dst_press = _pressure(snap, a.dst, exclude=a.sid) + \
                demand / max(snap.nodes[a.dst].gpu_flops, 1.0)
            drift_gain = (src_press - dst_press) \
                * (demand / max(snap.nodes[a.src].gpu_flops, 1.0) + 1e-6)
            rate = snap.arrival_rate.get(inst.arch, 0.0)
            penalty = self.V * inst.reconfig_s * (0.05 + 0.05 * rate)
            score = drift_gain - penalty
            if score > best_score:
                best, best_score = a, score
        return best


class GameTheoryPlacement:
    """Best-response: each epoch the most-misplaced instance unilaterally
    moves to the node maximizing its expected proportional share, if the
    improvement covers a small migration toll."""

    def __init__(self, toll: float = 0.1):
        self.toll = toll
        self.name = "game-theory"
        self.last_shortlist: List[MigrationAction] = []

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        self.last_shortlist = []
        best, best_gain = None, 0.0
        for a in candidate_actions(snap, movable=BASELINE_MOVABLE):
            if a is None:
                continue
            inst = snap.instances[a.sid]
            w_s = float(snap.omega[a.sid] * snap.psi_g[a.sid]) + 1e-9
            share_src = _prop_share(snap, a.sid, a.src, w_s)
            share_dst = _prop_share(snap, a.sid, a.dst, w_s, moving_in=True)
            gain = (share_dst - share_src) / max(
                snap.nodes[a.src].gpu_flops, 1.0)
            gain -= self.toll * inst.reconfig_s
            if gain > best_gain:
                best, best_gain = a, gain
        return best


def _pressure(snap: EpochSnapshot, n: int, exclude: int = -1) -> float:
    psi = sum(float(snap.psi_g[s]) for s in range(snap.S)
              if snap.placement[s] == n and s != exclude)
    return psi / max(snap.nodes[n].gpu_flops, 1.0)


def _prop_share(snap: EpochSnapshot, sid: int, n: int, w_s: float,
                moving_in: bool = False) -> float:
    w_others = sum(float(snap.omega[s] * snap.psi_g[s])
                   for s in range(snap.S)
                   if snap.placement[s] == n and s != sid)
    return snap.nodes[n].gpu_flops * w_s / (w_others + w_s + 1e-9)


# --------------------------------------------------------------------------- #
# CAORA offline α fitting (stand-in for the SAC training loop — the trace-
# driven grid search selects the reward-maximizing constant policy, which is
# what the converged single-scalar SAC policy reduces to in this setting).
# --------------------------------------------------------------------------- #
def fit_caora_alpha(simulator, requests, grid: Sequence[float] = (
        0.1, 0.2, 0.3, 0.5, 0.7, 0.9)) -> float:
    from repro_torch.sim.engine import StaticPlacement
    best_a, best_f = 0.5, -1.0
    for a in grid:
        res = simulator.run(_clone_requests(requests), StaticPlacement(),
                            AlphaSplitAllocation(a))
        f = res.fulfillment().get("overall", 0.0)
        if f > best_f:
            best_a, best_f = a, f
    return best_a


def _clone_requests(requests):
    return [dataclasses.replace(r) for r in requests]
