"""Cluster state: residency y_{n,s}, queues, VRAM accounting, allocator I/O.

Performance notes (the simulator re-allocates on every event):
  * head-of-queue state (residuals, deadline, KV, started) and the queue
    aggregates (Ψ sums, Eq. 13) live in contiguous ``[S]`` numpy arrays on
    :class:`ClusterState`, updated incrementally by :meth:`push_job` /
    :meth:`pop_job` and advanced wholesale by the event cores — so
    ``next_completion`` is one masked argmin and ``advance`` one fused
    array update (see :mod:`repro_torch.sim.event_core`),
  * queue deadlines live in an inf-padded ``[S, L]`` matrix (``dl_pad``)
    so urgency ω(t) and the RAN floors gather as fused array passes over
    the busy instances of a node — or, batched, over every dirty node of
    every replica at once (:func:`deadline_allocate_block`),
  * expired not-yet-started requests are dropped lazily (bounds queue length
    and models admission control; counted as unfulfilled).

Batched multi-seed runs stack B same-scenario replicas into ``[B, S]``
blocks (:class:`ClusterBlock`): each replica's arrays become row views of
the block, so the per-replica queue mutators keep writing scalar slots
while the batched event core and the batched allocator advance the whole
block in fused steps.  Bit-for-bit identity between the solo and batched
paths rests on two invariants:

  * every gathered element evaluates the *same scalar IEEE-754
    expressions* whether it sits in a per-node ``[k]`` vector or a
    cross-replica ``[P]`` vector (elementwise ufuncs are positionwise),
  * all reductions over padded axes use the pairwise halving
    :func:`_tree_sum`, whose result is invariant to the amount of
    zero-contribution padding — so replicas sharing a wider padded L (or
    problems sharing a wider padded K) cannot drift by ulps.

The ``Job`` objects in each FIFO remain the request-level record, but while
a job is at the head of its queue the *arrays* are authoritative for its
residual work / started flag; :meth:`pop_job` syncs the final values back
onto the object before handing it to the engine.
"""
from __future__ import annotations

import dataclasses
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from repro_torch.obs.trace import ALLOC as _TRACE_ALLOC
from repro_torch.sim.types import (InstanceCategory, InstanceSpec, MigrationAction,
                             NodeSpec, Request, RequestClass)

EPS_URGENCY = 1e-3   # ε in Eq. 14 (seconds)
EPS_FLOOR = 1e-4     # denominator clamp in Eq. 15
EPS_ALLOC = 1e-9     # denominator clamp in Eq. 18 (matches allocator_np.EPS)
FLOOR_MARGIN = 0.9   # finish RAN work 10% before the earliest deadline:
                     # serving exactly at the floor rate would complete at
                     # the deadline edge, losing ties to transport jitter

_DL_PAD0 = 4         # initial padded deadline columns (kept a power of two)

_CAT_DU = 0          # category codes for vectorized floor dispatch
_CAT_CUUP = 1
_CAT_AI = 2

# active-set iterations accumulated over the solves of the CURRENT
# allocate call (reset by the deadline_allocate_* entry points, read by
# their trace emission) — a plain module counter; the simulator is
# single-threaded per run
_SOLVE_ITERS = 0


def _tree_sum(x: np.ndarray) -> np.ndarray:
    """Sum over the (power-of-two) last axis by pairwise halving.

    Unlike ``np.sum`` (whose pairwise blocking depends on the axis
    length), the halving tree gives a result *invariant to trailing
    zero-contribution padding*: folding an all-zero upper half returns
    the lower half unchanged, so a row padded from L to 2L sums to the
    identical double.  This is what lets solo runs (per-replica padded
    width) and batched runs (shared widest width) stay bit-identical.
    """
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x[..., 0]


def _pow2_at_least(n: int) -> int:
    k = 1
    while k < n:
        k <<= 1
    return k


def _active_set_rows(w: np.ndarray, floors: np.ndarray,
                     caps: np.ndarray) -> np.ndarray:
    """Eq. 17–19 active-set fixed point over ``[P, K]`` problem rows.

    Each row is one (node, resource) problem, zero-padded to the shared
    power-of-two K (padding has ``w = 0`` so it starts pinned at floor 0
    and never contributes).  The pinned set grows monotonically and extra
    iterations are idempotent, so early-breaking when no row grew cannot
    desync a row across calls that batch it with different companions —
    the per-row result depends only on the row's real entries.
    """
    global _SOLVE_ITERS
    P, K = w.shape
    if not floors.any():
        # no floors anywhere (no busy RAN heads): the fixed point is the
        # plain proportional share in one step.  Exact shortcut: with all
        # floors 0 the pinned set is w <= 0 immediately and never grows
        # (prop >= 0 is never < 0), rem = caps - 0.0 = caps, and pinned
        # entries share w * rem / denom = 0 = their floor.
        denom = np.maximum(_tree_sum(w), EPS_ALLOC)
        rem = np.maximum(caps - 0.0, 0.0)
        return w * rem[:, None] / denom[:, None]
    floor_sum = _tree_sum(floors)
    infeas = (floor_sum > caps + 1e-6) & (floor_sum > 0.0)
    scale = np.ones(P)
    np.divide(caps, floor_sum, out=scale, where=infeas)
    floors_eff = floors * scale[:, None]

    pinned = w <= 0.0
    for it in range(K):
        rem = caps - _tree_sum(np.where(pinned, floors_eff, 0.0))
        np.maximum(rem, 0.0, out=rem)
        denom = _tree_sum(np.where(pinned, 0.0, w))
        np.maximum(denom, EPS_ALLOC, out=denom)
        prop = w * rem[:, None] / denom[:, None]
        grow = (prop < floors_eff) & ~pinned
        if not grow.any():
            _SOLVE_ITERS += it + 1
            break
        pinned |= grow
    else:
        _SOLVE_ITERS += K
    rem = caps - _tree_sum(np.where(pinned, floors_eff, 0.0))
    np.maximum(rem, 0.0, out=rem)
    denom = _tree_sum(np.where(pinned, 0.0, w))
    np.maximum(denom, EPS_ALLOC, out=denom)
    share = w * rem[:, None] / denom[:, None]
    return np.where(pinned, floors_eff, share)


@dataclasses.dataclass
class Job:
    """A request's residency at one instance (one service stage)."""
    req: Request
    rem_g: float                # residual GPU work  Φ^{g,rem}
    rem_c: float                # residual CPU work  Φ^{c,rem}
    abs_deadline: float         # a_q + τ_q
    kv_bytes: float = 0.0
    started: bool = False


class InstQueue:
    """FIFO of jobs at one (node, instance).

    Aggregates (Ψ), head state, and the padded deadline matrix live on
    :class:`ClusterState` arrays; the queue only owns the job order.
    """

    __slots__ = ("jobs",)

    def __init__(self) -> None:
        self.jobs: deque = deque()

    def head(self) -> Optional[Job]:
        return self.jobs[0] if self.jobs else None

    def __len__(self) -> int:
        return len(self.jobs)


class ClusterState:
    """Mutable cluster: placement + queues + allocations (Eq. 3–4 invariants)."""

    def __init__(self, nodes: Sequence[NodeSpec],
                 instances: Sequence[InstanceSpec],
                 initial_placement: Sequence[int],
                 transport_delay: float):
        self.nodes = list(nodes)
        self.instances = list(instances)
        self.N = len(nodes)
        self.S = len(instances)
        assert len(initial_placement) == self.S
        self.placement = np.asarray(initial_placement, np.int64).copy()
        self.reconfig_until = np.zeros(self.S)       # instance usable when t >=
        self.queues: List[InstQueue] = [InstQueue() for _ in range(self.S)]
        self.delta = transport_delay                 # δ (one-way per hop)

        self.gpu_capacity = np.array([n.gpu_flops for n in nodes])
        self.cpu_capacity = np.array([n.cpu_cores for n in nodes])
        self.vram_capacity = np.array([n.vram_bytes for n in nodes])

        # time-varying capacity (spot churn / autoscaler hook): node_scale
        # is the dynamic per-node mask, updated IN PLACE by
        # set_node_scale (no rebuild per change); *_eff are the
        # allocator-facing products.  At scale 1.0, gpu_eff == gpu_capacity
        # bitwise (x * 1.0 is exact), so churn-free runs cannot drift.
        self.node_scale = np.ones(self.N)
        self.gpu_eff = self.gpu_capacity * self.node_scale
        self.cpu_eff = self.cpu_capacity * self.node_scale
        # preemption-notice horizon: node n is draining while
        # t < node_drain_until[n] (migrations off it count as forced)
        self.node_drain_until = np.zeros(self.N)

        self.alloc_g = np.zeros(self.S)              # g_{n(s),s}
        self.alloc_c = np.zeros(self.S)              # c_{n(s),s}
        self.infeasible_events = 0                   # Eq. 15 denominator ≤ 0
        # observability: a repro_torch.obs TraceRecorder (or None) plus this
        # replica's batch tag, attached per run by the Simulator; the
        # allocator entry points emit one ALLOC record per solve when set
        self.trace = None
        self.trace_b = 0

        # --- contiguous per-instance event-core state --------------------- #
        # Ψ (Eq. 13) is derived: tail (jobs behind the head; only changes on
        # push/pop) + the head residual — so advance never updates aggregates
        self.tail_psi_g = np.zeros(self.S)
        self.tail_psi_c = np.zeros(self.S)
        self.head_rem_g = np.zeros(self.S)           # head-of-queue residuals
        self.head_rem_c = np.zeros(self.S)
        self.head_deadline = np.full(self.S, np.inf)
        self.head_kv = np.zeros(self.S)              # γ_q of the head
        self.head_mask = np.zeros(self.S, bool)      # queue non-empty
        self.head_started = np.zeros(self.S, bool)   # head has progressed

        # inf-padded per-queue deadline matrix (power-of-two columns) —
        # urgency ω(t) / earliest deadlines gather as fused array passes
        self.dl_cols = _DL_PAD0
        self.dl_pad = np.full((self.S, _DL_PAD0), np.inf)
        self._block: Optional["ClusterBlock"] = None

        self._du_by_cell: Dict[int, int] = {}
        self._cuup_by_cell: Dict[int, int] = {}
        for s in instances:
            if s.category == InstanceCategory.DU:
                self._du_by_cell[s.cell] = s.sid
            elif s.category == InstanceCategory.CUUP:
                self._cuup_by_cell[s.cell] = s.sid
        self._cat_sids: Dict[InstanceCategory, List[int]] = {}
        for s in instances:
            self._cat_sids.setdefault(s.category, []).append(s.sid)
        self._cat_code = np.array(
            [_CAT_DU if s.category == InstanceCategory.DU
             else _CAT_CUUP if s.category == InstanceCategory.CUUP
             else _CAT_AI for s in instances], np.int8)
        self._node_sids: List[List[int]] = [[] for _ in range(self.N)]
        for sid in range(self.S):
            self._node_sids[self.placement[sid]].append(sid)
        # instance weights by sid (vectorized VRAM accounting, Eq. 4)
        self._weights = np.array([s.weight_bytes for s in instances])

        # expected downstream CU-UP processing time α̂^down (EMA per cell),
        # mirrored into a per-DU-sid vector for the fused floor gather
        self._cuup_time_ema = {c: 5e-4 for c in self._cuup_by_cell}
        self._alpha_down = np.zeros(self.S)
        for cell, du_sid in self._du_by_cell.items():
            self._alpha_down[du_sid] = self._cuup_time_ema.get(cell, 5e-4)

    def set_node_scale(self, n: int, scale: float) -> None:
        """Retune one node's effective capacity IN PLACE (no rebuild).

        Writes go through the bound arrays, so in batched runs — where
        ``node_scale``/``gpu_eff``/``cpu_eff`` are row views into the
        ClusterBlock's ``[B, N]`` stacks — only this replica's row moves.
        """
        self.node_scale[n] = scale
        self.gpu_eff[n] = self.gpu_capacity[n] * scale
        self.cpu_eff[n] = self.cpu_capacity[n] * scale

    # ------------------------------------------------------------------ #
    # queue mutation (the ONLY writers of the head/Ψ/deadline arrays
    # besides the event cores' advance)
    # ------------------------------------------------------------------ #
    def _promote_head(self, sid: int) -> None:
        q = self.queues[sid]
        job = q.head()
        if job is None:
            self.head_rem_g[sid] = 0.0
            self.head_rem_c[sid] = 0.0
            self.head_deadline[sid] = np.inf
            self.head_kv[sid] = 0.0
            self.head_mask[sid] = False
            self.head_started[sid] = False
        else:
            self.head_rem_g[sid] = job.rem_g
            self.head_rem_c[sid] = job.rem_c
            self.head_deadline[sid] = job.abs_deadline
            self.head_kv[sid] = job.kv_bytes
            self.head_mask[sid] = True
            self.head_started[sid] = job.started

    def _grow_dl(self) -> None:
        if self._block is not None:
            self._block.grow_dl()
            return
        new = np.full((self.S, self.dl_cols * 2), np.inf)
        new[:, :self.dl_cols] = self.dl_pad
        self.dl_pad = new
        self.dl_cols *= 2

    def push_job(self, sid: int, job: Job) -> None:
        q = self.queues[sid]
        q.jobs.append(job)
        cnt = len(q.jobs)
        if cnt > self.dl_cols:
            self._grow_dl()
        self.dl_pad[sid, cnt - 1] = job.abs_deadline
        if cnt == 1:
            self._promote_head(sid)
        else:
            self.tail_psi_g[sid] += job.rem_g
            self.tail_psi_c[sid] += job.rem_c

    def pop_job(self, sid: int) -> Job:
        """Remove the head; syncs its live residuals back onto the Job."""
        q = self.queues[sid]
        job = q.jobs.popleft()
        cnt = len(q.jobs)
        row = self.dl_pad[sid]
        if cnt:
            row[:cnt] = row[1:cnt + 1]          # FIFO left shift
        row[cnt] = np.inf
        job.rem_g = float(self.head_rem_g[sid])
        job.rem_c = float(self.head_rem_c[sid])
        job.started = bool(self.head_started[sid])
        nxt = q.head()
        if nxt is not None:                   # the new head leaves the tail
            self.tail_psi_g[sid] -= nxt.rem_g
            self.tail_psi_c[sid] -= nxt.rem_c
        self._promote_head(sid)
        return job

    def psi_g_of(self, sid: int) -> float:
        """Ψ^g — aggregate residual GPU work at ``sid`` (Eq. 13)."""
        return float(self.tail_psi_g[sid] + self.head_rem_g[sid])

    def psi_c_of(self, sid: int) -> float:
        return float(self.tail_psi_c[sid] + self.head_rem_c[sid])

    def kv_active_vec(self) -> np.ndarray:
        """γ_q of each in-service request (A_{n,s}: the running batch holds
        KV on the accelerator; waiting requests queue in host memory)."""
        return np.where(self.head_started, self.head_kv, 0.0)

    # ------------------------------------------------------------------ #
    # lookups
    # ------------------------------------------------------------------ #
    def du_of(self, cell: int) -> int:
        return self._du_by_cell[cell]

    def cuup_of(self, cell: int) -> int:
        return self._cuup_by_cell[cell]

    def sids_of(self, cat: InstanceCategory) -> List[int]:
        return self._cat_sids.get(cat, [])

    def available(self, sid: int, t: float) -> bool:
        return t >= self.reconfig_until[sid]

    def hops(self, n_a: int, n_b: int) -> int:
        return 0 if n_a == n_b else 1               # full-mesh fabric

    # ------------------------------------------------------------------ #
    # memory (Eq. 4)
    # ------------------------------------------------------------------ #
    def vram_used(self) -> np.ndarray:
        used = np.zeros(self.N)
        np.add.at(used, self.placement, self._weights + self.kv_active_vec())
        return used

    def vram_headroom(self) -> np.ndarray:
        return self.vram_capacity - self.vram_used()

    def migration_feasible(self, a: MigrationAction) -> bool:
        """Destination VRAM must cover the incoming weights (Eq. 4)."""
        if a.src == a.dst or self.placement[a.sid] != a.src:
            return False
        inst = self.instances[a.sid]
        head = self.vram_headroom()[a.dst]
        kv = float(self.kv_active_vec()[a.sid])      # KV travels with service
        return head >= inst.weight_bytes + kv

    # ------------------------------------------------------------------ #
    # migration (the placement-layer commit, Eq. 12)
    # ------------------------------------------------------------------ #
    def apply_migration(self, a: MigrationAction, t: float) -> None:
        inst = self.instances[a.sid]
        assert self.placement[a.sid] == a.src, (a, self.placement[a.sid])
        self.placement[a.sid] = a.dst
        self.reconfig_until[a.sid] = t + inst.reconfig_s
        self._node_sids[a.src].remove(a.sid)
        self._node_sids[a.dst].append(a.sid)

    # ------------------------------------------------------------------ #
    # allocator I/O (Eq. 13–15 -> Eq. 16 -> apply Eq. 18)
    # ------------------------------------------------------------------ #
    def residency_mask(self, t: float) -> np.ndarray:
        """[N, S] — y_{n,s} ∧ not reconfiguring (unavailable gets nothing)."""
        mask = np.zeros((self.N, self.S), bool)
        avail = t >= self.reconfig_until
        mask[self.placement[avail], np.nonzero(avail)[0]] = True
        return mask

    def _servable_sids(self, n: int, t: float) -> List[int]:
        hm = self.head_mask
        ru = self.reconfig_until
        return [s for s in self._node_sids[n] if hm[s] and t >= ru[s]]

    def node_alloc_inputs(self, n: int, t: float):
        """Compact allocator inputs (Eq. 13–15) over one node's servable heads.

        Returns ``(sids, psi_g, psi_c, omega, floors_g, floors_c)`` with
        the arrays aligned to ``sids`` (residency order); increments
        ``infeasible_events`` for every floor whose deadline slack is
        already gone.  This is the single source of the floor/urgency
        semantics: the deadline-aware solve, the [N, S] allocator-input
        build, and the compact baselines all feed from here (the batched
        allocator evaluates the same elementwise expressions via
        :func:`_alloc_floor_math`), so the semantics cannot desync.
        """
        sids = self._servable_sids(n, t)
        if not sids:
            return sids, None, None, None, None, None
        idx = np.asarray(sids, np.int64)
        psi_g, psi_c, omega, fg, fc, infeas = _alloc_floor_math(
            self.dl_pad[idx], t,
            self.tail_psi_g[idx] + self.head_rem_g[idx],
            self.tail_psi_c[idx] + self.head_rem_c[idx],
            self._cat_code[idx], self._alpha_down[idx], self.delta,
            self.gpu_eff[n], self.cpu_eff[n])
        self.infeasible_events += int(np.count_nonzero(infeas))
        return sids, psi_g, psi_c, omega, fg, fc

    def allocator_inputs(self, t: float, nodes: Optional[List[int]] = None):
        """Build (psi_g, psi_c, omega, floors_g, floors_c, mask) as [N, S].

        ``nodes`` restricts the per-node aggregation to the given rows.
        This is the snapshot/baseline-facing view; the deadline-aware hot
        path solves compactly without materializing [N, S].
        """
        N, S = self.N, self.S
        psi_g = np.zeros((N, S))
        psi_c = np.zeros((N, S))
        omega = np.zeros((N, S))
        floors_g = np.zeros((N, S))
        floors_c = np.zeros((N, S))
        mask = self.residency_mask(t)
        for n in (range(N) if nodes is None else nodes):
            sids, pg, pc, om, fg, fc = self.node_alloc_inputs(n, t)
            if not sids:
                continue
            psi_g[n, sids] = pg
            psi_c[n, sids] = pc
            omega[n, sids] = om
            floors_g[n, sids] = fg
            floors_c[n, sids] = fc
        return psi_g, psi_c, omega, floors_g, floors_c, mask

    def apply_allocation(self, g_ns: np.ndarray, c_ns: np.ndarray,
                         nodes: Optional[List[int]] = None) -> None:
        """Collapse [N, S] node-major allocation onto per-instance vectors.

        Writes in place: in batched runs the allocation vectors are row
        views of the block, so rebinding would silently detach them.
        """
        if nodes is None:
            self.alloc_g[:] = g_ns[self.placement, np.arange(self.S)]
            self.alloc_c[:] = c_ns[self.placement, np.arange(self.S)]
            return
        for n in nodes:
            for sid in self._node_sids[n]:
                self.alloc_g[sid] = g_ns[n, sid]
                self.alloc_c[sid] = c_ns[n, sid]

    def default_allocate(self, t: float,
                         nodes: Optional[List[int]] = None) -> None:
        """The paper's allocation layer (closed-form active-set, Eq. 18)."""
        deadline_allocate_solo(self, t, nodes)

    def observe_cuup_time(self, cell: int, elapsed: float) -> None:
        ema = self._cuup_time_ema.get(cell, elapsed)
        new = 0.9 * ema + 0.1 * elapsed
        self._cuup_time_ema[cell] = new
        du_sid = self._du_by_cell.get(cell)
        if du_sid is not None:
            self._alpha_down[du_sid] = new

    # ------------------------------------------------------------------ #
    # routing: smallest-backlog among the service's replicas (paper §II)
    # ------------------------------------------------------------------ #
    def route_ai(self, sids, t: float,
                 rr_counter: Optional[List[int]] = None) -> int:
        if rr_counter is not None:                   # Round-Robin baseline
            sid = sids[rr_counter[0] % len(sids)]
            rr_counter[0] += 1
            return int(sid)
        idx = np.asarray(sids, np.int64)
        psi = self.tail_psi_g[idx] + self.head_rem_g[idx]
        wait = psi / np.maximum(self.alloc_g[idx], 1e6) \
            + np.maximum(self.reconfig_until[idx] - t, 0.0)
        return int(idx[int(np.argmin(wait))])

    # ------------------------------------------------------------------ #
    # snapshot metrics for agents / critics / prompts
    # ------------------------------------------------------------------ #
    def utilization(self, t: float) -> Dict[str, np.ndarray]:
        psi_g, psi_c, omega, fg, fc, mask = self.allocator_inputs(t)
        g_used = np.zeros(self.N)
        c_used = np.zeros(self.N)
        np.add.at(g_used, self.placement, self.alloc_g)
        np.add.at(c_used, self.placement, self.alloc_c)
        # effective (time-varying) capacity in the denominators; the
        # max(·, eps) keeps a fully departed node (eff = 0, alloc already
        # re-solved to 0) at util 0 instead of NaN — bit-identical for any
        # live capacity, which is far above eps
        g_den = np.maximum(self.gpu_eff, 1e-9)
        c_den = np.maximum(self.cpu_eff, 1e-9)
        return {
            "gpu_util": g_used / g_den,
            "cpu_util": c_used / c_den,
            "ran_floor_g": fg.sum(axis=1) / g_den,
            "ran_floor_c": fc.sum(axis=1) / c_den,
            "vram_used": self.vram_used(),
            "vram_headroom": self.vram_headroom(),
            "psi_g": psi_g.sum(axis=0),
            "psi_c": psi_c.sum(axis=0),
            "omega": omega.sum(axis=0),
            "queue_len": np.array([len(q) for q in self.queues], np.int64),
        }


# --------------------------------------------------------------------------- #
# shared floor/urgency math (the elementwise core of Eq. 13–15)
# --------------------------------------------------------------------------- #
def _alloc_floor_math(D, t, psi_g_raw, psi_c_raw, cat, alpha, delta,
                      gcap, ccap):
    """(Ψ^g, Ψ^c, ω, floor_g, floor_c, infeasible-mask) for gathered heads.

    ``D`` is the inf-padded deadline rows ``[P, L]``; every other input is
    ``[P]`` (or a scalar broadcast).  Pure elementwise expressions plus
    the padding-invariant tree sum — a gathered element computes the
    identical doubles whether it arrived via the per-node solo path or
    the cross-replica batched path.  The returned mask flags elements
    whose RAN floor slack was already gone (Eq. 15 infeasibility).
    """
    rem = D - (t[:, None] if isinstance(t, np.ndarray) else t)
    np.maximum(rem, EPS_URGENCY, out=rem)
    np.reciprocal(rem, out=rem)                  # Eq. 14 contributions
    omega = _tree_sum(rem)
    psi_g = np.maximum(psi_g_raw, 0.0)
    psi_c = np.maximum(psi_c_raw, 0.0)
    if gcap is None:                             # caller saw no RAN heads
        return psi_g, psi_c, omega, None, None, None
    min_rem = D.min(axis=1) - t
    fg = np.zeros(len(omega))
    fc = np.zeros(len(omega))
    infeas = np.zeros(len(omega), bool)
    du = cat == _CAT_DU
    if du.any():
        rem_f = (min_rem[du] - delta - alpha[du]) * FLOOR_MARGIN
        infeas[du] = rem_f <= 0.0
        fg[du] = np.minimum(psi_g[du] / np.maximum(rem_f, EPS_FLOOR),
                            gcap[du] if isinstance(gcap, np.ndarray)
                            else gcap)
        del rem_f
    cu = cat == _CAT_CUUP
    if cu.any():
        rem_f = min_rem[cu] * FLOOR_MARGIN
        infeas[cu] = rem_f <= 0.0
        fc[cu] = np.minimum(psi_c[cu] / np.maximum(rem_f, EPS_FLOOR),
                            ccap[cu] if isinstance(ccap, np.ndarray)
                            else ccap)
    return psi_g, psi_c, omega, fg, fc, infeas


def _solve_and_scatter(probs, psi_g, psi_c, omega, fg, fc, caps_g, caps_c,
                       write_g, write_c):
    """Pad the gathered problems to [2P, K], solve, scatter via callbacks.

    ``probs`` holds (lo, hi) element ranges per (node, resource-pair)
    problem; ``write_g``/``write_c`` receive the flat per-element
    allocation vectors aligned with the gather order.
    """
    P = len(probs)
    K = _pow2_at_least(max(hi - lo for lo, hi in probs))
    w_flat_g = np.sqrt(omega * psi_g)             # Eq. 17
    w_flat_c = np.sqrt(omega * psi_c)
    w = np.zeros((2 * P, K))
    fl = np.zeros((2 * P, K))
    rows = np.empty(len(psi_g), np.int64)
    cols = np.empty(len(psi_g), np.int64)
    for p, (lo, hi) in enumerate(probs):
        rows[lo:hi] = p
        cols[lo:hi] = np.arange(hi - lo)
    w[rows, cols] = w_flat_g
    w[rows + P, cols] = w_flat_c
    # all-zero floor vectors leave fl untouched: identical to scattering
    # zeros, and it lets the solver take its floors-free shortcut
    if fg is not None and fg.any():
        fl[rows, cols] = fg
    if fc is not None and fc.any():
        fl[rows + P, cols] = fc
    caps = np.concatenate([caps_g, caps_c])
    alloc = _active_set_rows(w, fl, caps)
    write_g(alloc[rows, cols])
    write_c(alloc[rows + P, cols])


def _collect_node_problems(cluster: ClusterState, t, nodes, full: bool,
                           probs, node_of, ss) -> None:
    """Append (lo, hi) problem ranges + sids for a replica's dirty nodes.

    ``full`` means every node re-solves: the caller already zeroed the
    whole allocation vector, so only nodes that actually own a servable
    head are visited (found with one vectorized scan) — identical final
    state to visiting all N nodes, since idle nodes contribute nothing.
    """
    if full:
        busy = cluster.head_mask & (cluster.reconfig_until <= t)
        hit = np.nonzero(busy)[0]
        if not len(hit):
            return
        for n in np.unique(cluster.placement[hit]):
            sids = [s for s in cluster._node_sids[n] if busy[s]]
            probs.append((len(ss), len(ss) + len(sids)))
            node_of.append(int(n))
            ss.extend(sids)
    else:
        for n in nodes:
            sids = cluster._servable_sids(n, t)
            if sids:
                probs.append((len(ss), len(ss) + len(sids)))
                node_of.append(n)
                ss.extend(sids)


def _tree_sum_scalars(vals: List[float]) -> float:
    """Pairwise-halving sum of a few Python floats.

    Zero-pads to a power of two and folds in halves — the same reduction
    tree (and therefore the same double) :func:`_tree_sum` produces for
    the zero/infinity-padded array rows, whatever padded width they carry.
    """
    k = 1
    n = len(vals)
    while k < n:
        k <<= 1
    vals = list(vals) + [0.0] * (k - n)
    while len(vals) > 1:
        h = len(vals) // 2
        vals = [vals[i] + vals[i + h] for i in range(h)]
    return vals[0] if vals else 0.0


def _active_set_scalar(w: List[float], floors: List[float],
                       cap: float) -> List[float]:
    """Eq. 17–19 active-set fixed point on one problem, Python scalars.

    Evaluates exactly the per-element expressions of
    :func:`_active_set_rows` with tree-ordered reductions, so the result
    is bit-identical to the row the padded vector solve would produce
    (padding contributes exact zeros to every sum and never unpins).
    """
    global _SOLVE_ITERS
    k = len(w)
    floor_sum = _tree_sum_scalars(floors)
    if floor_sum > cap + 1e-6 and floor_sum > 0.0:
        scale = cap / floor_sum
        floors = [f * scale for f in floors]
    pinned = [wi <= 0.0 for wi in w]

    def sums():
        rem = cap - _tree_sum_scalars(
            [floors[i] if pinned[i] else 0.0 for i in range(k)])
        rem = max(rem, 0.0)
        denom = max(_tree_sum_scalars(
            [0.0 if pinned[i] else w[i] for i in range(k)]), EPS_ALLOC)
        return rem, denom

    for it in range(k):
        rem, denom = sums()
        grew = False
        for i in range(k):
            if not pinned[i] and w[i] * rem / denom < floors[i]:
                pinned[i] = True
                grew = True
        if not grew:
            _SOLVE_ITERS += it + 1
            break
    else:
        _SOLVE_ITERS += k
    rem, denom = sums()
    return [floors[i] if pinned[i] else w[i] * rem / denom
            for i in range(k)]


# crossover below which the per-event gather solves faster as Python
# scalars than as padded numpy rows (single-node realloc after an ordinary
# event: 1–5 busy heads; epochs / refresh re-solves stay vectorized)
SCALAR_GATHER_MAX = 8


def _deadline_allocate_scalar(cluster: ClusterState, t: float,
                              probs, node_of, ss) -> None:
    """Tree-ordered scalar fast path for tiny allocator gathers.

    Evaluates the identical IEEE-754 expressions of
    :func:`_alloc_floor_math` + :func:`_active_set_rows` element by
    element (reductions via :func:`_tree_sum_scalars`), so the written
    allocations are bit-for-bit what the vector path would write — the
    array set-up cost just never gets paid.  This recovers the solo
    single-trace throughput the shared batched-gather expressions cost
    without forking the allocation semantics.
    """
    dl_pad = cluster.dl_pad
    queues = cluster.queues
    tail_g, head_g = cluster.tail_psi_g, cluster.head_rem_g
    tail_c, head_c = cluster.tail_psi_c, cluster.head_rem_c
    cat = cluster._cat_code
    alloc_g, alloc_c = cluster.alloc_g, cluster.alloc_c
    for p, (lo, hi) in enumerate(probs):
        n = node_of[p]
        gcap = float(cluster.gpu_eff[n])
        ccap = float(cluster.cpu_eff[n])
        w_g: List[float] = []
        w_c: List[float] = []
        fg: List[float] = []
        fc: List[float] = []
        for sid in ss[lo:hi]:
            row = dl_pad[sid]
            cnt = len(queues[sid].jobs)
            dls = row[:cnt].tolist()
            contrib = [1.0 / max(d - t, EPS_URGENCY) for d in dls]
            omega = _tree_sum_scalars(contrib)           # Eq. 14
            psi_g = max(float(tail_g[sid]) + float(head_g[sid]), 0.0)
            psi_c = max(float(tail_c[sid]) + float(head_c[sid]), 0.0)
            code = cat[sid]
            f_g = f_c = 0.0
            if code == _CAT_DU:
                min_rem = min(dls) - t
                rem_f = (min_rem - cluster.delta
                         - float(cluster._alpha_down[sid])) * FLOOR_MARGIN
                if rem_f <= 0.0:
                    cluster.infeasible_events += 1
                f_g = min(psi_g / max(rem_f, EPS_FLOOR), gcap)
            elif code == _CAT_CUUP:
                min_rem = min(dls) - t
                rem_f = min_rem * FLOOR_MARGIN
                if rem_f <= 0.0:
                    cluster.infeasible_events += 1
                f_c = min(psi_c / max(rem_f, EPS_FLOOR), ccap)
            w_g.append(math.sqrt(omega * psi_g))         # Eq. 17
            w_c.append(math.sqrt(omega * psi_c))
            fg.append(f_g)
            fc.append(f_c)
        g = _active_set_scalar(w_g, fg, gcap)
        c = _active_set_scalar(w_c, fc, ccap)
        for j, sid in enumerate(ss[lo:hi]):
            alloc_g[sid] = g[j]
            alloc_c[sid] = c[j]


def deadline_allocate_solo(cluster: ClusterState, t: float,
                           nodes=None) -> None:
    """Deadline-aware allocation over ``nodes`` (``None`` = all) of one
    replica: one gather across every servable head of the dirty nodes,
    one padded active-set solve for all (node, resource) problems, one
    scatter.  Gathers of at most :data:`SCALAR_GATHER_MAX` heads take the
    bit-identical tree-ordered scalar path instead (the per-event common
    case: one dirty node, a few busy instances).
    """
    global _SOLVE_ITERS
    _SOLVE_ITERS = 0
    probs: List[Tuple[int, int]] = []
    node_of: List[int] = []
    ss: List[int] = []
    if nodes is None:
        cluster.alloc_g.fill(0.0)
        cluster.alloc_c.fill(0.0)
    else:
        zero = [s for n in nodes for s in cluster._node_sids[n]]
        if zero:
            zi = np.asarray(zero, np.int64)
            cluster.alloc_g[zi] = 0.0
            cluster.alloc_c[zi] = 0.0
    _collect_node_problems(cluster, t, nodes, nodes is None,
                           probs, node_of, ss)
    if not ss:
        return
    if len(ss) <= SCALAR_GATHER_MAX:
        _deadline_allocate_scalar(cluster, t, probs, node_of, ss)
    else:
        idx = np.asarray(ss, np.int64)
        cat = cluster._cat_code[idx]
        if (cat != _CAT_AI).any():
            nn = np.repeat(node_of, [hi - lo for lo, hi in probs])
            gcap, ccap = cluster.gpu_eff[nn], cluster.cpu_eff[nn]
            alpha = cluster._alpha_down[idx]
        else:                   # pure-AI gather: no floors to build
            gcap = ccap = alpha = None
        psi_g, psi_c, omega, fg, fc, infeas = _alloc_floor_math(
            cluster.dl_pad[idx], t,
            cluster.tail_psi_g[idx] + cluster.head_rem_g[idx],
            cluster.tail_psi_c[idx] + cluster.head_rem_c[idx],
            cat, alpha, cluster.delta, gcap, ccap)
        if infeas is not None:
            cluster.infeasible_events += int(np.count_nonzero(infeas))
        _solve_and_scatter(
            probs, psi_g, psi_c, omega, fg, fc,
            cluster.gpu_eff[node_of], cluster.cpu_eff[node_of],
            lambda g: cluster.alloc_g.__setitem__(idx, g),
            lambda c: cluster.alloc_c.__setitem__(idx, c))
    if cluster.trace is not None:
        cluster.trace.emit(_TRACE_ALLOC, t, cluster.trace_b, len(ss),
                           _SOLVE_ITERS, float(len(probs)))


def deadline_allocate_block(block: "ClusterBlock", t_vec: np.ndarray,
                            node_lists) -> None:
    """Cross-replica deadline-aware allocation in one fused gather/solve.

    ``node_lists[b]`` is the sequence of node ids replica ``b`` must
    re-solve this event (``None`` = full re-solve, ``()`` = skip).
    Discrete-outcome identical to calling :func:`deadline_allocate_solo`
    per replica: every gathered element evaluates the same scalar
    expressions, reductions are padding-invariant tree sums, and the
    active-set rows are independent.
    """
    global _SOLVE_ITERS
    _SOLVE_ITERS = 0
    clusters = block.clusters
    zb: List[int] = []
    zs: List[int] = []
    probs: List[Tuple[int, int]] = []
    prob_cap_n: List[int] = []
    bb: List[int] = []
    ss: List[int] = []
    for b, nodes in enumerate(node_lists):
        if nodes is not None and not nodes:
            continue
        cl = clusters[b]
        t = t_vec[b]
        if nodes is None:
            cl.alloc_g.fill(0.0)
            cl.alloc_c.fill(0.0)
        else:
            for n in nodes:
                row = cl._node_sids[n]
                zb.extend([b] * len(row))
                zs.extend(row)
        _collect_node_problems(cl, t, nodes, nodes is None,
                               probs, prob_cap_n, ss)
        bb.extend([b] * (len(ss) - len(bb)))
    if zs:
        block.alloc_g[zb, zs] = 0.0
        block.alloc_c[zb, zs] = 0.0
    if not ss:
        return
    bi = np.asarray(bb, np.int64)
    si = np.asarray(ss, np.int64)
    # per-problem replica index (churn makes effective capacity per-replica
    # state, so capacity gathers must go through the [B, N] block rows)
    prob_b = np.asarray([bb[lo] for lo, hi in probs], np.int64)
    cl0 = clusters[0]
    cat = cl0._cat_code[si]
    if (cat != _CAT_AI).any():
        nn = np.repeat(prob_cap_n, [hi - lo for lo, hi in probs])
        gcap, ccap = block.gpu_eff[bi, nn], block.cpu_eff[bi, nn]
        alpha = block.alpha_down[bi, si]
    else:                       # pure-AI gather: no floors to build
        gcap = ccap = alpha = None
    psi_g, psi_c, omega, fg, fc, infeas = _alloc_floor_math(
        block.dl_pad[bi, si], t_vec[bi],
        block.tail_psi_g[bi, si] + block.head_rem_g[bi, si],
        block.tail_psi_c[bi, si] + block.head_rem_c[bi, si],
        cat, alpha, cl0.delta, gcap, ccap)
    if infeas is not None and infeas.any():
        for b in bi[infeas]:
            clusters[b].infeasible_events += 1
    _solve_and_scatter(
        probs, psi_g, psi_c, omega, fg, fc,
        block.gpu_eff[prob_b, prob_cap_n], block.cpu_eff[prob_b, prob_cap_n],
        lambda g: block.alloc_g.__setitem__((bi, si), g),
        lambda c: block.alloc_c.__setitem__((bi, si), c))
    if cl0.trace is not None:
        # one ALLOC record per participating replica: its own head count
        # and problem count, the (shared) padded solve's iterations
        heads_per_b = np.bincount(bi, minlength=block.B)
        probs_per_b = np.bincount(prob_b, minlength=block.B)
        for b in np.nonzero(heads_per_b)[0]:
            cl0.trace.emit(_TRACE_ALLOC, float(t_vec[b]), int(b),
                           int(heads_per_b[b]), _SOLVE_ITERS,
                           float(probs_per_b[b]))


# --------------------------------------------------------------------------- #
# batched multi-seed block
# --------------------------------------------------------------------------- #
class ClusterBlock:
    """Contiguous ``[B, S]`` state over B same-scenario replicas.

    Stacks each replica's per-instance arrays into block rows and rebinds
    the :class:`ClusterState` attributes as views, so queue mutators keep
    writing scalar slots while the batched event core and
    :func:`deadline_allocate_block` advance the whole block in fused
    array steps.  The deadline matrix is ``[B, S, L]`` with a shared
    power-of-two L; :func:`_tree_sum` padding invariance keeps ω
    identical to each replica's solo value.
    """

    ARRAYS = ("head_rem_g", "head_rem_c", "head_deadline", "head_kv",
              "head_mask", "head_started", "alloc_g", "alloc_c",
              "reconfig_until", "tail_psi_g", "tail_psi_c", "_alpha_down")
    # per-node dynamic state ([B, N]): spot churn retunes these in place
    # through the replicas' row views — never rebuilt per change
    NODE_ARRAYS = ("node_scale", "gpu_eff", "cpu_eff", "node_drain_until")

    def __init__(self, clusters: Sequence[ClusterState]):
        assert clusters, "a batch needs at least one replica"
        S = clusters[0].S
        assert all(cl.S == S for cl in clusters), \
            "batched replicas must share one scenario topology"
        self.clusters = list(clusters)
        self.B = len(clusters)
        self.S = S
        for name in self.ARRAYS:
            blk = np.stack([getattr(cl, name) for cl in clusters])
            setattr(self, name.lstrip("_"), blk)
            for b, cl in enumerate(clusters):
                setattr(cl, name, blk[b])
        for name in self.NODE_ARRAYS:
            blk = np.stack([getattr(cl, name) for cl in clusters])
            setattr(self, name, blk)
            for b, cl in enumerate(clusters):
                setattr(cl, name, blk[b])
        L = max(cl.dl_cols for cl in clusters)
        self.dl_cols = L
        self.dl_pad = np.full((self.B, S, L), np.inf)
        for b, cl in enumerate(clusters):
            self.dl_pad[b, :, :cl.dl_cols] = cl.dl_pad
            cl.dl_pad = self.dl_pad[b]
            cl.dl_cols = L
            cl._block = self

    def grow_dl(self) -> None:
        """Double the padded deadline width for every replica at once."""
        L2 = self.dl_cols * 2
        new = np.full((self.B, self.S, L2), np.inf)
        new[:, :, :self.dl_cols] = self.dl_pad
        self.dl_pad = new
        self.dl_cols = L2
        for b, cl in enumerate(self.clusters):
            cl.dl_pad = new[b]
            cl.dl_cols = L2
