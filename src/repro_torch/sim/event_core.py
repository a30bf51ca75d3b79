"""Event cores: the simulator's per-event hot pair (next_completion, advance).

Between events every instance serves the head of its FIFO at its allocated
rate with strict stage ordering (GPU work first, then CPU — Eq. 1):

  * ``next_completion`` — earliest time any head finishes BOTH stages.  A
    head whose pending stage has zero allocation cannot complete and is
    excluded (the next reallocation event unblocks it).
  * ``advance`` — progress every served head by ``dt``, never crossing the
    GPU→CPU stage boundary within an update: CPU work progresses only once
    the GPU residual is exhausted, and nothing progresses while the GPU
    stage is stalled (``rem_g > 0`` with ``alloc_g <= 0``).  This is the
    fix for the historical divergence where CPU work progressed on heads
    the completion scan skipped, silently desyncing progressed work from
    the event schedule.

Three interchangeable backends over the contiguous per-instance arrays
owned by :class:`~repro_torch.sim.cluster.ClusterState`:

  * ``scalar`` — pure-Python reference loop (debug engine; the semantics
    spec the others must match bit-for-bit),
  * ``numpy``  — one masked argmin + one fused array update (default),
  * ``torch``  — the same fused step as eager float64 tensor code
    (:mod:`repro_torch.kernels.ref`) on an explicit ``device``.

The scalar and numpy cores are bit-for-bit equivalent by construction:
both evaluate the identical IEEE-754 double expressions per instance
(``rem/rate`` divisions, ``min`` clamps, first-index argmin tie-break).

Batched multi-seed runs (``Simulator.run_batch``) use the *batched*
cores below (``make_batched_event_core``): B replicas' arrays stack into
one ``[B, S]`` :class:`~repro_torch.sim.cluster.ClusterBlock` and the whole
block advances per lockstep tick — ``numpy`` (elementwise-identical to
the solo pair, so batched outcomes are bit-for-bit the solo outcomes),
``scalar`` (per-row reference), ``torch`` (the eager float64 plain
version on ``device``), and ``cuda`` (the fused step as one hand-written
CUDA kernel launch per tick, :mod:`repro_torch.kernels.event_step`).

The device cores never carry on on the CPU by themselves: asking for a CUDA
device where none is available raises ``RuntimeError``.
"""
from __future__ import annotations

from time import perf_counter
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sim.cluster import ClusterState

INF = float("inf")

# Every core exposes ``profiler`` (a repro_torch.obs Profiler or None, attached
# by the Simulator per run).  The numpy/scalar cores' work is already
# timed by the run loop's "engine.step" phase; the torch/cuda cores use it
# to split the step into core.h2d / core.kernel / core.d2h — the
# host↔device transfer accounting of a tick.


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device that is not there
    raises instead of silently running on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} was asked for but CUDA is not available "
            "(torch.cuda.is_available() is False); pass device='cpu' with "
            "engine='numpy' | 'scalar' | 'torch' to run on the host")
    return dev


def _sync(device: torch.device) -> None:
    """Wait for the device (profiled runs only: each leg is timed)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class ScalarEventCore:
    """Reference implementation: explicit per-instance Python loops."""

    name = "scalar"
    profiler = None

    def next_completion(self, cluster: ClusterState,
                        t: float) -> Tuple[float, int]:
        best_t, best_s = INF, -1
        for sid in range(cluster.S):
            if not cluster.head_mask[sid] or t < cluster.reconfig_until[sid]:
                continue
            g = cluster.alloc_g[sid]
            c = cluster.alloc_c[sid]
            rg = cluster.head_rem_g[sid]
            rc = cluster.head_rem_c[sid]
            dt = 0.0
            if rg > 0.0:
                if g <= 0.0:
                    continue                     # GPU stage stalled
                dt += rg / g
            if rc > 0.0:
                if c <= 0.0:
                    continue                     # CPU stage would stall
                dt += rc / c
            if t + dt < best_t:
                best_t, best_s = t + dt, sid
        return best_t, best_s

    def advance(self, cluster: ClusterState, t: float, dt: float) -> None:
        if dt <= 0.0:
            return
        for sid in range(cluster.S):
            if not cluster.head_mask[sid] or t < cluster.reconfig_until[sid]:
                continue
            g = cluster.alloc_g[sid]
            c = cluster.alloc_c[sid]
            rg = cluster.head_rem_g[sid]
            rem_dt = dt
            if rg > 0.0:
                if g <= 0.0:
                    continue                     # stalled: nothing moves
                tg = min(rem_dt, rg / g)
                cluster.head_rem_g[sid] = rg - g * tg
                cluster.head_started[sid] = True
                rem_dt = rem_dt - tg
                if cluster.head_rem_g[sid] > 0.0:
                    continue                     # GPU stage not finished
            rc = cluster.head_rem_c[sid]
            if rem_dt > 0.0 and rc > 0.0 and c > 0.0:
                tc = min(rem_dt, rc / c)
                cluster.head_rem_c[sid] = rc - c * tc
                cluster.head_started[sid] = True


class NumpyEventCore:
    """Vectorized core: masked argmin + fused array update (default).

    Every step is an ``out=``-targeted ufunc on preallocated [S] scratch —
    the per-event cost is a fixed number of contiguous array passes with no
    allocations, evaluating exactly the IEEE-754 expressions of the scalar
    reference (same divisions, same ``min`` clamps, first-index argmin).

    ``next_completion`` and ``advance`` share a prepare step (availability
    mask + per-stage service times): the event loop always scans for the
    next completion and then advances to it from the same state, so the
    prepare result is cached per ``t`` and ``advance`` reuses it when the
    times match.  ``advance`` invalidates the cache (it mutates the
    residuals); a standalone ``advance`` at a fresh ``t`` re-prepares."""

    name = "numpy"
    profiler = None

    def __init__(self) -> None:
        self._S = -1
        self._cache_t: Optional[float] = None

    def _ensure_scratch(self, S: int) -> None:
        if S != self._S:
            self._S = S
            self._cache_t = None
            self._avail = np.empty(S, bool)   # head servable at t
            self._b1 = np.empty(S, bool)      # rem_g > 0
            self._b2 = np.empty(S, bool)      # rem_c > 0
            self._bt = np.empty(S, bool)
            self._bu = np.empty(S, bool)
            self._dt_g = np.empty(S, np.float64)          # rem_g / alloc_g (else 0)
            self._dt_c = np.empty(S, np.float64)          # rem_c / alloc_c (else 0)
            self._tx = np.empty(S, np.float64)
            self._delta = np.empty(S, np.float64)
            self._rem = np.empty(S, np.float64)

    def _prepare(self, cluster: ClusterState, t: float) -> None:
        np.less_equal(cluster.reconfig_until, t, out=self._avail)
        np.logical_and(self._avail, cluster.head_mask, out=self._avail)
        np.greater(cluster.head_rem_g, 0.0, out=self._b1)
        np.greater(cluster.head_rem_c, 0.0, out=self._b2)
        self._dt_g.fill(0.0)
        self._dt_c.fill(0.0)
        # a pending stage with zero rate divides to +inf: it can never win
        # the completion argmin, and advance masks it out of the update
        with np.errstate(divide="ignore", invalid="ignore"):
            np.divide(cluster.head_rem_g, cluster.alloc_g,
                      out=self._dt_g, where=self._b1)
            np.divide(cluster.head_rem_c, cluster.alloc_c,
                      out=self._dt_c, where=self._b2)
        self._cache_t = t

    def next_completion(self, cluster: ClusterState,
                        t: float) -> Tuple[float, int]:
        self._ensure_scratch(cluster.S)
        self._prepare(cluster, t)
        cand = self._tx
        np.add(self._dt_g, self._dt_c, out=cand)
        np.add(cand, t, out=cand)
        np.logical_not(self._avail, out=self._bt)
        np.copyto(cand, INF, where=self._bt)
        sid = int(np.argmin(cand))
        best = float(cand[sid])
        if not np.isfinite(best):
            return INF, -1
        return best, sid

    def advance(self, cluster: ClusterState, t: float, dt: float) -> None:
        if dt <= 0.0:
            return
        self._ensure_scratch(cluster.S)
        if self._cache_t != t:
            self._prepare(cluster, t)
        g = cluster.alloc_g
        c = cluster.alloc_c
        rg = cluster.head_rem_g
        rc = cluster.head_rem_c
        tx, delta, rem_dt = self._tx, self._delta, self._rem
        run_g, btmp, baux = self._bt, self._bu, self._b1
        np.greater(g, 0.0, out=run_g)
        np.logical_and(run_g, self._b1, out=run_g)       # GPU stage serves:
        np.logical_and(run_g, self._avail, out=run_g)    # rem_g>0, g>0, avail
        np.minimum(self._dt_g, dt, out=tx)               # tg = min(dt, rg/g)
        delta.fill(0.0)
        np.multiply(g, tx, out=delta, where=run_g)       # dg
        np.subtract(rg, delta, out=rg)                   # rem_g -= dg
        np.subtract(dt, tx, out=rem_dt)                  # time left after GPU
        # CPU progresses only once the GPU residual is exhausted (Eq. 1
        # stage ordering) — which also excludes stalled heads (rem_g>0
        # with alloc_g<=0 progressed nothing, so rem_g stays positive)
        np.less_equal(rg, 0.0, out=btmp)
        np.logical_and(btmp, self._avail, out=btmp)
        np.logical_and(btmp, self._b2, out=btmp)         # rem_c > 0
        np.greater(rem_dt, 0.0, out=baux)
        np.logical_and(btmp, baux, out=btmp)
        np.greater(c, 0.0, out=baux)
        np.logical_and(btmp, baux, out=btmp)             # cpu_ok
        np.minimum(self._dt_c, rem_dt, out=tx)           # tc = min(rem, rc/c)
        delta.fill(0.0)
        np.multiply(c, tx, out=delta, where=btmp)        # dc
        np.subtract(rc, delta, out=rc)                   # rem_c -= dc
        np.logical_or(run_g, btmp, out=run_g)            # any progress
        np.logical_or(cluster.head_started, run_g,
                      out=cluster.head_started)
        self._cache_t = None                             # residuals changed


class TorchEventCore:
    """Eager float64 torch pair from :mod:`repro_torch.kernels.ref` on
    ``device`` (twin of the reference's jitted device core).

    The state arrays stay float64 end to end — the event schedule is a
    chain of IEEE-754 double expressions, and float32 would desync this
    engine from the scalar/numpy pair within a handful of events.
    Per-event host<->device transfers make this the slow way to run one
    trace; it exists as the device-resident solo path beside the batched
    kernel core.
    """

    name = "torch"
    profiler = None

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    def _put(self, *arrays):
        """Host→device staging, timed as ``core.h2d`` when profiling."""
        prof = self.profiler
        if prof is not None:
            t0 = perf_counter()
        out = tuple(torch.from_numpy(a).to(self.device) for a in arrays)
        if prof is not None:
            _sync(self.device)
            prof.add("core.h2d", perf_counter() - t0)
        return out

    def next_completion(self, cluster: ClusterState,
                        t: float) -> Tuple[float, int]:
        prof = self.profiler
        avail = cluster.head_mask & (cluster.reconfig_until <= t)
        rg, rc, g, c, av = self._put(
            cluster.head_rem_g, cluster.head_rem_c,
            cluster.alloc_g, cluster.alloc_c, avail)
        if prof is not None:
            t0 = perf_counter()
        best, sid = kref.next_completion_ref(rg, rc, g, c, av, t)
        if prof is not None:
            _sync(self.device)
            prof.add("core.kernel", perf_counter() - t0)
            t0 = perf_counter()
        best = float(best)
        sid = int(sid)
        if prof is not None:
            prof.add("core.d2h", perf_counter() - t0)
        if not np.isfinite(best):
            return INF, -1
        return best, sid

    def advance(self, cluster: ClusterState, t: float, dt: float) -> None:
        if dt <= 0.0:
            return
        prof = self.profiler
        act = cluster.head_mask & (cluster.reconfig_until <= t)
        a_rg, a_rc, g, c, av = self._put(
            cluster.head_rem_g, cluster.head_rem_c,
            cluster.alloc_g, cluster.alloc_c, act)
        if prof is not None:
            t0 = perf_counter()
        rg, rc, started = kref.advance_ref(a_rg, a_rc, g, c, av, dt)
        if prof is not None:
            _sync(self.device)
            prof.add("core.kernel", perf_counter() - t0)
            t0 = perf_counter()
        cluster.head_rem_g[:] = rg.cpu().numpy()
        cluster.head_rem_c[:] = rc.cpu().numpy()
        cluster.head_started |= started.cpu().numpy()
        if prof is not None:
            prof.add("core.d2h", perf_counter() - t0)


ENGINES = ("numpy", "scalar", "torch")


def make_event_core(engine: str, device="cuda"):
    """``engine`` -> event core instance (raises on unknown names).
    ``device`` matters to the ``torch`` core only."""
    if engine == "numpy":
        return NumpyEventCore()
    if engine == "scalar":
        return ScalarEventCore()
    if engine == "torch":
        return TorchEventCore(device)
    raise ValueError(f"unknown engine {engine!r}; known: {ENGINES}")


# --------------------------------------------------------------------------- #
# batched cores: B replicas advance as one [B, S] block
# --------------------------------------------------------------------------- #
class NumpyBatchedEventCore:
    """[B, S] fused step: per-row masked argmin + one block-wide advance.

    ``step`` mirrors the solo pair exactly — it evaluates the identical
    IEEE-754 expressions per (replica, instance) element that
    :class:`NumpyEventCore` evaluates per instance — so a replica's event
    schedule in a batch is bit-for-bit the schedule of its solo run.
    Rows whose ``can`` flag is down (drained or at the event budget)
    contribute ``dt = 0`` and are left untouched, matching the solo
    core's early return on ``dt <= 0``.
    """

    name = "numpy"
    profiler = None

    def __init__(self) -> None:
        self._shape = None

    def _ensure_scratch(self, B: int, S: int) -> None:
        if self._shape != (B, S):
            self._shape = (B, S)
            self._avail = np.empty((B, S), bool)
            self._b1 = np.empty((B, S), bool)     # rem_g > 0
            self._b2 = np.empty((B, S), bool)     # rem_c > 0
            self._bt = np.empty((B, S), bool)
            self._bu = np.empty((B, S), bool)
            self._dt_g = np.empty((B, S), np.float64)
            self._dt_c = np.empty((B, S), np.float64)
            self._cand = np.empty((B, S), np.float64)
            self._tx = np.empty((B, S), np.float64)
            self._delta = np.empty((B, S), np.float64)
            self._rem = np.empty((B, S), np.float64)
            self._rows = np.arange(B)

    def step(self, block, t_vec: np.ndarray, t_ev: np.ndarray,
             can: np.ndarray):
        """One lockstep tick.  Returns ``(t_comp [B], sid [B])`` and
        advances every ``can`` row with a finite next event in place."""
        B, S = block.B, block.S
        self._ensure_scratch(B, S)
        g, c = block.alloc_g, block.alloc_c
        rg, rc = block.head_rem_g, block.head_rem_c
        avail, b1, b2 = self._avail, self._b1, self._b2
        t_col = t_vec[:, None]

        # prepare: availability + per-stage service times (shared by the
        # completion scan and the advance, like the solo prepare cache)
        np.less_equal(block.reconfig_until, t_col, out=avail)
        np.logical_and(avail, block.head_mask, out=avail)
        np.greater(rg, 0.0, out=b1)
        np.greater(rc, 0.0, out=b2)
        self._dt_g.fill(0.0)
        self._dt_c.fill(0.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            np.divide(rg, g, out=self._dt_g, where=b1)
            np.divide(rc, c, out=self._dt_c, where=b2)

        # next completion: one masked argmin per row
        cand = self._cand
        np.add(self._dt_g, self._dt_c, out=cand)
        np.add(cand, t_col, out=cand)
        np.logical_not(avail, out=self._bt)
        np.copyto(cand, INF, where=self._bt)
        sid = np.argmin(cand, axis=1)
        t_comp = cand[self._rows, sid]

        # advance every live row to its own next event time
        t_next = np.minimum(t_comp, t_ev)
        dt = np.where(can & np.isfinite(t_next), t_next - t_vec, 0.0)
        dt_col = dt[:, None]
        tx, delta, rem_dt = self._tx, self._delta, self._rem
        run_g, btmp, baux = self._bt, self._bu, self._b1
        np.greater(g, 0.0, out=run_g)
        np.logical_and(run_g, b1, out=run_g)             # GPU stage serves:
        np.logical_and(run_g, avail, out=run_g)          # rem_g>0, g>0, avail
        np.logical_and(run_g, dt_col > 0.0, out=run_g)   # row is advancing
        np.minimum(self._dt_g, dt_col, out=tx)           # tg = min(dt, rg/g)
        delta.fill(0.0)
        np.multiply(g, tx, out=delta, where=run_g)       # dg
        np.subtract(rg, delta, out=rg)                   # rem_g -= dg
        np.subtract(dt_col, tx, out=rem_dt)              # time left after GPU
        # CPU progresses only once the GPU residual is exhausted (Eq. 1
        # stage ordering) — which also excludes stalled heads
        np.less_equal(rg, 0.0, out=btmp)
        np.logical_and(btmp, avail, out=btmp)
        np.logical_and(btmp, b2, out=btmp)               # rem_c > 0
        np.greater(rem_dt, 0.0, out=baux)
        np.logical_and(btmp, baux, out=btmp)
        np.greater(c, 0.0, out=baux)
        np.logical_and(btmp, baux, out=btmp)             # cpu_ok
        np.minimum(self._dt_c, rem_dt, out=tx)           # tc = min(rem, rc/c)
        delta.fill(0.0)
        np.multiply(c, tx, out=delta, where=btmp)        # dc
        np.subtract(rc, delta, out=rc)                   # rem_c -= dc
        np.logical_or(run_g, btmp, out=run_g)            # any progress
        np.logical_or(block.head_started, run_g,
                      out=block.head_started)
        return t_comp, sid


class ScalarBatchedEventCore:
    """Reference batched core: the scalar solo pair per replica row."""

    name = "scalar"
    profiler = None

    def __init__(self) -> None:
        self._core = ScalarEventCore()

    def step(self, block, t_vec, t_ev, can):
        B = block.B
        t_comp = np.full(B, INF, np.float64)
        sid = np.full(B, -1, np.int64)
        for b, cl in enumerate(block.clusters):
            t = float(t_vec[b])
            tc, s = self._core.next_completion(cl, t)
            t_comp[b] = tc
            sid[b] = s
            if can[b]:
                t_next = min(tc, float(t_ev[b]))
                if np.isfinite(t_next):
                    self._core.advance(cl, t, t_next - t)
        return t_comp, sid


class TorchBatchedEventCore:
    """Eager float64 fused [B, S] step on ``device`` — the plain version
    :func:`repro_torch.kernels.ref.event_step_ref`.  Every product is
    rounded before it is subtracted, so outcomes match the numpy batched
    core; the tests hold it to identical discrete outcomes and finish
    times within 1e-9."""

    name = "torch"
    profiler = None

    def __init__(self, device="cuda") -> None:
        self.device = resolve_device(device)

    def _call(self, rg, rc, g, c, avail, t_vec, t_ev, can):
        return kref.event_step_ref(rg, rc, g, c, avail, t_vec, t_ev, can)

    def step(self, block, t_vec, t_ev, can):
        prof = self.profiler
        avail = block.head_mask & (block.reconfig_until <= t_vec[:, None])
        if prof is not None:
            # timing each leg needs a device sync after it; with no
            # profiler the only wait is the copy back to the host
            t0 = perf_counter()
        args = tuple(torch.from_numpy(a).to(self.device) for a in (
            block.head_rem_g, block.head_rem_c, block.alloc_g,
            block.alloc_c, avail, t_vec, t_ev, can))
        if prof is not None:
            _sync(self.device)
            prof.add("core.h2d", perf_counter() - t0)
            t0 = perf_counter()
        rg, rc, started, t_comp, sid = self._call(*args)
        if prof is not None:
            _sync(self.device)
            prof.add("core.kernel", perf_counter() - t0)
            t0 = perf_counter()
        block.head_rem_g[...] = rg.cpu().numpy()
        block.head_rem_c[...] = rc.cpu().numpy()
        block.head_started |= started.cpu().numpy()
        ret = t_comp.cpu().numpy(), sid.cpu().numpy().astype(np.int64)
        if prof is not None:
            prof.add("core.d2h", perf_counter() - t0)
        return ret


class CudaBatchedEventCore(TorchBatchedEventCore):
    """The [B, S] step as ONE hand-written CUDA kernel launch per tick
    (one thread block per replica row, float64, multiply-add contraction
    off — see :mod:`repro_torch.kernels.event_step`).  CUDA only: there is
    no CPU form of this core."""

    name = "cuda"

    def __init__(self, device="cuda") -> None:
        super().__init__(device)
        if self.device.type != "cuda":
            raise RuntimeError(
                "engine='cuda' launches the event_step CUDA kernel and needs "
                f"a CUDA device, got device={str(device)!r}; use "
                "engine='torch' or 'numpy' on the CPU")

    def _call(self, rg, rc, g, c, avail, t_vec, t_ev, can):
        return kops.event_step(rg, rc, g, c, avail, t_vec, t_ev, can)


BATCH_ENGINES = ("numpy", "scalar", "torch", "cuda")


def make_batched_event_core(engine: str, device="cuda"):
    """``engine`` -> batched event core (raises on unknown names).
    ``device`` matters to the ``torch`` and ``cuda`` cores only."""
    if engine == "numpy":
        return NumpyBatchedEventCore()
    if engine == "scalar":
        return ScalarBatchedEventCore()
    if engine == "torch":
        return TorchBatchedEventCore(device)
    if engine == "cuda":
        return CudaBatchedEventCore(device)
    raise ValueError(
        f"unknown batched engine {engine!r}; known: {BATCH_ENGINES}")
