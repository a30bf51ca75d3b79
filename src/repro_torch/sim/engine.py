"""Event-driven simulator: the fast/slow timescale split of the paper.

The allocation layer re-runs at every event (arrival, stage completion,
epoch boundary, migration completion); the placement layer acts only at
epoch boundaries through a pluggable :class:`PlacementPolicy`.  Baselines
swap the :class:`AllocationPolicy` and/or the placement policy; HAF uses
the deadline-aware closed form + the agentic placement layer.

Event mechanics: between events every instance serves the head of its FIFO
queue at its allocated rate with strict stage ordering (GPU work first,
then CPU — Eq. 1), so the next completion time is computable in closed
form and nothing happens between events.  The per-event hot pair
(``next_completion``/``advance``) runs on an interchangeable event core
(``engine="numpy" | "scalar" | "torch" | "cuda"``, see
:mod:`repro_torch.sim.event_core`); ``"cuda"``, the hand-written
``event_step`` kernel, is the default, and a solo ``run`` on it is a
one-replica ``run_batch``.
Expired not-yet-started requests are dropped when they reach the head
(admission control; counted as unfulfilled).

Two run loops share one per-replica event machine (:class:`_Replica`):

  * :meth:`Simulator.run` — the classic single-trace loop (host and
    ``torch`` engines; on ``cuda`` a one-replica ``run_batch``),
  * :meth:`Simulator.run_batch` — B independent replicas (seeds of one
    scenario × method cell) advance in lockstep over ``[B, S]`` blocks:
    each replica keeps its own clock ``t[b]`` and event heap, while
    ``next_completion`` becomes one masked argmin per block row and
    ``advance`` one fused update over the whole block
    (:func:`repro_torch.sim.event_core.make_batched_event_core`), and the
    deadline-aware reallocations of every replica solve in one
    cross-replica gather (:func:`repro_torch.sim.cluster.deadline_allocate_block`).
    Discrete outcomes are identical to running each seed solo.

The slow timescale is batched the same way: an epoch event only *stages*
its snapshot (``_Replica.pending_epoch``); the run loop collects every
replica at an epoch boundary this tick and hands them to
:func:`dispatch_epoch_decisions`, which groups compatible policies (by
``batch_key()``) into ONE ``decide_group`` call — the HAF stack stacks
candidate features ``[B, C, F]`` and runs the critic once per group —
then commits each replica's action (``_Replica.commit_epoch``).  The
solo loop routes single epochs through the same dispatcher, so batched
and solo decisions are the same code on the same inputs.
"""
from __future__ import annotations

import dataclasses
import heapq
import math
from time import perf_counter
from typing import Callable, Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from repro_torch import obs as _obs
from repro_torch.sim.cluster import (ClusterBlock, ClusterState, Job,
                               deadline_allocate_block)
from repro_torch.sim.event_core import make_batched_event_core, make_event_core
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.stream import as_arrival_stream
from repro_torch.sim.types import (InstanceCategory, MigrationAction, Request,
                             RequestClass)

INF = float("inf")
NAN = float("nan")

REALLOC_REFRESH = 0.25   # urgency drift: full re-solve at least 4 Hz

# request-class -> small-int codes for the columnar trace / metrics
# (matches repro_torch.obs.trace.CLS_*)
_CLS_CODE = {RequestClass.LARGE_AI: _obs.CLS_LARGE_AI,
             RequestClass.SMALL_AI: _obs.CLS_SMALL_AI,
             RequestClass.RAN: _obs.CLS_RAN}


class PlacementPolicy(Protocol):
    name: str

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]: ...


class AllocationPolicy(Protocol):
    name: str

    def allocate(self, cluster: ClusterState, t: float,
                 nodes: Optional[List[int]] = None) -> None: ...


class StaticPlacement:
    """No slow-timescale adaptation (HAF-Static / Round-Robin / CAORA)."""
    name = "static"

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        return None


class DeadlineAwareAllocation:
    """The paper's allocation layer (closed-form active-set, Eq. 16–19)."""
    name = "deadline-aware"

    def allocate(self, cluster: ClusterState, t: float,
                 nodes: Optional[List[int]] = None) -> None:
        cluster.default_allocate(t, nodes)


@dataclasses.dataclass
class EpochRecord:
    epoch: int
    t: float
    snapshot: EpochSnapshot
    action: Optional[MigrationAction]
    shortlist: List[MigrationAction]
    # realized class-resolved fulfillment over [t_k, t_{k+1})  (the critic
    # label r_k: large-AI, small-AI, RAN)
    fulfill: Optional[Tuple[float, float, float]] = None
    counts: Optional[Tuple[int, int, int]] = None


# (label in fulfillment()) -> (key in counts_by_class); the two views of
# the same per-class accumulators
_CLS_LABELS = (("overall", "overall"), ("RAN", "ran"), ("AI", "ai"),
               ("LARGE_AI", "large_ai"), ("SMALL_AI", "small_ai"))


@dataclasses.dataclass
class SimResult:
    requests: List[Request]
    dropped: set
    migrations: List[Tuple[float, MigrationAction]]
    epochs: List[EpochRecord]
    infeasible_events: int
    n_events: int
    # the run hit max_events with work still pending: the remaining
    # requests never ran, so every aggregate below is a partial view
    truncated: bool = False
    # run metadata (always populated by the run loops): wall-clock seconds
    # and backend name, so ev/s is derivable from any report row.  For a
    # batched run, wall_s is the wall clock of the WHOLE block (shared by
    # its replicas) — per-replica ev/s is not meaningful in lockstep.
    wall_s: float = 0.0
    engine: str = ""
    # observability payloads (None unless enabled for the run):
    # ``profile`` — Profiler.report() dict (shared across a batch),
    # ``timeseries`` — this replica's gauge samples,
    # ``trace`` — the TraceRecorder (shared across a batch; filter by b)
    profile: Optional[Dict] = None
    timeseries: Optional[List[Dict]] = None
    trace: Optional[object] = None
    # degradation-ladder accounting: per-reason counts of epoch decisions
    # that fell back (LLM crash/timeout/malformed, critic loss); None when
    # nothing degraded
    degraded: Optional[Dict[str, int]] = None
    # per-class (n, violations) from the replica's streaming accumulators
    # (every request the stream emitted, whether or not it was retained).
    # None only for hand-built results — then the legacy request scan is
    # the fallback.  With this set, fulfillment()/summary() never touch
    # ``requests``, so ``retain_requests=False`` runs report identically.
    counts_by_class: Optional[Dict[str, Tuple[int, int]]] = None

    # ------------------------------------------------------------------ #
    @property
    def events_per_sec(self) -> float:
        return self.n_events / self.wall_s if self.wall_s > 0 else 0.0

    @property
    def n_requests(self) -> int:
        """Total requests the run accounted for (stream-emitted or listed)."""
        if self.counts_by_class is not None:
            return self.counts_by_class["overall"][0]
        return len(self.requests)

    def fulfillment(self) -> Dict[str, float]:
        if self.counts_by_class is not None:
            out: Dict[str, float] = {}
            for label, key in _CLS_LABELS:
                n, viol = self.counts_by_class[key]
                if n:
                    out[label] = (n - viol) / n
            return out
        stats: Dict[str, List[int]] = {}
        for r in self.requests:
            ok = r.fulfilled() and r.rid not in self.dropped
            stats.setdefault(r.cls.value, []).append(int(ok))
            stats.setdefault("overall", []).append(int(ok))
            if r.cls.is_ai:
                stats.setdefault("AI", []).append(int(ok))
        return {k: float(np.mean(v)) for k, v in stats.items()}

    def migration_counts(self) -> Tuple[int, int]:
        """(large-AI migrations, total migrations) — Table II/III 'Mig'."""
        large = sum(1 for _, a in self.migrations
                    if a.category == InstanceCategory.LARGE_AI)
        return large, len(self.migrations)

    def violation_counts(self) -> Dict[str, Tuple[int, int]]:
        """Per-class ``(n, violations)`` — the integer counterpart of the
        fulfillment means, 0 (not NaN) for classes absent from the
        scenario, so scalar summaries reconcile exactly with traced SLO
        time series (mean ≡ 1 - viol/n whenever n > 0)."""
        if self.counts_by_class is not None:
            return {key: tuple(self.counts_by_class[key])
                    for _, key in _CLS_LABELS}
        keys = ("overall", "ran", "ai", "large_ai", "small_ai")
        n = dict.fromkeys(keys, 0)
        viol = dict.fromkeys(keys, 0)
        for r in self.requests:
            ok = r.fulfilled() and r.rid not in self.dropped
            buckets = ["overall", r.cls.value.lower()]
            if r.cls.is_ai:
                buckets.append("ai")
            for k in buckets:
                n[k] += 1
                viol[k] += int(not ok)
        return {k: (n[k], viol[k]) for k in keys}

    def summary(self) -> Dict[str, float]:
        """Flat metrics row.  Request classes absent from the scenario are
        NaN (not 0.0) so fleet aggregation can skip them instead of
        averaging phantom zeros into the class means; the per-class
        ``n_*`` / ``viol_*`` counts are plain ints (0 when absent)."""
        f = self.fulfillment()
        large, tot = self.migration_counts()
        forced = sum(1 for _, a in self.migrations
                     if getattr(a, "forced", False))
        out = {
            "overall": f.get("overall", NAN),
            "ran": f.get("RAN", NAN),
            "ai": f.get("AI", NAN),
            "large_ai": f.get("LARGE_AI", NAN),
            "small_ai": f.get("SMALL_AI", NAN),
            "mig_large": large,
            "mig_total": tot,
            "mig_forced": forced,
            "degraded_decisions": (sum(self.degraded.values())
                                   if self.degraded else 0),
            "truncated": self.truncated,
        }
        for k, (cnt, bad) in self.violation_counts().items():
            out[f"n_{k}"] = cnt
            out[f"viol_{k}"] = bad
        return out


# annotate MigrationAction with its category for counting; ``forced``
# marks preemption-driven evacuations (the source node was draining or
# already degraded), which carry a different interruption cost in the
# Eq. 12 accounting than elective rebalancing moves
@dataclasses.dataclass(frozen=True)
class CommittedMigration(MigrationAction):
    category: InstanceCategory = InstanceCategory.SMALL_AI
    forced: bool = False


class _Replica:
    """One trace's event machinery: heap, handlers, windows, realloc cadence.

    Everything *except* the ``next_completion``/``advance`` hot pair lives
    here, so the solo and batched run loops execute literally the same
    per-event Python — the precondition for batched runs being
    discrete-outcome identical to per-seed runs.
    """

    __slots__ = ("sc", "epoch_interval", "drop_expired", "cluster",
                 "requests", "placement", "allocation", "rr_counter",
                 "service_sids", "ran_packet", "delta", "heap", "seq",
                 "stream", "retain_requests", "_chunks", "_emit_idx",
                 "loaded_until", "stream_done", "emitted", "totals",
                 "dropped", "migrations", "epochs", "win", "arrivals_win",
                 "current_rec", "t", "n_events", "truncated", "dirty",
                 "last_full", "epoch_hook", "done", "pending_epoch",
                 "trace", "metrics", "b", "n_down", "boost_nodes",
                 "degraded")

    def __init__(self, sc: Dict, epoch_interval: float, drop_expired: bool,
                 requests, placement: PlacementPolicy,
                 allocation: AllocationPolicy, rr_dispatch: bool,
                 epoch_hook: Optional[Callable],
                 retain_requests: bool = True):
        self.sc = sc
        self.epoch_interval = epoch_interval
        self.drop_expired = drop_expired
        # the arrival source: a chunked ArrivalStream, or a plain list
        # coerced to one (single bulk chunk, lazily cloned — requests
        # carry mutable runtime state; runs must not interact)
        self.stream = as_arrival_stream(requests)
        self.retain_requests = retain_requests
        self.requests = []            # requests loaded so far (if retained)
        self._chunks = self.stream.chunks()
        self._emit_idx = 0            # global heap tiebreak across chunks
        self.loaded_until = -INF      # arrival frontier of loaded chunks
        self.stream_done = False
        # streaming per-class accumulators: emitted counts every request
        # the stream produced; totals = [fulfilled, recorded] outcomes.
        # unaccounted (emitted - recorded) requests never completed —
        # violations by definition, however the run ended.
        self.emitted = {RequestClass.LARGE_AI: 0, RequestClass.SMALL_AI: 0,
                        RequestClass.RAN: 0}
        self.totals = {RequestClass.LARGE_AI: [0, 0],
                       RequestClass.SMALL_AI: [0, 0],
                       RequestClass.RAN: [0, 0]}
        self.placement = placement
        self.allocation = allocation
        self.epoch_hook = epoch_hook
        self.cluster = ClusterState(sc["nodes"], sc["instances"],
                                    sc["placement"], sc["transport_delay"])
        # replica sets as int arrays: route_ai is one vectorized argmin
        self.service_sids: Dict[str, np.ndarray] = {
            k: np.asarray(v, np.int64)
            for k, v in sc["service_sids"].items()}
        self.ran_packet = sc["ran_packet_delay"]
        self.delta = sc["transport_delay"]

        # bulk heap construction: heapify is O(n) vs n pushes O(n log n).
        # Static entries keep a deterministic pop order on time ties via
        # tuple seqs — epochs (0, k) < arrivals (1, emit_idx) < outages
        # (2, j) < dynamic pushes (3, counter) — exactly the order the
        # legacy int seq produced, but independent of WHEN an arrival is
        # heap-pushed (the streamed ≡ materialized invariant).
        entries: List[Tuple[float, Tuple[int, int], str, object]] = []
        # horizon from stream metadata (analytic for generated streams;
        # ListStream falls back to the legacy max-arrival scan)
        horizon = self.stream.horizon
        n_epochs = int(horizon / epoch_interval) + 3
        for k in range(1, n_epochs):
            entries.append((k * epoch_interval, (0, k), "epoch", k))
        # node availability windows (scenario fault injection): everything
        # resident on the node at t0 goes dark until t1
        for j, (node, t0, t1) in enumerate(sc.get("outages", ())):
            entries.append((float(t0), (2, j), "outage",
                            (int(node), float(t1))))
        # spot churn: preemption notice (varuna-style advance warning) +
        # departure per event; the rejoin is pushed at depart time so
        # back-to-back schedules keep a deterministic heap order.  Seqs
        # continue the outage tier (2, ·).
        fseq = len(sc.get("outages", ()))
        for ev in sc.get("churn", ()):
            node = int(ev["node"])
            depart = float(ev["depart"])
            notice = float(ev.get("notice", depart))
            if notice < depart:
                entries.append((notice, (2, fseq), "preempt_notice",
                                (node, depart)))
                fseq += 1
            entries.append((depart, (2, fseq), "node_depart",
                            (node, float(ev["rejoin"]),
                             float(ev.get("scale", 0.0)))))
            fseq += 1
        self._load_chunk(entries)     # first window rides the O(n) heapify
        heapq.heapify(entries)
        self.heap = entries
        self.seq = 0
        self.refill()                 # top may still be past the frontier

        self.dropped: set = set()
        self.migrations: List[Tuple[float, MigrationAction]] = []
        self.epochs: List[EpochRecord] = []
        self.rr_counter = [0] if rr_dispatch else None
        # per-interval outcome accumulators (for the critic label r_k)
        self.win = {RequestClass.LARGE_AI: [0, 0],
                    RequestClass.SMALL_AI: [0, 0],
                    RequestClass.RAN: [0, 0]}
        self.arrivals_win: Dict[str, int] = {}
        self.current_rec: Optional[EpochRecord] = None

        self.t = 0.0
        self.n_events = 0
        self.truncated = False
        self.done = False
        # spot-churn state: nodes currently departed/flapped, the node set
        # holding an autoscaler boost, per-reason degraded-decision counts
        self.n_down = 0
        self.boost_nodes: List[int] = []
        self.degraded: Dict[str, int] = {}
        # observability hooks (attached by the run loops; None = off, and
        # every instrumentation site below is an ``is not None`` guard
        # that only READS simulation state — the bit-identity contract)
        self.trace = None
        self.metrics = None
        self.b = 0
        # epoch boundary reached this event: (k, snapshot) awaiting the
        # placement decision (dispatched by the run loop, possibly batched)
        self.pending_epoch: Optional[Tuple[int, EpochSnapshot]] = None
        allocation.allocate(self.cluster, self.t)
        self.dirty: set = set()
        self.last_full = 0.0

    # ------------------------------------------------------------------ #
    def _load_chunk(self, into: Optional[List] = None) -> None:
        """Pull ONE chunk off the stream into the heap (or ``into`` list).

        Advances the arrival frontier ``loaded_until`` to the chunk's last
        arrival; exhaustion pins it to +inf.  Arrival seqs are the global
        emit index, so heap tie-breaking is identical no matter how the
        stream is chunked or when a chunk lands.
        """
        chunk = next(self._chunks, None)
        if chunk is None:
            self.stream_done = True
            self.loaded_until = INF
            return
        heap = self.heap if into is None else None
        for r in chunk:
            if r.cls == RequestClass.RAN:
                entry = (r.arrival, (1, self._emit_idx), "du", r)
            else:
                entry = (r.arrival + self.ran_packet,
                         (1, self._emit_idx), "ai_route", r)
            if heap is None:
                into.append(entry)
            else:
                heapq.heappush(heap, entry)
            self._emit_idx += 1
            self.emitted[r.cls] += 1
        if chunk:
            self.loaded_until = chunk[-1].arrival
            if self.retain_requests:
                self.requests.extend(chunk)

    def refill(self) -> None:
        """Load chunks until the heap's next event precedes the frontier.

        Invariant: any unloaded request arrives at or after
        ``loaded_until``, and its event time is >= its arrival — so once
        the heap top is strictly below the frontier, no unloaded entry
        can pop earlier.  ``>=`` (not ``>``) keeps pulling through exact
        arrival ties split across a chunk boundary.
        """
        heap = self.heap
        while not self.stream_done and \
                (heap[0][0] if heap else INF) >= self.loaded_until:
            self._load_chunk()

    def drain_stream(self) -> None:
        """Account (and retain, if configured) every unloaded request.

        Called once at ``result()``: a truncated or drained run still
        reports exact per-class totals — requests the engine never saw
        are violations, same as the legacy full-list scan counted them.
        """
        if self.stream_done:
            return
        for chunk in self._chunks:
            for r in chunk:
                self.emitted[r.cls] += 1
            if self.retain_requests:
                self.requests.extend(chunk)
        self.stream_done = True
        self.loaded_until = INF

    def push(self, t: float, kind: str, payload) -> None:
        heapq.heappush(self.heap, (t, (3, self.seq), kind, payload))
        self.seq += 1

    def mark(self, sid: int) -> None:
        self.dirty.add(int(self.cluster.placement[sid]))

    def record_outcome(self, req: Request, ok: bool) -> None:
        w = self.win[req.cls]
        w[0] += int(ok)
        w[1] += 1
        tot = self.totals[req.cls]
        tot[0] += int(ok)
        tot[1] += 1
        if self.metrics is not None:
            self.metrics.record_outcome(self.b, _CLS_CODE[req.cls], ok)

    def finish_request(self, req: Request, t: float) -> None:
        req.finish = t
        ok = req.fulfilled()
        self.record_outcome(req, ok)
        if self.trace is not None:
            self.trace.emit(_obs.COMPLETION, t, self.b, req.rid,
                            _CLS_CODE[req.cls], float(ok))

    def drop_request(self, req: Request) -> None:
        self.dropped.add(req.rid)
        self.record_outcome(req, False)
        if self.trace is not None:
            self.trace.emit(_obs.DROP, self.t, self.b, req.rid,
                            _CLS_CODE[req.cls])

    def cleanup_drops(self) -> None:
        if not self.drop_expired:
            return
        cluster, t = self.cluster, self.t
        expired = (cluster.head_mask & ~cluster.head_started
                   & (cluster.head_deadline <= t))
        for sid in np.nonzero(expired)[0]:
            while (cluster.head_mask[sid]
                   and not cluster.head_started[sid]
                   and cluster.head_deadline[sid] <= t):
                job = cluster.pop_job(sid)
                self.drop_request(job.req)
                self.mark(sid)

    def handle_completion(self, sid: int) -> None:
        cluster, t = self.cluster, self.t
        job = cluster.pop_job(sid)
        job.rem_g = job.rem_c = 0.0
        req = job.req
        inst = cluster.instances[sid]
        if inst.category == InstanceCategory.DU:
            # RAN chain: DU done -> transport -> CU-UP
            cu_sid = cluster.cuup_of(req.cell)
            hops = cluster.hops(cluster.placement[sid],
                                cluster.placement[cu_sid])
            self.push(t + hops * self.delta, "cuup", req)
        elif inst.category == InstanceCategory.CUUP:
            self.finish_request(req, t)
            cluster.observe_cuup_time(req.cell, t - req.stage_entered)
        else:                                   # AI service done
            self.finish_request(req, t)

    def build_snapshot(self, epoch: int) -> EpochSnapshot:
        cluster, t = self.cluster, self.t
        util = cluster.utilization(t)
        fl = {}
        for cls, w in self.win.items():
            fl[cls.value] = (w[0] / w[1]) if w[1] else 1.0
        rates = {k: v / self.epoch_interval
                 for k, v in self.arrivals_win.items()}
        return EpochSnapshot(
            t=t, epoch=epoch, nodes=cluster.nodes,
            instances=cluster.instances,
            placement=cluster.placement.copy(),
            reconfig_until=cluster.reconfig_until.copy(),
            gpu_util=util["gpu_util"], cpu_util=util["cpu_util"],
            ran_floor_g=util["ran_floor_g"],
            ran_floor_c=util["ran_floor_c"],
            vram_used=util["vram_used"],
            vram_headroom=util["vram_headroom"],
            queue_len=util["queue_len"], psi_g=util["psi_g"],
            psi_c=util["psi_c"], omega=util["omega"],
            alloc_g=cluster.alloc_g.copy(),
            alloc_c=cluster.alloc_c.copy(),
            kv_held=cluster.kv_active_vec(),
            recent_fulfill=fl, arrival_rate=rates,
            node_scale=cluster.node_scale.copy(),
            drain_until=cluster.node_drain_until.copy())

    def close_epoch_window(self, rec: Optional[EpochRecord]) -> None:
        win = self.win
        if rec is not None:
            counts = (win[RequestClass.LARGE_AI][1],
                      win[RequestClass.SMALL_AI][1],
                      win[RequestClass.RAN][1])
            rec.fulfill = tuple(
                (win[c][0] / win[c][1]) if win[c][1] else 1.0
                for c in (RequestClass.LARGE_AI, RequestClass.SMALL_AI,
                          RequestClass.RAN))
            rec.counts = counts
            if self.trace is not None:
                total = sum(counts)
                ok = sum(w[0] for w in win.values())
                self.trace.close_decision(self.b, rec.epoch, {
                    "realized_fulfill": (ok / total) if total else 1.0,
                    "realized": {"large_ai": rec.fulfill[0],
                                 "small_ai": rec.fulfill[1],
                                 "ran": rec.fulfill[2]},
                    "window_counts": {"large_ai": counts[0],
                                      "small_ai": counts[1],
                                      "ran": counts[2]},
                })
        for w in win.values():
            w[0] = w[1] = 0
        self.arrivals_win.clear()

    def handle_timed(self) -> None:
        """Pop and dispatch the earliest heap event (arrivals, epochs,
        stage hand-offs, outages, migration completions)."""
        cluster, t, sc = self.cluster, self.t, self.sc
        _, _, kind, payload = heapq.heappop(self.heap)
        if kind == "du":
            req: Request = payload
            sid = cluster.du_of(req.cell)
            cluster.push_job(sid, Job(
                req=req, rem_g=max(req.du_work_g, 1.0),
                rem_c=max(req.du_work_c, 0.0),
                abs_deadline=req.arrival + req.deadline))
            self.arrivals_win["ran"] = self.arrivals_win.get("ran", 0) + 1
            self.mark(sid)
            if self.trace is not None:
                self.trace.emit(_obs.ARRIVAL, t, self.b, req.rid,
                                _CLS_CODE[req.cls])
        elif kind == "cuup":
            req = payload
            sid = cluster.cuup_of(req.cell)
            req.stage_entered = t
            cluster.push_job(sid, Job(
                req=req, rem_g=0.0,
                rem_c=max(req.cuup_work_c, 1e-9),
                abs_deadline=req.arrival + req.deadline))
            self.mark(sid)
        elif kind == "ai_route":
            req = payload
            sids = self.service_sids[req.service]
            sid = cluster.route_ai(sids, t, self.rr_counter)
            req.target_sid = sid
            # transport: DU node -> AI node hops
            du_node = cluster.placement[cluster.du_of(req.cell)]
            ai_node = cluster.placement[sid]
            hops = cluster.hops(du_node, ai_node)
            self.push(t + hops * self.delta, "ai_enqueue", (req, sid))
            self.arrivals_win[req.service] = \
                self.arrivals_win.get(req.service, 0) + 1
            if self.trace is not None:
                self.trace.emit(_obs.ARRIVAL, t, self.b, req.rid,
                                _CLS_CODE[req.cls])
        elif kind == "ai_enqueue":
            req, sid = payload
            req.stage_entered = t
            cluster.push_job(sid, Job(
                req=req, rem_g=max(req.ai_work_g, 1.0),
                rem_c=max(req.ai_work_c, 0.0),
                abs_deadline=req.arrival + req.deadline,
                kv_bytes=req.kv_bytes))
            self.mark(sid)
        elif kind == "epoch":
            # the decision is the run loop's: it collects every replica that
            # reached an epoch boundary this tick and dispatches one
            # (possibly batched) decide, then calls commit_epoch
            k: int = payload
            self.close_epoch_window(self.current_rec)
            self.pending_epoch = (k, self.build_snapshot(k))
        elif kind == "mig_done":
            self.mark(payload)   # availability flip triggers realloc
        elif kind == "outage":
            node, until = payload
            for sid in range(cluster.S):
                if cluster.placement[sid] == node:
                    cluster.reconfig_until[sid] = max(
                        cluster.reconfig_until[sid], until)
                    self.mark(sid)
            self.push(until, "outage_end", node)
        elif kind == "outage_end":
            for sid in range(cluster.S):
                if cluster.placement[sid] == payload:
                    self.mark(sid)   # back online: trigger realloc
        elif kind == "preempt_notice":
            # advance preemption warning: the node keeps serving until the
            # departure, but snapshots see it draining — the agentic layer
            # can evacuate proactively, and such moves count as forced
            node, depart = payload
            cluster.node_drain_until[node] = depart
        elif kind == "node_depart":
            node, rejoin, scale = payload
            cluster.set_node_scale(node, scale)
            cluster.node_drain_until[node] = 0.0
            self.n_down += 1
            if scale <= 0.0:
                # full preemption: resident instances go dark until the
                # node rejoins (same mechanism as scenario outages)
                for sid in range(cluster.S):
                    if cluster.placement[sid] == node:
                        cluster.reconfig_until[sid] = max(
                            cluster.reconfig_until[sid], rejoin)
                        self.mark(sid)
            else:
                self.dirty.add(node)     # capacity flap: just re-solve
            self.push(rejoin, "node_rejoin", node)
            asc = sc.get("autoscale")
            if asc is not None:
                # autoscaler hook: scale-out reacts after its lag
                self.push(t + float(asc.get("lag_s", 10.0)),
                          "scale_out", node)
            if self.trace is not None:
                self.trace.emit(_obs.NODE_DOWN, t, self.b, node, 0, scale)
        elif kind == "node_rejoin":
            node = payload
            cluster.set_node_scale(node, 1.0)
            cluster.node_drain_until[node] = 0.0
            self.n_down -= 1
            self.dirty.add(node)
            for sid in range(cluster.S):
                if cluster.placement[sid] == node:
                    self.mark(sid)       # back online: trigger realloc
            asc = sc.get("autoscale")
            if asc is not None and self.n_down == 0 and self.boost_nodes:
                # scale-in: boosted nodes drain for drain_s, then revert
                drain_s = float(asc.get("drain_s", 5.0))
                for m in self.boost_nodes:
                    cluster.node_drain_until[m] = t + drain_s
                self.push(t + drain_s, "scale_in", tuple(self.boost_nodes))
                self.boost_nodes = []
            if self.trace is not None:
                self.trace.emit(_obs.NODE_UP, t, self.b, node)
        elif kind == "scale_out":
            asc = sc.get("autoscale") or {}
            if self.n_down > 0 and not self.boost_nodes:
                # the departed node is still gone: surviving full-capacity
                # nodes take the elastic boost
                boost = float(asc.get("boost", 1.25))
                for m in range(cluster.N):
                    if cluster.node_scale[m] == 1.0:
                        cluster.set_node_scale(m, boost)
                        self.boost_nodes.append(m)
                        self.dirty.add(m)
        elif kind == "scale_in":
            asc = sc.get("autoscale") or {}
            boost = float(asc.get("boost", 1.25))
            for m in payload:
                if cluster.node_scale[m] == boost:
                    cluster.set_node_scale(m, 1.0)
                    self.dirty.add(m)
                if cluster.node_drain_until[m] <= t:
                    cluster.node_drain_until[m] = 0.0

    def commit_epoch(self, k: int, snap: EpochSnapshot,
                     action: Optional[MigrationAction]) -> None:
        """Apply the placement decision for epoch ``k`` (Eq. 12 commit).

        Runs exactly the post-decide tail the epoch event used to handle
        inline: feasibility gate, migration apply + reconfiguration window
        (outage-aware), EpochRecord bookkeeping, hook, full-realloc mark.
        """
        cluster, t, sc = self.cluster, self.t, self.sc
        shortlist = getattr(self.placement, "last_shortlist", [])
        decided = action                       # pre-feasibility-gate choice
        if action is not None:
            ok = (cluster.migration_feasible(action)
                  and cluster.available(action.sid, t))
            if ok:
                inst = cluster.instances[action.sid]
                # forced = evacuating a draining or already-degraded node
                # (preemption-driven); elective = rebalancing a healthy one
                forced = bool(t < cluster.node_drain_until[action.src]
                              or cluster.node_scale[action.src] < 1.0)
                committed = CommittedMigration(
                    sid=action.sid, src=action.src,
                    dst=action.dst, category=inst.category, forced=forced)
                cluster.apply_migration(committed, t)
                until = t + inst.reconfig_s
                if forced:
                    # riding the advance notice makes the interruption
                    # cheaper than an elective move (Eq. 12 cost split)
                    until = t + inst.reconfig_s * float(
                        sc.get("forced_reconfig_factor", 1.0))
                # landing on a node mid-outage (or mid-preemption): the
                # instance stays dark until the node itself returns
                for node, o0, o1 in sc.get("outages", ()):
                    if int(node) == action.dst and o0 <= t < o1:
                        until = max(until, float(o1))
                for ev in sc.get("churn", ()):
                    if int(ev["node"]) == action.dst \
                            and float(ev.get("scale", 0.0)) <= 0.0 \
                            and float(ev["depart"]) <= t < float(ev["rejoin"]):
                        until = max(until, float(ev["rejoin"]))
                cluster.reconfig_until[action.sid] = until
                self.migrations.append((t, committed))
                self.push(until, "mig_done", action.sid)
                if self.trace is not None:
                    self.trace.emit(_obs.MIGRATION, t, self.b, action.sid,
                                    action.dst, float(action.src))
            else:
                action = None
        # degradation-ladder accounting: the policy marks a decision that
        # fell back (LLM crash/timeout/malformed shortlist) on itself
        reason = getattr(self.placement, "last_degraded", None)
        if reason is not None:
            self.degraded[reason] = self.degraded.get(reason, 0) + 1
            if self.trace is not None:
                self.trace.emit(_obs.DEGRADED, t, self.b, k,
                                _obs.degraded_code(reason))
        if self.trace is not None:
            self.trace.emit(_obs.EPOCH, t, self.b, k, len(shortlist),
                            float(action is not None))
            scores = getattr(self.placement, "last_scores", None)
            self.trace.decision(self.b, k, {
                "t": t,
                "action": (None if decided is None else
                           {"sid": decided.sid, "src": decided.src,
                            "dst": decided.dst}),
                "committed": action is not None,
                "shortlist": [{"sid": a.sid, "src": a.src, "dst": a.dst}
                              for a in shortlist],
                "scores": (None if scores is None else
                           [float(x) for x in scores]),
                "predicted_margin": getattr(self.placement, "last_margin",
                                            None),
                "degraded": reason,
            })
        self.current_rec = EpochRecord(
            epoch=k, t=t, snapshot=snap, action=action,
            shortlist=list(shortlist))
        self.epochs.append(self.current_rec)
        if self.epoch_hook is not None:
            self.epoch_hook(self.current_rec, cluster)
        self.pending_epoch = None
        self.dirty.update(range(cluster.N))

    def realloc_nodes(self):
        """Post-event reallocation scope: ``None`` = full re-solve,
        a list = just those nodes, ``()`` = nothing to do."""
        if self.t - self.last_full >= REALLOC_REFRESH \
                or len(self.dirty) >= self.cluster.N:
            self.last_full = self.t
            self.dirty.clear()
            return None
        if self.dirty:
            nodes = sorted(self.dirty)
            self.dirty.clear()
            return nodes
        return ()

    def _class_counts(self) -> Dict[str, Tuple[int, int]]:
        """(n, violations) per class from the streaming accumulators.

        n counts every emitted request; violations = n − fulfilled, which
        folds in both recorded misses AND requests that never completed
        (in flight at truncation, stalled, or never loaded) — exactly
        what the legacy scan over a retained request list computed.
        """
        per = {cls: (self.emitted[cls], self.emitted[cls] - tot[0])
               for cls, tot in self.totals.items()}
        la, sa = per[RequestClass.LARGE_AI], per[RequestClass.SMALL_AI]
        ran = per[RequestClass.RAN]
        ai = (la[0] + sa[0], la[1] + sa[1])
        return {"overall": (ai[0] + ran[0], ai[1] + ran[1]), "ran": ran,
                "ai": ai, "large_ai": la, "small_ai": sa}

    def result(self, wall_s: float = 0.0, engine: str = "",
               observer=None) -> SimResult:
        self.close_epoch_window(self.current_rec)
        self.drain_stream()
        res = SimResult(requests=self.requests, dropped=self.dropped,
                        migrations=self.migrations, epochs=self.epochs,
                        infeasible_events=self.cluster.infeasible_events,
                        n_events=self.n_events, truncated=self.truncated,
                        wall_s=wall_s, engine=engine,
                        counts_by_class=self._class_counts(),
                        degraded=dict(self.degraded) if self.degraded
                        else None)
        if observer is not None:
            if observer.profiler is not None:
                res.profile = observer.profiler.report()
            if observer.metrics is not None:
                res.timeseries = observer.metrics.series(self.b)
            res.trace = observer.trace
        return res


def dispatch_epoch_decisions(reps: Sequence[_Replica]) -> None:
    """Decide + commit the pending epoch of every given replica.

    The slow-timescale analogue of the ``[B, S]`` event step: policies
    exposing ``batch_key()`` / ``decide_group()`` and sharing a key are
    decided by ONE batched call (HAF stacks candidate features and runs
    the critic once for the whole group); everything else — plain
    baselines, scripted policies, LLM-backed agents keyed per instance —
    falls back to per-replica ``decide``.  Grouping must not change
    outcomes: ``decide_group`` is batch-shape invariant and ``decide`` is
    its B=1 view, so a replica's committed action is identical however
    its epoch boundary lands in a batch.
    """
    items = [(rep,) + rep.pending_epoch for rep in reps]
    actions: List[Optional[MigrationAction]] = [None] * len(items)
    groups: Dict[tuple, List[int]] = {}
    for i, (rep, k, snap) in enumerate(items):
        pol = rep.placement
        key = None
        key_fn = getattr(pol, "batch_key", None)
        if key_fn is not None and hasattr(type(pol), "decide_group"):
            key = key_fn()
        if key is None:
            actions[i] = pol.decide(snap)
        else:
            groups.setdefault((type(pol), key), []).append(i)
    for (pol_cls, _), idxs in groups.items():
        decided = pol_cls.decide_group(
            [items[i][0].placement for i in idxs],
            [items[i][2] for i in idxs])
        for i, action in zip(idxs, decided):
            actions[i] = action
    for (rep, k, snap), action in zip(items, actions):
        rep.commit_epoch(k, snap, action)


def _realize_policies(spec, B: int, what: str) -> List:
    """A per-replica policy list from a list OR a factory ``f(b) -> policy``.

    Policy objects are stateful, so a batch needs one instance per replica;
    the factory form makes that explicit at the call site."""
    if callable(spec) and not isinstance(spec, (list, tuple)):
        return [spec(b) for b in range(B)]
    out = list(spec)
    if len(out) != B:
        raise ValueError(
            f"run_batch needs one {what} per replica: got {len(out)} "
            f"for {B} workloads (or pass a factory f(b) -> policy)")
    return out


class Simulator:
    def __init__(self, scenario: Dict, epoch_interval: float = 5.0,
                 drop_expired: bool = False, seed: int = 0,
                 engine: Optional[str] = None, obs=None,
                 device="cuda"):
        """``engine=None`` is ``"cuda"``: ``run_batch`` and solo ``run``
        (a one-replica ``run_batch``) on ``device`` through the
        hand-written kernel core.  ``engine="torch"`` is the eager float64
        torch core on ``device``; ``engine="numpy"`` / ``"scalar"`` are the
        host engines and ignore ``device``.  A CUDA ``device`` that is not
        available raises ``RuntimeError`` for the device engines — nothing
        carries on on the CPU by itself."""
        self.scenario = scenario
        self.epoch_interval = epoch_interval
        self.drop_expired = drop_expired
        self.seed = seed
        self.engine = engine
        self.device = device
        # default observability for this simulator's runs: an ObsConfig /
        # RunObserver, or None (off — the hot path is then bit-identical
        # to the uninstrumented engine).  run()/run_batch() can override.
        self.obs = obs
        # fail fast on unknown names and on a device that is not there;
        # "cuda" is a batched core only (run() takes it as a block of one)
        if engine is None or engine == "cuda":
            make_batched_event_core("cuda", device)
        else:
            make_event_core(engine, device)

    # ------------------------------------------------------------------ #
    def run(self, requests,
            placement: PlacementPolicy,
            allocation: AllocationPolicy,
            rr_dispatch: bool = False,
            max_events: int = 5_000_000,
            epoch_hook: Optional[Callable] = None,
            retain_requests: bool = True,
            obs=None) -> SimResult:
        """Run one trace.  ``requests`` is a list OR an ArrivalStream;
        ``retain_requests=False`` drops the per-request list from the
        result (summaries come from the streaming accumulators) — with a
        windowed stream the whole run is then O(S + window) memory.

        On ``engine=None`` / ``"cuda"`` the trace runs as a one-replica
        :meth:`run_batch` (solo ≡ batched): one ``event_step`` launch a
        tick."""
        if self.engine is None or self.engine == "cuda":
            return self.run_batch(
                [requests], [placement], [allocation],
                rr_dispatch=rr_dispatch, max_events=max_events,
                epoch_hooks=[epoch_hook], engine="cuda",
                retain_requests=retain_requests, obs=obs)[0]
        engine_name = self.engine
        observer = _obs.make_observer(obs if obs is not None else self.obs,
                                      B=1, engine=engine_name)
        rep = _Replica(self.scenario, self.epoch_interval, self.drop_expired,
                       requests, placement, allocation, rr_dispatch,
                       epoch_hook, retain_requests=retain_requests)
        # per-run core: the numpy backend carries mutable scratch + a
        # prepare cache, so sharing one across overlapping runs (threads,
        # nested runs from an epoch_hook) would cross-contaminate state
        core = make_event_core(engine_name, self.device)
        cluster = rep.cluster
        heap = rep.heap
        prof = metrics = None
        if observer is not None:
            rep.trace = observer.trace
            rep.metrics = metrics = observer.metrics
            cluster.trace = observer.trace
            prof = observer.profiler
            core.profiler = prof
            if prof is not None:
                _obs.push_profiler(prof)
        wall_t0 = perf_counter()

        # single loop over timed events AND queue completions: it must keep
        # draining after the heap empties (a stage completion can push the
        # next stage — e.g. DU -> CU-UP — or work may resume after an
        # outage/reconfiguration ends)
        try:
            while True:
                if not rep.stream_done:
                    rep.refill()    # windowed heap refill (no-op once drained)
                if prof is not None:
                    _t0 = perf_counter()
                t_comp, sid_comp = core.next_completion(cluster, rep.t)
                t_ev = heap[0][0] if heap else INF
                t_next = min(t_comp, t_ev)
                if not math.isfinite(t_next):
                    break
                if rep.n_events >= max_events:
                    rep.truncated = True
                    break
                core.advance(cluster, rep.t, t_next - rep.t)
                rep.t = t_next
                rep.n_events += 1
                if prof is not None:
                    prof.add("engine.step", perf_counter() - _t0)
                    _t0 = perf_counter()

                if t_comp <= t_ev:
                    rep.mark(sid_comp)
                    rep.handle_completion(sid_comp)
                    pending = False
                else:
                    rep.handle_timed()
                    pending = rep.pending_epoch is not None
                if prof is not None:
                    prof.add("engine.events", perf_counter() - _t0)
                if pending:
                    if prof is not None:
                        _t0 = perf_counter()
                    dispatch_epoch_decisions((rep,))
                    if prof is not None:
                        prof.add("epoch.decide", perf_counter() - _t0)

                rep.cleanup_drops()
                nodes = rep.realloc_nodes()
                if nodes is None or nodes:
                    if prof is not None:
                        _t0 = perf_counter()
                    if nodes is None:
                        allocation.allocate(cluster, rep.t)
                    else:
                        allocation.allocate(cluster, rep.t, nodes)
                    if prof is not None:
                        prof.add("allocator.solve", perf_counter() - _t0)
                if metrics is not None:
                    metrics.maybe_sample(0, rep.t, cluster)
        finally:
            if prof is not None:
                _obs.pop_profiler(prof)
            core.profiler = None

        wall = perf_counter() - wall_t0
        if prof is not None:
            prof.add("run", wall)
        if metrics is not None:
            metrics.finalize(0, rep.t, cluster)
        return rep.result(wall_s=wall, engine=engine_name,
                          observer=observer)

    # ------------------------------------------------------------------ #
    def run_batch(self, workloads: Sequence[List[Request]],
                  placements,
                  allocations,
                  rr_dispatch: bool = False,
                  max_events: int = 5_000_000,
                  epoch_hooks: Optional[Sequence[Optional[Callable]]] = None,
                  engine: Optional[str] = None,
                  retain_requests: bool = True,
                  obs=None) -> List[SimResult]:
        """Advance B independent replicas of this scenario in lockstep.

        ``workloads[b]`` / ``placements[b]`` / ``allocations[b]`` belong to
        replica ``b`` (policy objects are stateful — pass one instance per
        replica, or a factory ``f(b) -> policy`` and one is built per
        replica).  The per-event hot pair runs once per tick over the
        whole ``[B, S]`` block; event handling, heaps, and epoch logic
        stay per-replica — except the slow-timescale decision itself:
        every replica whose event this tick is an epoch boundary joins
        ONE (possibly grouped) :func:`dispatch_epoch_decisions` call, so
        compatible agentic policies batch their candidate features and
        critic forward instead of paying B Python callbacks.  Every
        replica's discrete outcome is identical to a solo ``run`` with
        the same seed.  ``engine`` overrides the batched core
        (``numpy | scalar | torch | cuda``); the default reuses the
        simulator's engine name, and a simulator built with
        ``engine=None`` uses ``"cuda"``.
        """
        B = len(workloads)
        placements = _realize_policies(placements, B, "placement")
        allocations = _realize_policies(allocations, B, "allocation")
        if epoch_hooks is not None and len(epoch_hooks) != B:
            raise ValueError(
                f"run_batch needs one epoch_hook per replica when given: "
                f"got {len(epoch_hooks)} for {B} workloads")
        hooks = epoch_hooks if epoch_hooks is not None else [None] * B
        reps = [_Replica(self.scenario, self.epoch_interval,
                         self.drop_expired, workloads[b], placements[b],
                         allocations[b], rr_dispatch, hooks[b],
                         retain_requests=retain_requests)
                for b in range(B)]
        block = ClusterBlock([rep.cluster for rep in reps])
        engine_name = engine or self.engine or "cuda"
        core = make_batched_event_core(engine_name, self.device)
        observer = _obs.make_observer(obs if obs is not None else self.obs,
                                      B=B, engine=engine_name)
        prof = metrics = None
        if observer is not None:
            prof = observer.profiler
            metrics = observer.metrics
            core.profiler = prof
            for b, rep in enumerate(reps):
                rep.trace = observer.trace
                rep.metrics = metrics
                rep.b = b
                rep.cluster.trace = observer.trace
                rep.cluster.trace_b = b
            if prof is not None:
                _obs.push_profiler(prof)
        # the cross-replica allocation gather is exact only for the
        # paper's allocator; other policies re-solve per replica (the
        # same code path a solo run uses)
        fast_alloc = all(type(a) is DeadlineAwareAllocation
                         for a in allocations)

        t_vec = np.zeros(B)
        t_ev = np.array([rep.heap[0][0] if rep.heap else INF
                         for rep in reps])
        can_step = np.zeros(B, bool)
        n_live = B
        node_lists: List = [()] * B
        state = {"any_alloc": False}

        def settle(b: int, rep: _Replica) -> None:
            """Post-event tail of one replica: drops, realloc scope, next
            event time.  Runs right after the event for ordinary events,
            or after the batched decide for epoch boundaries — either way
            at the same point of the replica's own event order."""
            rep.cleanup_drops()
            nodes = rep.realloc_nodes()
            if nodes == ():
                pass
            elif fast_alloc:
                node_lists[b] = nodes          # None = full re-solve
                state["any_alloc"] = True
            else:
                if prof is not None:
                    _t0 = perf_counter()
                if nodes is None:
                    rep.allocation.allocate(rep.cluster, rep.t)
                else:
                    rep.allocation.allocate(rep.cluster, rep.t, nodes)
                if prof is not None:
                    prof.add("allocator.solve", perf_counter() - _t0)
            t_ev[b] = rep.heap[0][0] if rep.heap else INF

        wall_t0 = perf_counter()
        try:
            while n_live:
                if prof is not None:
                    _ts = perf_counter()
                for b, rep in enumerate(reps):
                    # per-replica stream cursor: pull the next window(s)
                    # before the fused compute+advance step reads t_ev —
                    # once the frontier passes the heap top, no unloaded
                    # arrival can precede it (host-scalar check only)
                    if not rep.stream_done and not rep.done \
                            and t_ev[b] >= rep.loaded_until:
                        rep.refill()
                        t_ev[b] = rep.heap[0][0] if rep.heap else INF
                    can_step[b] = not rep.done and rep.n_events < max_events
                t_comp, sids = core.step(block, t_vec, t_ev, can_step)
                t_next = np.minimum(t_comp, t_ev)
                finite = np.isfinite(t_next)
                np.copyto(t_vec, t_next, where=can_step & finite)
                if prof is not None:
                    prof.add("engine.step", perf_counter() - _ts)
                    _ts = perf_counter()

                state["any_alloc"] = False
                at_epoch: List[int] = []
                for b, rep in enumerate(reps):
                    node_lists[b] = ()
                    if rep.done:
                        continue
                    if not finite[b]:
                        rep.done = True        # drained: clean end
                        n_live -= 1
                        continue
                    if not can_step[b]:
                        rep.truncated = True   # finite work left at budget
                        rep.done = True
                        n_live -= 1
                        continue
                    rep.t = float(t_next[b])
                    rep.n_events += 1
                    if t_comp[b] <= t_ev[b]:
                        sid = int(sids[b])
                        rep.mark(sid)
                        rep.handle_completion(sid)
                    else:
                        rep.handle_timed()
                        if rep.pending_epoch is not None:
                            at_epoch.append(b)  # decide after the sweep
                            continue
                    settle(b, rep)
                if prof is not None:
                    prof.add("engine.events", perf_counter() - _ts)

                if at_epoch:
                    # one batched decide for every replica at an epoch
                    # boundary this tick, then their deferred settle
                    if prof is not None:
                        _ts = perf_counter()
                    dispatch_epoch_decisions([reps[b] for b in at_epoch])
                    for b in at_epoch:
                        settle(b, reps[b])
                    if prof is not None:
                        prof.add("epoch.decide", perf_counter() - _ts)
                if state["any_alloc"]:
                    if prof is not None:
                        _ts = perf_counter()
                    deadline_allocate_block(block, t_vec, node_lists)
                    if prof is not None:
                        prof.add("allocator.solve", perf_counter() - _ts)
                if metrics is not None:
                    for b, rep in enumerate(reps):
                        if not rep.done:
                            metrics.maybe_sample(b, rep.t, rep.cluster)
        finally:
            if prof is not None:
                _obs.pop_profiler(prof)
            core.profiler = None

        wall = perf_counter() - wall_t0
        if prof is not None:
            prof.add("run", wall)
        if metrics is not None:
            for b, rep in enumerate(reps):
                metrics.finalize(b, rep.t, rep.cluster)
        return [rep.result(wall_s=wall, engine=engine_name,
                           observer=observer) for rep in reps]
