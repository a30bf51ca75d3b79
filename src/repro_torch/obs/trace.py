"""Structured event tracing: a columnar, ring-buffer-backed recorder.

The hot path of the simulator emits one record per engine event
(arrival / completion / drop / migration / epoch / allocator solve) into
preallocated numpy columns — a ring buffer of ``capacity`` records, so a
multi-million-event run traces at bounded memory (the *oldest* records
are overwritten; exact per-kind totals are kept separately and always
reconcile with the run's ``SimResult`` counters, however far the ring
wrapped).  Slow-timescale agentic decisions (shortlist, critic scores,
predicted-vs-realized benefit) are rare and carry rich payloads, so they
live in a plain list of dicts alongside the columnar events.

Every record carries the replica tag ``b`` (0 for solo runs), so one
recorder serves a whole ``run_batch`` block and per-replica streams can
be pulled apart afterwards.

Exports:

  * :meth:`TraceRecorder.to_jsonl` — one JSON object per line, kinds
    spelled out, decisions interleaved at their timestamps,
  * :meth:`TraceRecorder.to_chrome` — Chrome ``trace_event`` JSON for
    ``chrome://tracing`` / Perfetto: each replica is a ``pid``, each
    event kind a ``tid``, sim-time seconds mapped to microseconds.

The recorder never imports the simulator: callers pass small ints (the
request-class codes below) so the dependency points one way.
"""
from __future__ import annotations

import json
import pathlib
from typing import Dict, List, Optional

import numpy as np

# event kind codes (the ``kind`` column)
ARRIVAL = 0
COMPLETION = 1
DROP = 2
MIGRATION = 3
EPOCH = 4
ALLOC = 5
NODE_DOWN = 6                       # spot churn: a node departed/flapped
NODE_UP = 7                         # spot churn: the node rejoined
DEGRADED = 8                        # a decision fell down the degradation
                                    # ladder (LLM failure / critic loss /
                                    # batch-group fallback)

KIND_NAMES = ("arrival", "completion", "drop", "migration", "epoch", "alloc",
              "node_down", "node_up", "degraded")

# reason codes for DEGRADED records (the ``c`` column)
DEGRADED_NAMES = ("crash", "timeout", "malformed", "critic", "batch-fallback")


def degraded_code(reason: str) -> int:
    """Reason string -> DEGRADED ``c`` code (-1 for unknown reasons)."""
    try:
        return DEGRADED_NAMES.index(reason)
    except ValueError:
        return -1

# request-class codes (the ``c`` column of request-level records);
# mirrors repro_torch.sim.types.RequestClass without importing it
CLS_LARGE_AI = 0
CLS_SMALL_AI = 1
CLS_RAN = 2
CLS_NAMES = ("LARGE_AI", "SMALL_AI", "RAN")

DEFAULT_CAPACITY = 1 << 18          # 262144 records ≈ 6 MB of columns
MAX_DECISIONS = 100_000             # epoch decisions are ~1/epoch_interval


class TraceRecorder:
    """Columnar ring buffer of engine events + a list of rich decisions.

    Columns (all ``[capacity]``):

      ``kind``  int8   — event kind code (see module constants)
      ``t``     f8     — sim time (seconds)
      ``b``     int32  — replica tag (0 for solo runs)
      ``a``     int64  — kind-specific id: rid / sid / epoch / n_heads
      ``c``     int32  — kind-specific int: class code / dst node / iters
      ``v``     f8     — kind-specific value: ok flag / src node / n_problems
    """

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        if capacity < 1:
            raise ValueError("trace capacity must be >= 1")
        self.capacity = int(capacity)
        self.kind = np.zeros(self.capacity, np.int8)
        self.t = np.zeros(self.capacity)
        self.b = np.zeros(self.capacity, np.int32)
        self.a = np.zeros(self.capacity, np.int64)
        self.c = np.zeros(self.capacity, np.int32)
        self.v = np.zeros(self.capacity)
        self.n_written = 0                      # total emits (ring may wrap)
        # exact per-(kind, replica) totals — never lost to ring wrap
        self._counts: Dict[tuple, int] = {}
        self.decisions: List[Dict] = []
        self.decisions_dropped = 0
        self._open: Dict[tuple, Dict] = {}      # (b, epoch) -> open decision

    # ------------------------------------------------------------------ #
    # recording (the engine-facing hot path)
    # ------------------------------------------------------------------ #
    def emit(self, kind: int, t: float, b: int, a: int = 0,
             c: int = 0, v: float = 0.0) -> None:
        i = self.n_written % self.capacity
        self.kind[i] = kind
        self.t[i] = t
        self.b[i] = b
        self.a[i] = a
        self.c[i] = c
        self.v[i] = v
        self.n_written += 1
        key = (kind, b)
        self._counts[key] = self._counts.get(key, 0) + 1

    def decision(self, b: int, epoch: int, payload: Dict) -> None:
        """Record a slow-timescale placement decision (rich payload).

        The entry stays *open* until :meth:`close_decision` attaches the
        realized epoch-window outcome (the critic label r_k), pairing the
        predicted benefit with what actually happened.
        """
        if len(self.decisions) >= MAX_DECISIONS:
            self.decisions_dropped += 1
            return
        entry = dict(payload, b=int(b), epoch=int(epoch))
        self.decisions.append(entry)
        self._open[(int(b), int(epoch))] = entry

    def close_decision(self, b: int, epoch: int, realized: Dict) -> None:
        entry = self._open.pop((int(b), int(epoch)), None)
        if entry is not None:
            entry.update(realized)

    # ------------------------------------------------------------------ #
    # queries
    # ------------------------------------------------------------------ #
    def counts(self, b: Optional[int] = None) -> Dict[str, int]:
        """Exact per-kind totals (optionally for one replica).

        These are maintained outside the ring, so they reconcile with the
        run's ``SimResult`` counters even after the buffer wrapped.
        """
        out = {name: 0 for name in KIND_NAMES}
        for (kind, kb), n in self._counts.items():
            if b is None or kb == b:
                out[KIND_NAMES[kind]] += n
        out["decision"] = sum(1 for d in self.decisions
                              if b is None or d["b"] == b)
        return out

    @property
    def n_dropped(self) -> int:
        """Records overwritten by ring wrap (totals stay exact)."""
        return max(0, self.n_written - self.capacity)

    def _order(self) -> np.ndarray:
        """Live record indices, oldest first (ring-unwrap order)."""
        n = min(self.n_written, self.capacity)
        if self.n_written <= self.capacity:
            return np.arange(n)
        start = self.n_written % self.capacity
        return np.concatenate([np.arange(start, self.capacity),
                               np.arange(0, start)])

    def records(self) -> List[Dict]:
        """Live records as dicts, oldest first, kind-specific field names."""
        out = []
        for i in self._order():
            out.append(_record_dict(int(self.kind[i]), float(self.t[i]),
                                    int(self.b[i]), int(self.a[i]),
                                    int(self.c[i]), float(self.v[i])))
        return out

    # ------------------------------------------------------------------ #
    # export
    # ------------------------------------------------------------------ #
    def to_jsonl(self, path) -> pathlib.Path:
        """One JSON object per line: columnar events (oldest first) then
        the decision records (their own ``kind: "decision"``)."""
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        with path.open("w") as f:
            header = {"kind": "header", "n_written": self.n_written,
                      "n_dropped": self.n_dropped, "counts": self.counts()}
            f.write(json.dumps(header) + "\n")
            for rec in self.records():
                f.write(json.dumps(rec) + "\n")
            for d in self.decisions:
                f.write(json.dumps(_sanitize(dict(d, kind="decision"))) + "\n")
        return path

    def to_chrome(self, path) -> pathlib.Path:
        """Chrome ``trace_event`` JSON (open in chrome://tracing/Perfetto).

        Replica ``b`` maps to ``pid``, the event kind to ``tid``; sim time
        (seconds) maps to the format's microseconds.  All records are
        instant events (``ph: "i"``, thread scope) carrying their fields
        in ``args``; decisions ride along on a dedicated tid.
        """
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        events = []
        for rec in self.records():
            kind = rec.pop("kind")
            ev = {"name": kind, "ph": "i", "s": "t",
                  "ts": rec.pop("t") * 1e6,
                  "pid": rec.pop("b"), "tid": kind, "args": rec}
            events.append(ev)
        for d in self.decisions:
            d = _sanitize(dict(d))
            events.append({"name": "decision", "ph": "i", "s": "t",
                           "ts": float(d.pop("t", 0.0)) * 1e6,
                           "pid": d.pop("b"), "tid": "decision", "args": d})
        # stable sort: each replica's stream stays monotone in ts even
        # after decisions (appended above) interleave with ring events
        events.sort(key=lambda ev: (ev["pid"], ev["ts"]))
        doc = {"traceEvents": events, "displayTimeUnit": "ms",
               "otherData": {"source": "repro_torch.obs",
                             "n_dropped": self.n_dropped}}
        path.write_text(json.dumps(doc))
        return path


def _record_dict(kind: int, t: float, b: int, a: int, c: int,
                 v: float) -> Dict:
    base = {"kind": KIND_NAMES[kind], "t": t, "b": b}
    if kind in (ARRIVAL, COMPLETION, DROP):
        base["rid"] = a
        base["cls"] = CLS_NAMES[c] if 0 <= c < len(CLS_NAMES) else c
        if kind == COMPLETION:
            base["ok"] = bool(v)
    elif kind == MIGRATION:
        base.update(sid=a, dst=c, src=int(v))
    elif kind == EPOCH:
        base.update(epoch=a, n_candidates=c, committed=bool(v))
    elif kind == ALLOC:
        base.update(n_heads=a, iters=c, n_problems=int(v))
    elif kind == NODE_DOWN:
        base.update(node=a, scale=v)
    elif kind == NODE_UP:
        base.update(node=a)
    elif kind == DEGRADED:
        base.update(epoch=a,
                    reason=(DEGRADED_NAMES[c]
                            if 0 <= c < len(DEGRADED_NAMES) else c))
    return base


def _sanitize(obj):
    """Make decision payloads strict-JSON (numpy scalars, NaN, tuples)."""
    if isinstance(obj, dict):
        return {k: _sanitize(x) for k, x in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(x) for x in obj]
    if isinstance(obj, np.generic):
        obj = obj.item()
    if isinstance(obj, float) and obj != obj:
        return None
    return obj


def load_jsonl(path) -> Dict:
    """Parse a JSONL trace file back into ``{header, events, decisions}``."""
    header: Dict = {}
    events: List[Dict] = []
    decisions: List[Dict] = []
    with pathlib.Path(path).open() as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = json.loads(line)
            kind = rec.get("kind")
            if kind == "header":
                header = rec
            elif kind == "decision":
                decisions.append(rec)
            else:
                events.append(rec)
    return {"header": header, "events": events, "decisions": decisions}
