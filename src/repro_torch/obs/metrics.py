"""Time-series metrics: per-tick gauges sampled on a sim-time interval.

Each sample captures, per replica ``b``:

  * per-node GPU/CPU utilization (allocated share of capacity),
  * queue depth (jobs resident across all instances),
  * a deadline-slack histogram over busy queue heads (how close the
    in-flight work is to its deadlines — fixed log-spaced edges so
    histograms concatenate across runs),
  * cumulative per-class SLO fulfillment (ok / total), fed by the same
    ``record_outcome`` path that builds ``SimResult.requests`` — so the
    final sample reconciles *exactly* with ``summary()`` counts.

Sampling is driven from the engine's event loop: after each event the
engine calls :meth:`MetricsSampler.maybe_sample`, which emits one sample
per elapsed interval boundary (cheap float compare when it's not due).
A forced final sample at ``finalize`` guarantees the series ends at the
run's last event time.

Class codes are the plain ints from :mod:`repro_torch.obs.trace`
(LARGE_AI=0, SMALL_AI=1, RAN=2) — this module never imports the sim.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

# slack histogram edges (seconds): log-spaced, fixed so series concatenate
SLACK_EDGES = np.array([-np.inf, 0.0, 1e-3, 1e-2, 1e-1, 1.0, 10.0, np.inf])
N_CLASSES = 3
CLS_KEYS = ("large_ai", "small_ai", "ran")


class MetricsSampler:
    """Samples cluster gauges on a fixed sim-time interval, per replica."""

    def __init__(self, interval: float, B: int = 1):
        if interval <= 0:
            raise ValueError("metrics interval must be > 0")
        self.interval = float(interval)
        self.B = int(B)
        self._next_t = np.zeros(self.B)
        # cumulative [B, cls] outcome counters (ok, total)
        self._ok = np.zeros((self.B, N_CLASSES), np.int64)
        self._total = np.zeros((self.B, N_CLASSES), np.int64)
        self.samples: List[List[Dict]] = [[] for _ in range(self.B)]

    # ------------------------------------------------------------------ #
    # feeds (engine-facing)
    # ------------------------------------------------------------------ #
    def record_outcome(self, b: int, cls: int, ok: bool) -> None:
        self._total[b, cls] += 1
        if ok:
            self._ok[b, cls] += 1

    def maybe_sample(self, b: int, t: float, cluster) -> None:
        """Emit samples for every interval boundary passed by time ``t``."""
        if t < self._next_t[b]:
            return
        while self._next_t[b] <= t:
            self._sample(b, float(self._next_t[b]), cluster)
            self._next_t[b] += self.interval

    def finalize(self, b: int, t: float, cluster) -> None:
        """Force a closing sample at the run's final event time."""
        self._sample(b, float(t), cluster)

    # ------------------------------------------------------------------ #
    def _sample(self, b: int, t: float, cluster) -> None:
        util_g = np.bincount(cluster.placement, weights=cluster.alloc_g,
                             minlength=cluster.N)
        util_c = np.bincount(cluster.placement, weights=cluster.alloc_c,
                             minlength=cluster.N)
        with np.errstate(divide="ignore", invalid="ignore"):
            # effective capacity, so churned-down nodes report utilization
            # against what they can actually serve (0 while fully departed)
            util_g = np.where(cluster.gpu_eff > 0,
                              util_g / cluster.gpu_eff, 0.0)
            util_c = np.where(cluster.cpu_eff > 0,
                              util_c / cluster.cpu_eff, 0.0)
        depth = int(sum(len(q) for q in cluster.queues))
        busy = cluster.head_mask
        slack = cluster.head_deadline[busy] - t
        hist, _ = np.histogram(slack[np.isfinite(slack)], SLACK_EDGES)
        ok = self._ok[b]
        total = self._total[b]
        with np.errstate(divide="ignore", invalid="ignore"):
            fulfill = np.where(total > 0, ok / np.maximum(total, 1), np.nan)
        self.samples[b].append({
            "t": t,
            "util_gpu": [float(x) for x in util_g],
            "util_cpu": [float(x) for x in util_c],
            "queue_depth": depth,
            "slack_hist": [int(x) for x in hist],
            "slo": {CLS_KEYS[c]: (None if total[c] == 0 else float(fulfill[c]))
                    for c in range(N_CLASSES)},
            "n": {CLS_KEYS[c]: int(total[c]) for c in range(N_CLASSES)},
            "viol": {CLS_KEYS[c]: int(total[c] - ok[c])
                     for c in range(N_CLASSES)},
        })

    # ------------------------------------------------------------------ #
    def series(self, b: int = 0) -> List[Dict]:
        return self.samples[b]

    def to_dict(self, b: Optional[int] = None):
        """Plain-JSON series — one list for solo, list-of-lists for batch."""
        if b is not None:
            return self.samples[b]
        return self.samples


def slack_edge_labels() -> List[str]:
    out = []
    for lo, hi in zip(SLACK_EDGES[:-1], SLACK_EDGES[1:]):
        lo_s = "-inf" if not np.isfinite(lo) else f"{lo:g}"
        hi_s = "inf" if not np.isfinite(hi) else f"{hi:g}"
        out.append(f"[{lo_s}, {hi_s})")
    return out
