"""repro_torch.obs — zero-overhead-when-off observability for the repro_torch stack.

Three pillars, composable and individually switchable:

  * :mod:`repro_torch.obs.trace`   — structured event tracing (columnar ring
    buffer; JSONL + Chrome ``trace_event`` export),
  * :mod:`repro_torch.obs.profile` — nested wall-clock phase timers,
  * :mod:`repro_torch.obs.metrics` — per-tick gauge time series.

The engine accepts an :class:`ObsConfig` (or a prebuilt
:class:`RunObserver`); when everything is off the simulator receives
``None`` and its hot path is bit-identical to the uninstrumented code —
instrumentation sites are ``if x is not None`` branches that only *read*
simulation state.

Diagnostics policy: no module under ``src/repro_torch/`` calls bare ``print()``
outside ``__main__``-guarded CLIs (enforced by a lint test).  Library
code routes human-facing progress lines through :func:`diag`, whose sink
is swappable (default: stdout, flushed).

This package imports only numpy and the stdlib, so the engine can import
it without cycles.  The model path's ``torch.profiler`` spans live apart,
in :mod:`repro_torch.obs.spans`, which the model modules import directly.
"""
from __future__ import annotations

import dataclasses
import sys
from typing import Callable, Optional

from repro_torch.obs.metrics import MetricsSampler
from repro_torch.obs.profile import (Profiler, active_profiler, format_phases,
                               pop_profiler, push_profiler, timer)
from repro_torch.obs.trace import (ALLOC, ARRIVAL, CLS_LARGE_AI, CLS_NAMES,
                             CLS_RAN, CLS_SMALL_AI, COMPLETION, DEGRADED,
                             DEGRADED_NAMES, DROP, EPOCH, KIND_NAMES,
                             MIGRATION, NODE_DOWN, NODE_UP, TraceRecorder,
                             degraded_code, load_jsonl)

__all__ = [
    "ObsConfig", "RunObserver", "make_observer",
    "TraceRecorder", "Profiler", "MetricsSampler",
    "timer", "active_profiler", "push_profiler", "pop_profiler",
    "format_phases", "load_jsonl", "diag", "set_diag_sink",
    "ARRIVAL", "COMPLETION", "DROP", "MIGRATION", "EPOCH", "ALLOC",
    "NODE_DOWN", "NODE_UP", "DEGRADED", "DEGRADED_NAMES", "degraded_code",
    "KIND_NAMES", "CLS_LARGE_AI", "CLS_SMALL_AI", "CLS_RAN", "CLS_NAMES",
]


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """What to observe.  The all-off default means 'hand the engine None'."""
    trace: bool = False
    profile: bool = False
    metrics_interval: float = 0.0       # 0 disables the gauge time series
    trace_capacity: int = 0             # 0 -> trace.DEFAULT_CAPACITY

    @property
    def enabled(self) -> bool:
        return self.trace or self.profile or self.metrics_interval > 0


class RunObserver:
    """The per-run bundle the engine threads through its loops.

    Any of the three members may be ``None``; the engine's hot-path
    guards are per-member, so e.g. profiling alone never pays for
    tracing.  One observer serves a whole batched block (``B`` replicas,
    per-replica tags on every record/sample).
    """

    __slots__ = ("trace", "profiler", "metrics", "B", "engine")

    def __init__(self, trace: Optional[TraceRecorder] = None,
                 profiler: Optional[Profiler] = None,
                 metrics: Optional[MetricsSampler] = None,
                 B: int = 1, engine: str = ""):
        self.trace = trace
        self.profiler = profiler
        self.metrics = metrics
        self.B = B
        self.engine = engine


def make_observer(obs, B: int = 1, engine: str = "") -> Optional[RunObserver]:
    """Normalize an ``ObsConfig | RunObserver | None`` into a RunObserver.

    Returns ``None`` when nothing is enabled — the engine's contract for
    the untouched hot path.
    """
    if obs is None:
        return None
    if isinstance(obs, RunObserver):
        obs.B = max(obs.B, B)
        if engine and not obs.engine:
            obs.engine = engine
        return obs
    if not obs.enabled:
        return None
    from repro_torch.obs import trace as _trace
    rec = (TraceRecorder(obs.trace_capacity or _trace.DEFAULT_CAPACITY)
           if obs.trace else None)
    prof = Profiler() if obs.profile else None
    met = (MetricsSampler(obs.metrics_interval, B)
           if obs.metrics_interval > 0 else None)
    return RunObserver(rec, prof, met, B=B, engine=engine)


# --------------------------------------------------------------------- #
# diagnostics routing (the bare-print replacement for library modules)
# --------------------------------------------------------------------- #
def _default_sink(msg: str) -> None:
    # deliberately not print(): this module is the one sanctioned stdout
    # writer for library code, and the no-bare-print lint covers it too
    sys.stdout.write(msg + "\n")
    sys.stdout.flush()


_diag_sink: Callable[[str], None] = _default_sink


def diag(msg: str) -> None:
    """Emit a human-facing progress/diagnostic line via the current sink."""
    _diag_sink(msg)


def set_diag_sink(fn: Optional[Callable[[str], None]]) -> Callable[[str], None]:
    """Swap the diag sink (``None`` restores stdout); returns the old one."""
    global _diag_sink
    old = _diag_sink
    _diag_sink = fn if fn is not None else _default_sink
    return old
