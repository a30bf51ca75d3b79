"""Phase profiling: nested wall-clock timers with near-zero off cost.

A :class:`Profiler` accumulates ``(total seconds, call count)`` per phase
name.  Phase names are dotted paths (``"engine.step"``,
``"allocator.solve"``, ``"core.h2d"``) so the report groups naturally.

Two usage styles:

  * hot path (engine inner loops) — manual ``perf_counter`` deltas via
    :meth:`Profiler.add`, guarded by ``if prof is not None``; this keeps
    the disabled cost to a single predicate per phase per event,
  * cold path (sweep runners, benchmarks) — ``with obs.timer("name"):``
    which resolves the *active* profiler dynamically and no-ops when
    profiling is off.

The active-profiler stack makes ``obs.timer`` usable from modules that
never see the ``Simulator`` (event-core backends, allocator internals)
without threading a handle through every signature.
"""
from __future__ import annotations

from contextlib import contextmanager
from time import perf_counter
from typing import Dict, List, Optional


class Profiler:
    """Accumulates wall-clock totals and call counts per phase name."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}
        self._t0: Optional[float] = None

    # hot-path API ------------------------------------------------------ #
    def add(self, name: str, dt: float, n: int = 1) -> None:
        self.totals[name] = self.totals.get(name, 0.0) + dt
        self.counts[name] = self.counts.get(name, 0) + n

    # cold-path API ----------------------------------------------------- #
    @contextmanager
    def timer(self, name: str):
        t0 = perf_counter()
        try:
            yield
        finally:
            self.add(name, perf_counter() - t0)

    def start(self) -> None:
        self._t0 = perf_counter()

    def stop(self) -> float:
        """Close the run-level clock; returns total wall seconds."""
        if self._t0 is None:
            return 0.0
        wall = perf_counter() - self._t0
        self.add("run", wall)
        self._t0 = None
        return wall

    def report(self) -> Dict:
        """``{"wall_s", "phases": {name: {"total_s", "count", "mean_us"}}}``

        ``wall_s`` is the ``run`` phase if one was recorded, else the sum
        of top-level (un-dotted parent) phases.
        """
        phases = {}
        for name in sorted(self.totals):
            total = self.totals[name]
            count = self.counts[name]
            phases[name] = {
                "total_s": total,
                "count": count,
                "mean_us": (total / count * 1e6) if count else 0.0,
            }
        if "run" in self.totals:
            wall = self.totals["run"]
        else:
            roots = {n.split(".", 1)[0] for n in self.totals}
            wall = sum(self.totals[n] for n in self.totals
                       if n.split(".", 1)[0] in roots and "." not in n)
        return {"wall_s": wall, "phases": phases}

    def merge(self, other: "Profiler") -> None:
        for name, total in other.totals.items():
            self.add(name, total, other.counts.get(name, 0))


# --------------------------------------------------------------------- #
# active-profiler stack (module-level ``obs.timer``)
# --------------------------------------------------------------------- #
_ACTIVE: List[Profiler] = []


def push_profiler(prof: Profiler) -> None:
    _ACTIVE.append(prof)


def pop_profiler(prof: Profiler) -> None:
    if _ACTIVE and _ACTIVE[-1] is prof:
        _ACTIVE.pop()
    elif prof in _ACTIVE:           # unbalanced exit; drop it anyway
        _ACTIVE.remove(prof)


def active_profiler() -> Optional[Profiler]:
    return _ACTIVE[-1] if _ACTIVE else None


@contextmanager
def timer(name: str):
    """Time a block against the active profiler; no-op when none is set."""
    prof = active_profiler()
    if prof is None:
        yield
        return
    t0 = perf_counter()
    try:
        yield
    finally:
        prof.add(name, perf_counter() - t0)


def format_phases(report: Dict, min_frac: float = 0.0) -> str:
    """Render a ``Profiler.report()`` as an aligned text table."""
    wall = report.get("wall_s", 0.0) or 0.0
    rows = []
    for name, ph in sorted(report.get("phases", {}).items(),
                           key=lambda kv: -kv[1]["total_s"]):
        frac = ph["total_s"] / wall if wall else 0.0
        if frac < min_frac and name != "run":
            continue
        rows.append((name, ph["total_s"], 100.0 * frac, ph["count"],
                     ph["mean_us"]))
    if not rows:
        return "(no phases recorded)"
    w = max(len(r[0]) for r in rows)
    lines = [f"{'phase':<{w}}  {'total_s':>9}  {'%wall':>6}  "
             f"{'count':>9}  {'mean_us':>10}"]
    for name, tot, pct, cnt, mean in rows:
        lines.append(f"{name:<{w}}  {tot:>9.4f}  {pct:>6.1f}  "
                     f"{cnt:>9d}  {mean:>10.2f}")
    return "\n".join(lines)
