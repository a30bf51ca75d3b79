"""Aggregation + JSON report for fleet sweeps.

Per (method, scenario) cell: mean and 95% CI over seeds for the per-class
fulfillment rates, plus mean migration counts.  The report is plain JSON:
the raw per-run rows ride along so downstream analysis never needs to
re-simulate.

Request classes absent from a scenario arrive as NaN (see
``SimResult.summary``): they are skipped — not averaged as zeros — and a
cell whose every seed lacks the class reports ``mean: null`` with
``n: 0``.  Truncated runs (``max_events`` hit with work pending) are
counted per cell and at report top level so partial results never pass
silently for converged ones.
"""
from __future__ import annotations

import dataclasses
import json
import math
import pathlib
from typing import Dict, List, Optional

METRICS = ("overall", "ran", "ai", "large_ai", "small_ai")
COUNTS = ("mig_large", "mig_total", "infeasible_events")


def _mean_ci(values: List[float]) -> Dict[str, Optional[float]]:
    """Mean and 95% CI over the finite values; NaN entries are absent
    classes and do not contribute to n."""
    finite = [v for v in values if not math.isnan(v)]
    n = len(finite)
    if n == 0:
        return {"mean": None, "ci95": None, "n": 0}
    mean = sum(finite) / n
    if n < 2:
        return {"mean": mean, "ci95": 0.0, "n": n}
    var = sum((v - mean) ** 2 for v in finite) / (n - 1)
    return {"mean": mean, "ci95": 1.96 * math.sqrt(var / n), "n": n}


def aggregate(rows: List[Dict]) -> List[Dict]:
    """Collapse per-run rows into (method, scenario) summary cells."""
    groups: Dict[tuple, List[Dict]] = {}
    for row in rows:
        if row is None:
            continue
        groups.setdefault((row["method"], row["scenario"]), []).append(row)

    out = []
    for (method, scenario), g in sorted(groups.items()):
        cell: Dict = {"method": method, "scenario": scenario,
                      "seeds": sorted(r["seed"] for r in g)}
        for m in METRICS:
            # A metric can be None when a run has no requests of that
            # class (e.g. trace replays carry no RAN functions, so
            # `ran` is undefined rather than 0).
            cell[m] = _mean_ci([float(r[m]) for r in g
                                if r.get(m) is not None])
        for c in COUNTS:
            vals = [float(r.get(c, 0)) for r in g]
            cell[c] = {"mean": sum(vals) / len(vals),
                       "max": max(vals)}
        cell["truncated_runs"] = sum(1 for r in g if r.get("truncated"))
        cell["wall_s"] = sum(float(r.get("wall_s", 0.0)) for r in g)
        evps = [float(r["events_per_sec"]) for r in g
                if r.get("events_per_sec")]
        if evps:
            cell["events_per_sec"] = _mean_ci(evps)
        prof = _merge_profiles([r["profile"] for r in g if r.get("profile")])
        if prof is not None:
            cell["profile"] = prof
        out.append(cell)
    return out


def _merge_profiles(reports: List[Dict]) -> Optional[Dict]:
    """Sum per-phase totals/counts across a cell's per-run phase tables
    (the :meth:`repro_torch.obs.Profiler.report` form)."""
    if not reports:
        return None
    phases: Dict[str, Dict[str, float]] = {}
    wall = 0.0
    for rep in reports:
        wall += float(rep.get("wall_s", 0.0))
        for name, p in rep.get("phases", {}).items():
            acc = phases.setdefault(name, {"total_s": 0.0, "count": 0})
            acc["total_s"] += float(p["total_s"])
            acc["count"] += int(p["count"])
    for p in phases.values():
        p["mean_us"] = 1e6 * p["total_s"] / max(p["count"], 1)
    return {"wall_s": wall, "phases": phases}


def _sanitize(obj):
    """NaN -> null recursively: the report must stay strict JSON."""
    if isinstance(obj, float) and math.isnan(obj):
        return None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def build_report(spec, rows: List[Optional[Dict]],
                 provenance: Optional[Dict] = None) -> Dict:
    """Aggregate ``rows`` under ``spec``; ``provenance`` (the stamped block
    built by :mod:`repro_torch.exp.provenance` — canonical spec + hashes +
    scenario/artifact fingerprints + backend info) rides along verbatim
    so reports are auditable and resumable."""
    spec_dict = dataclasses.asdict(spec) if dataclasses.is_dataclass(spec) \
        else dict(spec)
    # sequences arrive as tuples; JSON wants lists
    spec_dict = {k: list(v) if isinstance(v, tuple) else v
                 for k, v in spec_dict.items()}
    completed = [r for r in rows if r is not None]
    report = {
        "kind": "repro.eval.sweep_report",
        "spec": spec_dict,
        "n_runs": len(completed),
        "n_failed": len(rows) - len(completed),
        "n_truncated": sum(1 for r in completed if r.get("truncated")),
        "runs": completed,
        "aggregate": aggregate(completed),
    }
    if provenance is not None:
        report["provenance"] = provenance
    return _sanitize(report)


def write_report(report: Dict, path) -> pathlib.Path:
    path = pathlib.Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=2, sort_keys=True,
                               allow_nan=False))
    return path


def format_table(aggregate_rows: List[Dict],
                 metrics: Optional[List[str]] = None) -> str:
    """Fixed-width text table of the aggregate (mean±ci per metric)."""
    metrics = metrics or ["overall", "ran", "large_ai", "small_ai"]
    hdr = (f"{'scenario':16s} {'method':14s} "
           + " ".join(f"{m:>15s}" for m in metrics)
           + f" {'mig(L/tot)':>12s}")
    lines = [hdr, "-" * len(hdr)]
    for cell in aggregate_rows:
        vals = " ".join(
            "—".rjust(15) if cell[m]["mean"] is None else
            f"{cell[m]['mean']:.4f}±{cell[m]['ci95']:.4f}".rjust(15)
            for m in metrics)
        mig = (f"{cell['mig_large']['mean']:.1f}"
               f"/{cell['mig_total']['mean']:.1f}")
        flag = " TRUNC" if cell.get("truncated_runs") else ""
        lines.append(f"{cell['scenario']:16s} {cell['method']:14s} "
                     f"{vals} {mig:>12s}{flag}")
    return "\n".join(lines)
