"""Experiment execution: expand → (resume-filter) → sweep → stamped
report.

:func:`run_experiment` is the one entry point every frontend (CLI,
benchmarks, examples) funnels through.  It expands the spec into jobs,
builds each distinct scenario once, reuses completed rows from a prior
report at the same output path (matching on the provenance resume key —
see :mod:`repro_torch.exp.provenance`), runs only the pending jobs, and writes
a report that embeds the canonical spec, its hashes, per-cell scenario
fingerprints, resolved artifact fingerprints, and backend info.

Interrupted multi-family sweeps therefore restart cheaply::

    report = run_experiment(spec)            # killed after 70/100 rows…
    report = run_experiment(spec)            # …resumes: runs the other 30
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

from repro_torch.exp.provenance import (build_provenance, completed_rows,
                                        job_key, load_prior_report)
from repro_torch.exp.spec import ExperimentSpec
from repro_torch.obs import diag

__all__ = ["run_experiment", "expand_experiment", "job_table"]


def expand_experiment(spec: ExperimentSpec, device="cuda"):
    """(sweep spec, jobs-with-scenarios, provenance) — the dry-run view."""
    from repro_torch.eval.sweep import attach_scenarios, expand_jobs
    sweep = spec.to_sweep_spec(device)
    jobs = expand_jobs(sweep)
    attach_scenarios(jobs)
    return sweep, jobs, build_provenance(spec, jobs, device)


def run_experiment(spec: ExperimentSpec, *, resume: bool = True,
                   verbose: bool = False, out=None,
                   validate: bool = True, device="cuda") -> Dict:
    """Execute the experiment and return the stamped report (also written
    to ``out`` / ``spec.out`` when set).

    ``resume=True`` reuses completed, non-truncated rows from an existing
    report at the output path when its provenance resume key matches —
    the (spec identity, artifact fingerprints) pair — and recomputes only
    what is missing.  ``device`` is where the ``torch`` / ``cuda``
    engines run; the host engines ignore it.
    """
    from repro_torch.eval.report import build_report, write_report
    from repro_torch.eval.sweep import run_sweep

    if validate:
        spec.validate()
    out = out or spec.out
    sweep, jobs, prov = expand_experiment(spec, device)

    prior: Dict = {}
    if resume and out:
        job_keys = {job_key(j) for j in jobs}
        prior = completed_rows(load_prior_report(out), prov["resume_key"])
        prior = {k: r for k, r in prior.items() if k in job_keys}
    pending = [j for j in jobs if job_key(j) not in prior]
    prov["resumed_rows"] = len(jobs) - len(pending)
    if verbose and prior:
        diag(f"# resume: {len(prior)}/{len(jobs)} rows reused from {out} "
             "(--no-resume recomputes)")

    t0 = time.time()  # repro: allow(wall-clock): provenance wall_s stamp
    new_rows: List[Optional[Dict]] = []
    if pending:
        new_rows = run_sweep(sweep, verbose=verbose, jobs=pending)
    it = iter(new_rows)
    rows: List[Optional[Dict]] = [prior[job_key(j)] if job_key(j) in prior
                                  else next(it) for j in jobs]
    # repro: allow(wall-clock): report metadata — wall_s is provenance,
    # not a result column, and stays out of every hash
    prov["wall_s"] = round(time.time() - t0, 3)

    report = build_report(sweep, rows, provenance=prov)
    if out:
        write_report(report, out)
    return report


def job_table(jobs: List[Dict], prov: Dict,
              prior: Optional[Dict] = None) -> str:
    """Fixed-width dry-run table: one line per expanded job."""
    fps = prov.get("scenario_fingerprints", {})
    hdr = (f"{'#':>4s} {'method':24s} {'scenario':18s} {'seed':>4s} "
           f"{'engine':7s} {'scenario_fp':12s} {'status':8s}")
    lines = [hdr, "-" * len(hdr)]
    for i, job in enumerate(jobs):
        fp = fps.get(job["scenario_label"], "")[:12]
        status = "resumed" if prior and job_key(job) in prior else "pending"
        lines.append(f"{i:>4d} {job['method_label']:24s} "
                     f"{job['scenario_label']:18s} {job['seed']:>4d} "
                     f"{job['engine']:7s} {fp:12s} {status:8s}")
    return "\n".join(lines)
