"""Fleet evaluation: sweep specs, parallel execution, aggregated reports.

The evaluation API every frontend plugs into::

    from repro_torch.eval import (SweepSpec, run_sweep, build_report,
                                  write_report)

    spec = SweepSpec(methods=("haf-static", "round-robin"),
                     scenarios=("paper", "flash-crowd"),
                     seeds=(0, 1), n_ai_requests=500, workers=4)
    rows = run_sweep(spec)
    write_report(build_report(spec, rows), "artifacts/report.json")

CLI: ``PYTHONPATH=src python -m repro_torch.eval --help``.

The declarative layer on top — experiment spec files, the
method/scenario grammar, artifact references, provenance-stamped
resumable runs — lives in :mod:`repro_torch.exp` (``ExperimentSpec``,
``run_experiment``); ``python -m repro_torch.eval --spec
experiments/<f>.toml`` drives it from the command line.
"""
from repro_torch.eval.policies import (haf_spec, make_method, method_names,
                                       normalize_method, register_method)
from repro_torch.eval.report import (aggregate, build_report, format_table,
                                     write_report)
from repro_torch.eval.sweep import (SweepSpec, attach_scenarios, expand_jobs,
                                    normalize_scenario, run_batch_jobs,
                                    run_job, run_sweep, scenario_for_job)

__all__ = [
    "SweepSpec", "attach_scenarios", "expand_jobs", "normalize_scenario",
    "run_batch_jobs", "run_job", "run_sweep", "scenario_for_job",
    "haf_spec", "make_method", "method_names", "normalize_method",
    "register_method",
    "aggregate", "build_report", "format_table", "write_report",
]
