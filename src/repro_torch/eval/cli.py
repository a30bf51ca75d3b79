"""Fleet-sweep CLI over the declarative experiment layer (`repro_torch.exp`).

  # spec file (checked-in experiment), plus any flag overrides; on the
  # card by default (engine cuda), on the host with --engine numpy
  PYTHONPATH=src python -m repro_torch.eval \
      --spec experiments/paper_table3.toml
  PYTHONPATH=src python -m repro_torch.eval \
      --spec experiments/load_sweep.toml --seeds 0..4 --workers 4 \
      --engine numpy
  PYTHONPATH=src python -m repro_torch.eval --smoke --engine torch --device cpu

  # inline grammar (the same parser the spec files use)
  PYTHONPATH=src python -m repro_torch.eval \
      --scenarios "paper,flash-crowd(rho=0.95, n_ai_requests=4000)" \
      --methods "haf(agent=qwen3-32b-sim, critic=@critic?),haf-static" \
      --seeds 3 --out artifacts/sweep_report.json

``--validate`` dry-runs: parse, expand, fingerprint, print the job table,
run nothing.  Reports embed provenance (canonical spec + hashes, scenario
and critic fingerprints, backend versions), and re-running against an
existing report at the same ``--out`` **resumes** — completed rows are
reused, only missing/truncated cells recompute (``--no-resume`` to
recompute everything).  ``--smoke`` shrinks everything (tiny request
counts, 1 seed) for CI.
"""
from __future__ import annotations

import argparse
import os
import sys
import time
from typing import List, Optional

from repro_torch.exp import (ArtifactError, ExperimentSpec, GrammarError,
                             SpecError, job_table, parse_methods,
                             parse_scenarios, parse_seeds, run_experiment)
from repro_torch.exp.provenance import completed_rows, load_prior_report
from repro_torch.exp.runner import expand_experiment
from repro_torch.exp.spec import ENGINES

DEFAULT_METHODS = "haf,haf-static,round-robin,lyapunov"
DEFAULT_SCENARIOS = "paper,diurnal,flash-crowd"
DEFAULT_OUT = "artifacts/sweep_report.json"


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.eval",
        description="HAF fleet evaluation: policies x scenarios x seeds "
                    "(spec files + grammar; see experiments/README.md)")
    ap.add_argument("--spec", default=None, metavar="FILE",
                    help="experiment spec file (.toml or .json); every "
                         "other flag overrides the file's value")
    ap.add_argument("--validate", action="store_true",
                    help="dry run: parse, expand, fingerprint, print the "
                         "job table — run nothing")
    ap.add_argument("--no-resume", action="store_true",
                    help="recompute every row even when a matching report "
                         "already exists at --out")
    ap.add_argument("--scenarios", default=None,
                    help="comma-separated scenario entries: a family name "
                         "or family(k=v, ...) — e.g. "
                         "'paper,flash-crowd(rho=0.95)' "
                         f"[default: {DEFAULT_SCENARIOS}]")
    ap.add_argument("--methods", default=None,
                    help="comma-separated method entries: a name or "
                         "name(k=v, ...) — e.g. "
                         "'haf(agent=qwen3-32b-sim, critic=@critic),"
                         "haf-llm(cmd=\"curl ...\"),caora(alpha=0.4)' "
                         f"[default: {DEFAULT_METHODS}]")
    ap.add_argument("--seeds", default=None,
                    help="count (3 -> 0,1,2), list (0,2,5), or inclusive "
                         "range (0..4) [default: 2]")
    ap.add_argument("--requests", type=int, default=None,
                    help="override n_ai_requests for every scenario")
    ap.add_argument("--rho", type=float, default=None,
                    help="override the load point for every scenario")
    ap.add_argument("--workers", type=int, default=None,
                    help="sweep processes [default: up to 4]")
    ap.add_argument("--batch", type=int, default=None, metavar="B",
                    help="fan up to B seeds of each (scenario, method) cell "
                         "into one batched [B, S] simulation")
    ap.add_argument("--engine", default=None, choices=ENGINES,
                    help="event core backend [default: the spec's, cuda]: "
                         "cuda = the event_step kernel on the card, one "
                         "launch a tick of every [B, S] block (B = 1 "
                         "included); torch = the eager float64 core on "
                         "--device; numpy / scalar = the host (scalar = "
                         "debug reference)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the torch / cuda engines "
                         "[default: cuda; they raise where it is missing]")
    ap.add_argument("--epoch-interval", type=float, default=None)
    ap.add_argument("--max-events", type=int, default=None,
                    help="per-run event budget; hitting it marks the run "
                         "truncated in the report")
    ap.add_argument("--out", default=None,
                    help=f"report path [default: {DEFAULT_OUT}]")
    ap.add_argument("--name", default=None, help="experiment name")
    ap.add_argument("--agent", default=None,
                    help="set agent= on every haf method (shorthand for "
                         "the grammar param)")
    ap.add_argument("--critic", default=None,
                    help="critic artifact for the HAF methods: a path, "
                         "@name / @name? (optional), or name@<fingerprint>")
    ap.add_argument("--caora-alpha", type=float, default=None,
                    help="set alpha= on every caora method")
    ap.add_argument("--trace", action="store_true", default=None,
                    help="record structured event/decision traces per run "
                         "(JSONL + Chrome trace next to --out)")
    ap.add_argument("--profile", action="store_true", default=None,
                    help="per-phase wall-clock profiling; phase tables land "
                         "in each report row and the aggregate")
    ap.add_argument("--metrics-interval", type=float, default=None,
                    metavar="DT",
                    help="sample per-tick gauges (utilization, queue depth, "
                         "slack histogram, SLO) every DT sim-seconds into "
                         "each row's timeseries")
    ap.add_argument("--stream", action="store_true", default=None,
                    help="feed the engine chunked arrival streams and drop "
                         "per-request result lists (O(S+window) memory; "
                         "rows are identical either way)")
    ap.add_argument("--window", type=int, default=None, metavar="W",
                    help="streaming refill granularity in requests "
                         "(0 = the generator's native chunking)")
    ap.add_argument("--smoke", action="store_true",
                    help="CI mode: tiny request counts, 1 seed")
    return ap


def build_experiment(args) -> ExperimentSpec:
    """Flags (+ optional spec file) → a validated ExperimentSpec.

    Spec-file values are the base; every explicitly-passed flag overrides.
    Without ``--spec`` the legacy flag defaults apply, parsed by the same
    grammar, so raw-flag and spec-file invocations of the same experiment
    expand to identical job lists.
    """
    if args.spec:
        spec = ExperimentSpec.from_file(args.spec)
    else:
        spec = ExperimentSpec(
            methods=parse_methods(DEFAULT_METHODS),
            scenarios=parse_scenarios(DEFAULT_SCENARIOS),
            seeds=(0, 1),
            name="cli-sweep",
            workers=max(min(4, (os.cpu_count() or 1)), 1),
            out=DEFAULT_OUT)

    changes = {}
    if args.methods is not None:
        changes["methods"] = parse_methods(args.methods)
    if args.scenarios is not None:
        changes["scenarios"] = parse_scenarios(args.scenarios)
    if args.seeds is not None:
        changes["seeds"] = parse_seeds(args.seeds)
    for flag, field in (("requests", "n_ai_requests"), ("rho", "rho"),
                        ("workers", "workers"), ("batch", "batch"),
                        ("engine", "engine"),
                        ("epoch_interval", "epoch_interval"),
                        ("max_events", "max_events"), ("out", "out"),
                        ("name", "name"), ("trace", "trace"),
                        ("profile", "profile"),
                        ("metrics_interval", "metrics_interval"),
                        ("stream", "stream"), ("window", "window")):
        val = getattr(args, flag)
        if val is not None:
            changes[field] = val
    if changes:
        spec = spec.replace(**changes)

    # method-level shorthands apply to every matching method
    if args.agent is not None or args.critic is not None:
        methods = []
        for m in spec.methods:
            params = dict(m["params"])
            if args.agent is not None and m["name"] == "haf":
                params["agent"] = args.agent
            if args.critic is not None and m["name"] in ("haf", "haf-llm"):
                params["critic_path"] = args.critic
            methods.append(dict(m, params=params))
        spec = spec.replace(methods=tuple(methods))
    if args.caora_alpha is not None:
        methods = [dict(m, params=dict(m["params"], alpha=args.caora_alpha))
                   if m["name"] == "caora" else m for m in spec.methods]
        spec = spec.replace(methods=tuple(methods))

    if args.smoke:
        spec = spec.replace(seeds=spec.seeds[:1] or (0,),
                            n_ai_requests=spec.n_ai_requests or 150)
    if spec.out is None:
        spec = spec.replace(out=DEFAULT_OUT)
    return spec


def main(argv: Optional[List[str]] = None) -> int:
    ap = _build_parser()
    args = ap.parse_args(argv)
    try:
        spec = build_experiment(args)
        spec.validate()
    except (GrammarError, SpecError, FileNotFoundError) as err:
        ap.error(str(err))

    n_jobs = len(spec.methods) * len(spec.scenarios) * len(spec.seeds)
    batched = f", batch={spec.batch}" if spec.batch > 1 else ""
    print(f"# experiment {spec.name!r}: {len(spec.methods)} methods x "
          f"{len(spec.scenarios)} scenarios x {len(spec.seeds)} seeds = "
          f"{n_jobs} runs ({spec.workers} workers{batched})", flush=True)
    print(f"# spec_hash={spec.spec_hash()[:12]} "
          f"identity={spec.identity_hash()[:12]}", flush=True)

    if args.validate:
        try:
            _, jobs, prov = expand_experiment(spec, args.device)
        except ArtifactError as err:
            ap.error(str(err))
        prior = {}
        if not args.no_resume and spec.out:
            prior = completed_rows(load_prior_report(spec.out),
                                   prov["resume_key"])
        for ref, entry in prov["artifacts"].items():
            fp = entry.get("fingerprint") or entry.get("file_sha256") or ""
            state = "MISSING (optional)" if entry.get("missing") else \
                f"{entry['path']}" + (f" @{fp[:12]}" if fp else "")
            print(f"# artifact {ref} -> {state}", flush=True)
        print(job_table(jobs, prov, prior))
        print(f"# validate only: {len(jobs)} jobs expanded, "
              f"{len(prior)} resumable, nothing run", flush=True)
        return 0

    t0 = time.time()
    try:
        report = run_experiment(spec, resume=not args.no_resume,
                                verbose=True, validate=False,
                                device=args.device)
    except ArtifactError as err:
        ap.error(str(err))
    from repro_torch.eval.report import format_table
    if report["n_truncated"]:
        print(f"# WARNING: {report['n_truncated']}/{report['n_runs']} runs "
              f"hit max_events — partial results (raise --max-events)",
              flush=True)
    print(format_table(report["aggregate"]))
    resumed = report["provenance"].get("resumed_rows", 0)
    note = f", {resumed} resumed" if resumed else ""
    print(f"# report -> {spec.out}  ({time.time() - t0:.0f}s{note})",
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
