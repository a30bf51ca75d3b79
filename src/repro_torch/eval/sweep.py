"""Fleet sweeps: policies × scenarios × seeds, optionally across processes.

A sweep is declared as data (:class:`SweepSpec`) and expanded into jobs;
each job realizes its scenario + workload from names and seeds inside the
worker, so nothing unpicklable crosses the process boundary.  Workers use
the ``spawn`` start method (fork is unsafe once CUDA has initialized) —
spawn re-imports ``__main__``, so call a ``workers > 1`` sweep from a real
module or script (guarded by ``if __name__ == "__main__"``), not from a
REPL/stdin; use ``workers=1`` there.

Two executions paths:

  * classic — one simulator run per job.  The normalized scenario dict is
    built **once** per (scenario, params, overrides) group in the parent
    and attached to the jobs, so workers skip the ``make_scenario``
    rebuild every job used to pay.
  * batched (``batch_seeds > 1``) — jobs are
    grouped by (scenario, method) cell and up to ``batch_seeds`` seeds
    fan into ONE ``Simulator.run_batch`` call: one process, one scenario
    build, one ``[B, S]`` lockstep simulation instead of B process
    spawns + B scenario rebuilds.  Rows are identical to the classic path
    (the batched engine is discrete-outcome identical per seed).  Every
    method spec batches — HAF/HAF-NoCritic cells dispatch grouped epoch
    decisions (one ``[B, C, F]`` critic evaluation per tick) and the B
    replicas share one cached critic artifact; ``haf-llm`` cells pay one
    completion call per replica but still batch the fast timescale.

The ``cuda`` engine is the batched ``[B, S]`` kernel core: at
``batch_seeds == 1`` a classic job's ``Simulator.run`` is a one-replica
``run_batch`` (solo ≡ batched), one ``event_step`` launch a tick, and
never falls back to the host.  Before any job runs, a sweep on
a device engine checks that the device is there (``RuntimeError`` naming
CUDA if not) and, for ``cuda``, builds the kernels once in the parent, so
spawn workers load the built libraries instead of racing to compile them.
Jobs carry numpy scenario dicts only; no tensor crosses to a worker.
"""
from __future__ import annotations

import dataclasses
import inspect
import itertools
import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor, as_completed
from typing import Dict, List, Optional, Sequence, Union

from repro_torch.eval.policies import make_method, normalize_method
from repro_torch.obs import diag

ScenarioSpec = Union[str, Dict]


@dataclasses.dataclass(frozen=True)
class SweepSpec:
    """policies × scenarios × seeds (+ shared run parameters)."""
    methods: Sequence = ("haf-static", "round-robin")
    scenarios: Sequence = ("paper",)
    seeds: Sequence = (0,)
    n_ai_requests: Optional[int] = None     # override every family's default
    rho: Optional[float] = None             # override every family's ρ
    epoch_interval: float = 5.0
    max_events: int = 5_000_000
    workers: int = 1
    scenario_seed: int = 0                  # topology seed (workload varies)
    engine: str = "cuda"                    # numpy | scalar | torch | cuda
    batch_seeds: int = 1                    # >1: fan seeds into run_batch
    device: str = "cuda"                    # where torch / cuda engines run
    # streaming arrivals: feed the engine the chunked ArrivalStream and
    # drop the per-request result list (O(S + window) memory instead of
    # O(n_requests) per replica).  Discrete outcomes and summary rows are
    # identical either way — stream/window are memory knobs, excluded
    # from the experiment identity hash.  window=0 keeps the generator's
    # native chunking; trace-family scenarios always stream.
    stream: bool = False
    window: int = 0
    # observability (repro_torch.obs) — all off by default; the engine then
    # runs the uninstrumented, bit-identical hot path
    trace: bool = False                     # event trace -> row trace_counts
    profile: bool = False                   # phase timers -> row profile
    metrics_interval: float = 0.0           # >0: gauge series -> timeseries
    trace_dir: Optional[str] = None         # export traces (jsonl + chrome)


def normalize_scenario(spec: ScenarioSpec) -> Dict:
    if isinstance(spec, str):
        return {"family": spec, "params": {}, "label": spec}
    out = {"family": spec["family"], "params": dict(spec.get("params", {}))}
    out["label"] = spec.get("label", out["family"])
    return out


def expand_jobs(spec: SweepSpec) -> List[Dict]:
    """The sweep's full job list (one simulator run per entry)."""
    methods = [normalize_method(m) for m in spec.methods]
    scenarios = [normalize_scenario(s) for s in spec.scenarios]
    jobs = []
    for sc, m, seed in itertools.product(scenarios, methods, spec.seeds):
        jobs.append({
            "family": sc["family"],
            "scenario_label": sc["label"],
            "scenario_params": sc["params"],
            "scenario_seed": spec.scenario_seed,
            "method": m["name"],
            "method_label": m["label"],
            "method_params": m["params"],
            "seed": int(seed),
            "n_ai_requests": spec.n_ai_requests,
            "rho": spec.rho,
            "epoch_interval": spec.epoch_interval,
            "max_events": spec.max_events,
            "engine": spec.engine,
            "device": spec.device,
            "stream": spec.stream,
            "window": spec.window,
            "trace": spec.trace,
            "profile": spec.profile,
            "metrics_interval": spec.metrics_interval,
            "trace_dir": spec.trace_dir,
        })
    return jobs


def scenario_for_job(job: Dict) -> Dict:
    """Realize the job's scenario (family + params + global overrides)."""
    from repro_torch.sim.scenarios import make_scenario
    from repro_torch.sim.scenarios.registry import REGISTRY

    params = dict(job["scenario_params"])
    # global overrides reach the family itself when it takes them (so
    # families that derive structure from the trace length — e.g. outage
    # windows — stay consistent with the realized workload); families
    # without the knob still get the workload-level override below
    sig = inspect.signature(REGISTRY[job["family"]]) \
        if job["family"] in REGISTRY else None
    for key in ("n_ai_requests", "rho"):
        if job.get(key) is not None and sig is not None and (
                key in sig.parameters
                or any(p.kind is p.VAR_KEYWORD
                       for p in sig.parameters.values())):
            params[key] = job[key]
    return make_scenario(job["family"], seed=job["scenario_seed"], **params)


def _scenario_key(job: Dict) -> tuple:
    return (job["family"], repr(sorted(job["scenario_params"].items())),
            job["scenario_seed"], job.get("n_ai_requests"), job.get("rho"))


def attach_scenarios(jobs: List[Dict]) -> None:
    """Build each distinct scenario ONCE and attach it to its jobs.

    Workers then deserialize the ready-made dict instead of re-running
    ``make_scenario`` per job (topology builds dominate worker startup on
    large families).  The scenario dict is read-only to the engine, so
    sharing one object across same-cell jobs in-process is safe.
    """
    cache: Dict[tuple, Dict] = {}
    for job in jobs:
        if job.get("scenario") is not None:
            continue             # already attached (e.g. by repro_torch.exp)
        key = _scenario_key(job)
        if key not in cache:
            cache[key] = scenario_for_job(job)
        job["scenario"] = cache[key]


def _obs_config(job: Dict):
    """The job's ObsConfig, or None when everything is off (the default —
    the engine then never sees an observer)."""
    if not (job.get("trace") or job.get("profile")
            or (job.get("metrics_interval") or 0) > 0):
        return None
    from repro_torch.obs import ObsConfig
    return ObsConfig(trace=bool(job.get("trace")),
                     profile=bool(job.get("profile")),
                     metrics_interval=float(job.get("metrics_interval")
                                            or 0.0))


def _export_trace(job: Dict, res, seeds: str) -> Optional[str]:
    """Write the run's trace as JSONL + Chrome JSON under ``trace_dir``."""
    tdir = job.get("trace_dir")
    if res.trace is None or not tdir:
        return None
    import pathlib
    import re
    stem = re.sub(r"[^A-Za-z0-9._-]+", "-",
                  f"{job['method_label']}_{job['scenario_label']}"
                  f"_seed{seeds}")
    path = pathlib.Path(tdir) / f"{stem}.jsonl"
    res.trace.to_jsonl(path)
    res.trace.to_chrome(path.with_suffix(".chrome.json"))
    return str(path)


def _job_stream(job: Dict, sc: Dict):
    """(workload stream, info, streamed?) for a job.

    Every job realizes its workload as an ArrivalStream; non-streamed
    jobs feed the engine its ``materialize()`` (same metadata horizon, so
    the rows are identical — the whole point of the equivalence
    contract).  Trace-family scenarios always stream: a day-scale trace
    should never be resident in full.
    """
    from repro_torch.sim.scenarios import workload_stream_for

    streamed = bool(job.get("stream")) or \
        (sc.get("workload") or {}).get("kind") == "trace"
    stream = workload_stream_for(sc, seed=job["seed"],
                                 n_ai_requests=job.get("n_ai_requests"),
                                 rho=job.get("rho"),
                                 window=job.get("window") or None)
    if not streamed:
        stream = stream.materialize()
    return stream, dict(stream.info), streamed


def run_job(job: Dict) -> Dict:
    """One simulator run; returns a flat, JSON-ready result row."""
    from repro_torch.sim import Simulator

    engine = job.get("engine", "cuda")
    sc = job.get("scenario") or scenario_for_job(job)
    stream, info, streamed = _job_stream(job, sc)
    placement, allocation, rr = make_method(job["method"],
                                            **job["method_params"])
    sim = Simulator(sc, epoch_interval=job["epoch_interval"],
                    engine=engine, device=job.get("device", "cuda"))
    t0 = time.time()
    res = sim.run(stream, placement, allocation, rr_dispatch=rr,
                  max_events=job["max_events"],
                  retain_requests=not streamed, obs=_obs_config(job))
    wall = time.time() - t0
    trace_path = _export_trace(job, res, str(job["seed"]))
    row = _result_row(job, res, wall, info, trace_path=trace_path)
    if getattr(placement, "critic_degraded", False):
        row["critic_degraded"] = True
    return row


def run_batch_jobs(jobs: List[Dict],
                   fallback_note: Optional[str] = None) -> List[Dict]:
    """One batched simulator run over same-cell jobs differing in seed.

    Builds the scenario once, realizes every seed's workload, and fans
    them into ``Simulator.run_batch`` — per-row results are identical to
    ``run_job`` per job; ``wall_s`` is the batch wall time divided evenly.

    ``fallback_note`` marks a single-replica retry of a failed batch
    group: the note is stamped on every row (``batch_fallback``) and one
    DEGRADED record per row rides the obs trace, so the retry path is
    visible in both reports and trace reconciliation.
    """
    from repro_torch.sim import Simulator

    base = jobs[0]
    sc = base.get("scenario") or scenario_for_job(base)
    workloads, infos = [], []
    streamed = False
    for job in jobs:
        stream, info, job_streamed = _job_stream(job, sc)
        streamed = streamed or job_streamed
        workloads.append(stream)
        infos.append(info)
    methods = [make_method(job["method"], **job["method_params"])
               for job in jobs]
    rr = methods[0][2]
    sim = Simulator(sc, epoch_interval=base["epoch_interval"],
                    engine=base.get("engine", "cuda"),
                    device=base.get("device", "cuda"))
    t0 = time.time()
    results = sim.run_batch(workloads,
                            [m[0] for m in methods],
                            [m[1] for m in methods],
                            rr_dispatch=rr,
                            max_events=base["max_events"],
                            retain_requests=not streamed,
                            obs=_obs_config(base))
    wall = time.time() - t0
    if fallback_note and results[0].trace is not None:
        from repro_torch.obs import DEGRADED, degraded_code
        for b in range(len(results)):
            results[0].trace.emit(DEGRADED, 0.0, b, -1,
                                  degraded_code("batch-fallback"))
    # the recorder is shared by the whole block: export once, reference
    # the file from every row; trace_counts stay per-replica
    trace_path = _export_trace(
        base, results[0], "-".join(str(j["seed"]) for j in jobs))
    rows = [dict(_result_row(job, res, wall / len(jobs), info,
                             b=b, trace_path=trace_path),
                 batch=len(jobs), b=b)
            for b, (job, res, info)
            in enumerate(zip(jobs, results, infos))]
    for row, (placement, _, _) in zip(rows, methods):
        if getattr(placement, "critic_degraded", False):
            row["critic_degraded"] = True
        if fallback_note:
            row["batch_fallback"] = fallback_note
    return rows


def _result_row(job: Dict, res, wall: float, info: Dict,
                b: int = 0, trace_path: Optional[str] = None) -> Dict:
    row = dict(res.summary())
    row.update({
        "method": job["method_label"],
        "scenario": job["scenario_label"],
        "family": job["family"],
        "seed": job["seed"],
        "n_requests": res.n_requests,
        "n_events": res.n_events,
        "truncated": res.truncated,
        "engine": job.get("engine", "cuda"),
        "infeasible_events": res.infeasible_events,
        "horizon_s": info.get("horizon", 0.0),
        "wall_s": wall,
        # engine-measured wall (for a batch: the whole block's wall,
        # shared by its rows) — ev/s derivable from any row
        "engine_wall_s": res.wall_s,
        "events_per_sec": res.events_per_sec,
    })
    if getattr(res, "degraded", None):
        row["degraded_by_kind"] = dict(res.degraded)
    if res.profile is not None:
        row["profile"] = res.profile
    if res.timeseries is not None:
        row["timeseries"] = res.timeseries
    if res.trace is not None:
        row["trace_counts"] = res.trace.counts(b)
        if trace_path:
            row["trace_path"] = trace_path
    return row


def _batch_groups(jobs: List[Dict], batch_seeds: int) -> List[List[int]]:
    """Group job indices by everything-but-seed, chunked to batch size."""
    cells: Dict[tuple, List[int]] = {}
    for i, job in enumerate(jobs):
        key = (_scenario_key(job), job["scenario_label"], job["method"],
               job["method_label"], repr(sorted(job["method_params"].items(),
                                               key=lambda kv: kv[0])),
               job["epoch_interval"], job["max_events"], job["engine"],
               job.get("device"), job.get("stream"), job.get("window"),
               job.get("trace"), job.get("profile"),
               job.get("metrics_interval"))
        cells.setdefault(key, []).append(i)
    groups = []
    for idxs in cells.values():
        for lo in range(0, len(idxs), batch_seeds):
            groups.append(idxs[lo:lo + batch_seeds])
    return groups


def _prepare_device(engine: str, device) -> None:
    """Fail fast where a device engine's device is missing — a missing card
    must not hide behind the sweep's failing-job isolation as rows of
    ``None`` — and build the ``cuda`` kernels once, in this process."""
    if engine not in ("torch", "cuda"):
        return
    from repro_torch.sim.event_core import resolve_device
    resolve_device(device)
    if engine == "cuda":
        from repro_torch.kernels import _build
        _build.load()


def run_sweep(spec: SweepSpec, verbose: bool = False,
              jobs: Optional[List[Dict]] = None) -> List[Optional[Dict]]:
    """Execute every job, in-process or across ``spec.workers`` processes.

    A failing job does not abort the sweep: its slot is ``None`` (reported
    loudly) and the surviving rows still aggregate.  Raises only when every
    job failed, or before any job runs when the engine's device is not
    there.  With ``batch_seeds > 1`` jobs sharing a (scenario, method)
    cell run as one batched simulation per chunk of seeds.

    ``jobs`` runs an explicit (possibly filtered) job list instead of
    re-expanding the spec — the resume path of ``repro_torch.exp`` passes the
    pending subset; rows stay aligned with the given list.
    """
    if jobs is None:
        jobs = expand_jobs(spec)
    elif not jobs:
        return []
    _prepare_device(spec.engine, spec.device)
    attach_scenarios(jobs)
    rows: List[Optional[Dict]] = [None] * len(jobs)

    def note(i: int, done: int) -> None:
        if verbose and rows[i] is not None:
            r = rows[i]
            trunc = " TRUNCATED" if r.get("truncated") else ""
            batch = f" b={r['batch']}" if r.get("batch") else ""
            diag(f"# [{done}/{len(jobs)}] {r['method']}"
                 f" @ {r['scenario']} seed={r['seed']}"
                 f" overall={r['overall']:.4f}"
                 f" wall={r['wall_s']:.1f}s{batch}{trunc}")

    def failed(i: int, err: Exception) -> None:
        job = jobs[i]
        diag(f"# JOB FAILED: {job['method_label']}"
             f" @ {job['scenario_label']} seed={job['seed']}:"
             f" {type(err).__name__}: {err}")

    def batch_group_fallback(idxs: List[int], err: Exception) -> None:
        """A failed group retries job-by-job (single-replica batches), so
        one pathological seed costs one row — the same failing-job
        isolation the classic path gives — not the whole cell.  The
        group-level error is reported first: a B>1-only failure must not
        hide behind a successful fallback."""
        job = jobs[idxs[0]]
        diag(f"# BATCH GROUP FAILED ({len(idxs)} jobs, "
             f"{job['method_label']} @ {job['scenario_label']}): "
             f"{type(err).__name__}: {err} — retrying per job")
        note = (f"group of {len(idxs)} fell back to single-replica "
                f"retries: {type(err).__name__}")
        for i in idxs:
            try:
                rows[i] = run_batch_jobs([jobs[i]], fallback_note=note)[0]
            except Exception as err:        # noqa: BLE001
                failed(i, err)

    if spec.batch_seeds > 1:
        groups = _batch_groups(jobs, spec.batch_seeds)
        done = 0
        if spec.workers <= 1 or len(groups) <= 1:
            for idxs in groups:
                try:
                    for i, row in zip(idxs,
                                      run_batch_jobs([jobs[i]
                                                      for i in idxs])):
                        rows[i] = row
                except Exception as err:    # noqa: BLE001
                    batch_group_fallback(idxs, err)
                done += len(idxs)
                for i in idxs:
                    note(i, done)
        else:
            ctx = multiprocessing.get_context("spawn")
            with ProcessPoolExecutor(max_workers=spec.workers,
                                     mp_context=ctx) as pool:
                futures = {pool.submit(run_batch_jobs,
                                       [jobs[i] for i in idxs]): idxs
                           for idxs in groups}
                for fut in as_completed(futures):
                    idxs = futures[fut]
                    try:
                        for i, row in zip(idxs, fut.result()):
                            rows[i] = row
                    except Exception as err:    # noqa: BLE001
                        batch_group_fallback(idxs, err)
                    done += len(idxs)
                    for i in idxs:
                        note(i, done)
    elif spec.workers <= 1 or len(jobs) <= 1:
        for i, job in enumerate(jobs):
            try:
                rows[i] = run_job(job)
            except Exception as err:        # noqa: BLE001
                failed(i, err)
            note(i, i + 1)
    else:
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=spec.workers,
                                 mp_context=ctx) as pool:
            futures = {pool.submit(run_job, job): i
                       for i, job in enumerate(jobs)}
            done = 0
            for fut in as_completed(futures):
                i = futures[fut]
                try:
                    rows[i] = fut.result()
                except Exception as err:    # noqa: BLE001
                    failed(i, err)
                done += 1
                note(i, done)

    if jobs and all(r is None for r in rows):
        raise RuntimeError("every sweep job failed (see JOB FAILED lines)")
    return rows
