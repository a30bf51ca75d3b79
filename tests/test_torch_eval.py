"""The port's fleet-evaluation harness (repro_torch.eval, obs CLI, serving
launcher) against the reference's.

Case for case the reference's ``tests/test_eval.py`` where the behaviour is
the same, each holding the port's rows to ``repro.eval``'s on the same
sweep.  The parity run is a small ``paper_table3`` experiment (all six
methods, the HAF cell gated by a critic the reference trained and saved
into the artifact store): the port's ``numpy`` engine, and its eager
``torch`` engine on the CPU at batch 2 (the stand-in for ``cuda``: the
same batched path with the kernel's plain version), must give rows whose
results are exactly the reference's ``numpy`` rows.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys
import tomllib

import numpy as np
import pytest

import repro.core.critic as ref_critic
import repro.eval as ref_eval
import repro.exp as ref_exp
import repro.obs.cli as ref_obs_cli
import repro_torch.eval.sweep as sweep_mod
from repro_torch.core.agent import ExternalLLMAgent
from repro_torch.core.features import FEATURE_DIM
from repro_torch.eval import (SweepSpec, aggregate, build_report, expand_jobs,
                              format_table, make_method, method_names,
                              run_job, run_sweep, write_report)
from repro_torch.eval import cli
from repro_torch.exp import ExperimentSpec, run_experiment
from repro_torch.faults.errors import (LLMCrashError, LLMEndpointError,
                                       LLMTimeoutError)
from repro_torch.launch.serve import make_llm_agent, make_llm_complete
from repro_torch.obs import cli as obs_cli

ROOT = pathlib.Path(__file__).resolve().parents[1]

MINI = SweepSpec(
    methods=("haf-static", "round-robin"),
    scenarios=("paper", {"family": "skewed-hetero",
                         "params": {"n_nodes": 4}}),
    seeds=(0, 1),
    n_ai_requests=120,
    workers=1,
    engine="numpy",
)
# timing columns, the only ones that may differ between two runs
TIMING = ("wall_s", "engine_wall_s", "events_per_sec")
# columns that say how a row ran, not what it computed
HOW = TIMING + ("engine", "batch", "b")


def _key(r):
    return (r["method"], r["scenario"], r["seed"])


def _results(rows, drop=HOW):
    return sorted(({k: v for k, v in r.items() if k not in drop}
                   for r in rows), key=_key)


@pytest.fixture(scope="module")
def mini_rows():
    return run_sweep(MINI)


def _ref_mini():
    kw = {f.name: getattr(MINI, f.name) for f in dataclasses.fields(MINI)
          if f.name != "device"}
    return ref_eval.SweepSpec(**kw)


def test_method_registry_covers_table3():
    assert set(method_names()) == set(ref_eval.method_names())
    assert {"haf", "haf-static", "round-robin", "lyapunov", "game-theory",
            "caora", "haf-llm"} <= set(method_names())
    for name in method_names():
        kw = {"cmd": "cat"} if name == "haf-llm" else {}
        placement, allocation, rr = make_method(name, **kw)
        ref_p, ref_a, ref_rr = ref_eval.make_method(name, **kw)
        assert type(placement).__name__ == type(ref_p).__name__
        assert type(allocation).__name__ == type(ref_a).__name__
        assert rr == ref_rr and isinstance(rr, bool)


def test_expand_jobs_is_full_product():
    jobs = expand_jobs(MINI)
    assert len(jobs) == 2 * 2 * 2
    keys = {(j["method"], j["scenario_label"], j["seed"]) for j in jobs}
    assert len(keys) == 8
    ref = ref_eval.expand_jobs(_ref_mini())
    assert [{k: v for k, v in j.items() if k != "device"} for j in jobs] \
        == ref


def test_mini_sweep_rows_equal_reference(mini_rows):
    assert len(mini_rows) == 8
    for row in mini_rows:
        for k in ("overall", "ran", "ai", "large_ai", "small_ai",
                  "mig_large", "mig_total", "method", "scenario", "seed",
                  "wall_s", "n_requests"):
            assert k in row, k
        assert 0.0 <= row["overall"] <= 1.0
    ref_rows = ref_eval.run_sweep(_ref_mini())
    assert _results(mini_rows, TIMING) == _results(ref_rows, TIMING)


def test_run_job_deterministic():
    job = expand_jobs(MINI)[0]
    a, b = run_job(dict(job)), run_job(dict(job))
    for k in ("overall", "ran", "ai", "mig_total", "n_events"):
        assert a[k] == b[k], k


def test_aggregate_mean_ci(mini_rows):
    cells = aggregate(mini_rows)
    assert len(cells) == 4
    for cell in cells:
        assert cell["seeds"] == [0, 1]
        for m in ("overall", "ran", "large_ai", "small_ai"):
            assert cell[m]["n"] == 2
            assert cell[m]["ci95"] >= 0.0
            assert 0.0 <= cell[m]["mean"] <= 1.0
        assert cell["mig_total"]["mean"] >= 0.0
    cell = next(c for c in cells if c["method"] == "haf-static"
                and c["scenario"] == "paper")
    manual = [r["overall"] for r in mini_rows
              if r["method"] == "haf-static" and r["scenario"] == "paper"]
    assert cell["overall"]["mean"] == pytest.approx(sum(manual) / 2)
    # the reference aggregates the same rows to the same cells
    drop = ("wall_s", "events_per_sec")
    assert [{k: v for k, v in c.items() if k not in drop} for c in cells] \
        == [{k: v for k, v in c.items() if k not in drop}
            for c in ref_eval.aggregate(mini_rows)]


def test_report_roundtrips_as_json(tmp_path, mini_rows):
    report = build_report(MINI, mini_rows)
    path = write_report(report, tmp_path / "report.json")
    loaded = json.loads(path.read_text())
    assert loaded["kind"] == "repro.eval.sweep_report"
    assert loaded["n_runs"] == 8
    assert len(loaded["aggregate"]) == 4
    assert loaded["spec"]["seeds"] == [0, 1]
    table = format_table(loaded["aggregate"])
    assert "haf-static" in table and "skewed-hetero" in table
    assert table == ref_eval.format_table(loaded["aggregate"])


def test_parallel_equals_serial():
    """workers=2 spawns processes that import torch: one test only."""
    spec = SweepSpec(methods=("haf-static",),
                     scenarios=("paper", "flash-crowd"),
                     seeds=(0,), n_ai_requests=100, workers=2,
                     engine="numpy")
    serial = run_sweep(dataclasses.replace(spec, workers=1))
    parallel = run_sweep(spec)
    assert _results(serial, TIMING) == _results(parallel, TIMING)


def test_unknown_method_raises():
    with pytest.raises(KeyError, match="unknown method"):
        make_method("definitely-not-a-method")


def test_batched_sweep_equals_serial(mini_rows):
    batched = run_sweep(dataclasses.replace(MINI, batch_seeds=2))
    assert _results(batched) == _results(mini_rows)
    assert {r["batch"] for r in batched} == {2}


def test_batched_sweep_partial_batches():
    spec = SweepSpec(methods=("haf-static",), scenarios=("paper",),
                     seeds=(0, 1, 2), n_ai_requests=100, batch_seeds=2,
                     engine="numpy")
    rows = run_sweep(spec)
    assert sorted(r["seed"] for r in rows) == [0, 1, 2]
    assert sorted(r["batch"] for r in rows) == [1, 2, 2]


def test_attach_scenarios_builds_each_cell_once(monkeypatch):
    spec = SweepSpec(methods=("haf-static", "round-robin"),
                     scenarios=("paper",), seeds=(0, 1),
                     n_ai_requests=100, engine="numpy")
    jobs = sweep_mod.expand_jobs(spec)
    calls = []
    real = sweep_mod.scenario_for_job

    def counting(job):
        calls.append(job["family"])
        return real(job)

    monkeypatch.setattr(sweep_mod, "scenario_for_job", counting)
    sweep_mod.attach_scenarios(jobs)
    assert len(calls) == 1
    assert all("scenario" in j for j in jobs)
    row = sweep_mod.run_job(jobs[0])
    assert len(calls) == 1
    assert 0.0 <= row["overall"] <= 1.0


# --------------------------------------------------------------------------- #
# the cuda engine's routing (what runs on the card, driven here on the CPU)
# --------------------------------------------------------------------------- #
@pytest.fixture
def cuda_on_cpu(monkeypatch):
    """Stand the card in with the eager torch block core on the CPU: a
    ``cuda`` block runs ``TorchBatchedEventCore("cpu")`` where the kernel
    core would run, the solo ``torch`` core must not be reached, and every
    ``run_batch`` records (B, engine).  The sweep's device preparation is
    recorded as ("prepared", engine)."""
    import repro_torch.sim.engine as engine_mod
    from repro_torch.sim.event_core import TorchBatchedEventCore

    calls = []
    real_block, real_solo = (engine_mod.make_batched_event_core,
                             engine_mod.make_event_core)
    real_run_batch = engine_mod.Simulator.run_batch

    def block_core(engine, device="cuda"):
        if engine == "cuda":
            return TorchBatchedEventCore("cpu")
        return real_block(engine, device)

    def solo_core(engine, device="cuda"):
        assert engine != "torch", "the solo torch core ran a cuda job"
        return real_solo(engine, device)

    def run_batch(self, workloads, *args, **kw):
        calls.append((len(workloads), kw.get("engine") or self.engine
                      or "cuda"))
        return real_run_batch(self, workloads, *args, **kw)

    monkeypatch.setattr(engine_mod, "make_batched_event_core", block_core)
    monkeypatch.setattr(engine_mod, "make_event_core", solo_core)
    monkeypatch.setattr(engine_mod.Simulator, "run_batch", run_batch)
    monkeypatch.setattr(sweep_mod, "_prepare_device",
                        lambda engine, device: calls.append(("prepared",
                                                             engine)))
    return calls


def test_cuda_sweep_at_batch_1_runs_one_replica_blocks(cuda_on_cpu,
                                                      mini_rows):
    """At batch 1 a cuda sweep's jobs run as one-replica ``run_batch``
    blocks on the cuda core — never the solo torch core — after the
    device is prepared, and their rows are the numpy rows."""
    rows = run_sweep(dataclasses.replace(MINI, engine="cuda"))
    assert cuda_on_cpu == [("prepared", "cuda")] + [(1, "cuda")] * 8
    assert all(r["engine"] == "cuda" and "batch_fallback" not in r
               for r in rows)
    assert _results(rows) == _results(mini_rows)


def test_run_job_on_cuda_is_a_one_replica_run_batch(cuda_on_cpu,
                                                   mini_rows):
    job = expand_jobs(dataclasses.replace(MINI, engine="cuda"))[0]
    row = run_job(job)
    assert cuda_on_cpu == [(1, "cuda")] and row["engine"] == "cuda"
    assert _results([row]) == [r for r in _results(mini_rows)
                               if _key(r) == _key(row)]


def test_solo_run_on_cuda_is_a_one_replica_run_batch(cuda_on_cpu):
    """``Simulator(sc).run`` (engine None, i.e. cuda) is ``run_batch`` of
    one replica: the same outcome as the numpy solo run."""
    from repro_torch.sim import Simulator, make_scenario, workload_for
    from repro_torch.sim.engine import (DeadlineAwareAllocation,
                                        StaticPlacement)
    sc = make_scenario("paper", seed=0)
    reqs = workload_for(sc, seed=3, n_ai_requests=150)[0]
    got = Simulator(sc).run(reqs, StaticPlacement(),
                            DeadlineAwareAllocation())
    want = Simulator(sc, engine="numpy").run(reqs, StaticPlacement(),
                                             DeadlineAwareAllocation())
    assert cuda_on_cpu == [(1, "cuda")] and got.engine == "cuda"
    assert (got.summary(), got.n_events, got.migrations) == \
        (want.summary(), want.n_events, want.migrations)
    np.testing.assert_allclose([r.finish for r in got.requests],
                               [r.finish for r in want.requests],
                               rtol=0, atol=1e-9)


def test_serve_main_runs_a_one_replica_block_on_cuda(cuda_on_cpu, capsys):
    """The serving launcher's solo run is the cuda engine's one-replica
    block: where the card is, one event_step launch a tick."""
    from repro_torch.launch import serve
    res = serve.main(["--requests", "60", "--no-critic"])
    assert cuda_on_cpu == [(1, "cuda")] and res.engine == "cuda"
    printed = capsys.readouterr().out
    summary = json.loads(printed[printed.index("{"):
                                 printed.index("}") + 1])
    assert summary == json.loads(json.dumps(res.summary()))
    assert not res.truncated and 0.0 < summary["overall"] <= 1.0


# --------------------------------------------------------------------------- #
# Table III: the port's rows are the reference's
# --------------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def table3(tmp_path_factory):
    """The reference's numpy run of a cut paper_table3 experiment, with a
    critic the reference trained and saved into a fresh store."""
    store = tmp_path_factory.mktemp("store")
    rng = np.random.default_rng(1)
    samples = [(rng.normal(size=FEATURE_DIM).astype(np.float32),
                rng.uniform(size=3).astype(np.float32),
                np.ones(3, np.float32)) for _ in range(40)]
    critic = ref_critic.train_critic(samples, epochs=30, hidden=16, seed=0)
    ref_exp.save_critic(critic, store / "critic.json", families=("paper",))
    path = ROOT / "experiments" / "paper_table3.toml"
    cut = dict(n_ai_requests=150, seeds=(0, 1), workers=1, engine="numpy",
               out=None)
    mp = pytest.MonkeyPatch()
    mp.setenv("REPRO_ARTIFACTS", str(store))
    ref = ref_exp.ExperimentSpec.from_dict(
        tomllib.loads(path.read_text())).replace(**cut)
    report = ref_exp.run_experiment(ref, resume=False)
    yield ExperimentSpec.from_file(path).replace(**cut), report, critic
    mp.undo()


@pytest.mark.parametrize("engine,batch", (("numpy", 1), ("torch", 2)))
def test_table3_rows_equal_reference(table3, engine, batch):
    spec, ref_report, critic = table3
    report = run_experiment(spec.replace(engine=engine, batch=batch),
                            resume=False, device="cpu")
    assert report["n_runs"] == 12 and report["n_failed"] == 0
    assert report["provenance"]["resume_key"] == \
        ref_report["provenance"]["resume_key"]
    art = report["provenance"]["artifacts"]["@critic?"]
    assert art["fingerprint"] == critic.fingerprint() and "missing" not in art
    assert {r["engine"] for r in report["runs"]} == {engine}
    assert not any(r.get("critic_degraded") or r.get("batch_fallback")
                   for r in report["runs"])
    assert _results(report["runs"]) == _results(ref_report["runs"])
    drop = ("wall_s", "events_per_sec")
    assert [{k: v for k, v in c.items() if k not in drop}
            for c in report["aggregate"]] == \
        [{k: v for k, v in c.items() if k not in drop}
         for c in ref_report["aggregate"]]
    haf = [r for r in report["runs"] if r["method"] == "HAF"]
    assert sum(r["mig_total"] for r in haf) >= 1


# --------------------------------------------------------------------------- #
# obs CLI over the port's traces
# --------------------------------------------------------------------------- #
def test_obs_cli_summary_reads_a_sweep_trace(tmp_path, capsys):
    out = tmp_path / "r.json"
    assert cli.main(["--engine", "numpy", "--methods", "haf",
                     "--scenarios", "paper", "--seeds", "1",
                     "--requests", "100", "--workers", "1", "--trace",
                     "--metrics-interval", "5", "--out", str(out)]) == 0
    traces = sorted((tmp_path / "r_traces").glob("*.jsonl"))
    assert len(traces) == 1
    capsys.readouterr()
    assert obs_cli.main(["summary", str(traces[0])]) == 0
    text = capsys.readouterr().out
    assert "event totals" in text and "completion" in text
    assert ref_obs_cli.main(["summary", str(traces[0])]) == 0
    assert capsys.readouterr().out == text
    assert obs_cli.main(["chrome", str(traces[0]), "-o",
                         str(tmp_path / "t.json")]) == 0
    assert json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    capsys.readouterr()
    assert obs_cli.main(["timeseries", str(out)]) == 0
    assert "rerun with --metrics-interval" in capsys.readouterr().out


# --------------------------------------------------------------------------- #
# the serving launcher's endpoint adapter
# --------------------------------------------------------------------------- #
def test_llm_crash_error_carries_stderr_tail():
    cmd = (f"{sys.executable} -c "
           "'import sys; sys.stderr.write(\"kaboom detail\"); sys.exit(3)'")
    complete = make_llm_complete(cmd, retries=0)
    with pytest.raises(LLMCrashError) as ei:
        complete("prompt")
    assert ei.value.kind == "crash"
    assert "kaboom detail" in ei.value.stderr_tail
    assert isinstance(ei.value, LLMEndpointError)


def test_llm_timeout_error():
    cmd = f"{sys.executable} -c 'import time; time.sleep(5)'"
    complete = make_llm_complete(cmd, timeout=0.2, retries=0)
    with pytest.raises(LLMTimeoutError) as ei:
        complete("prompt")
    assert ei.value.kind == "timeout"


def test_llm_complete_retries_then_succeeds(tmp_path):
    marker = tmp_path / "ok"
    cmd = (f"{sys.executable} -c \"import os, sys; p = {str(marker)!r}; "
           "(print('[]') if os.path.exists(p) "
           "else (open(p, 'w').close(), sys.exit(9)))\"")
    sleeps = []
    complete = make_llm_complete(cmd, retries=2, backoff_s=0.01,
                                 sleep=sleeps.append)
    assert complete("prompt").strip() == "[]"
    assert sleeps == [0.01]
    # a crash on every attempt uses every retry, then raises the crash
    sleeps.clear()
    failing = make_llm_complete(f"{sys.executable} -c 'raise SystemExit(4)'",
                                retries=2, backoff_s=0.01,
                                sleep=sleeps.append)
    with pytest.raises(LLMCrashError):
        failing("prompt")
    assert len(sleeps) == 2


def test_make_llm_agent_and_the_serve_command_line():
    cmd = f"{sys.executable} {ROOT / 'tests' / 'mock_llm.py'}"
    agent = make_llm_agent(cmd, timeout=30.0)
    assert isinstance(agent, ExternalLLMAgent)
    assert agent.name == f"external({cmd})"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--help"],
        capture_output=True, text=True, timeout=120,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": ""})
    assert proc.returncode == 0 and "--critic-path" in proc.stdout
