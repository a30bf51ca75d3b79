"""The port's examples (``examples/torch/``) run on the host at a smoke size,
in-process through each script's ``main(argv)``, and against the reference:

- quickstart's allocation equals ``repro.core.allocator.solve_resource`` on
  the same inputs (rtol 1e-4, atol capacity·1e-5) and its agent decision the
  reference's, from the same epoch snapshot;
- haf_serving's static and HAF summaries equal the reference's numpy
  ``Simulator.run`` at the same size, with one critic file read by both;
- train_100m's restart and losses equal the reference's ``train`` from the
  same initial weights (rtol 1e-4);
- critic_training's harvest size and its ungated run equal the
  reference's (numpy ``Simulator.run``, exactly);
- scenario_sweep's rows equal the reference's ``run_experiment`` of the
  same spec on its numpy engine, and its second run resumes every row;
- each raises a ``RuntimeError`` naming CUDA when asked for the card
  without one.
"""
import importlib.util
import math
import pathlib

import numpy as np
import pytest
import torch

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples" / "torch"
NAMES = ("quickstart", "haf_serving", "train_100m", "critic_training",
         "scenario_sweep")


def example(name):
    spec = importlib.util.spec_from_file_location(
        f"torch_example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_summary(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], float) and math.isnan(a[k]):
            assert math.isnan(b[k]), k
        else:
            assert a[k] == b[k], (k, a[k], b[k])


def test_quickstart_allocation_and_decision_equal_reference():
    import jax.numpy as jnp
    from repro.core.allocator import solve_resource as ref_solve
    from repro.core import HAFPlacement as RefHAF, make_agent as ref_agent
    from repro.sim import (Simulator, WorkloadConfig, generate_workload,
                           paper_scenario)
    from repro.sim.engine import DeadlineAwareAllocation, StaticPlacement
    qs = example("quickstart")
    out = qs.main(["--device", "cpu"])

    want = ref_solve(jnp.asarray(qs.PSI), jnp.asarray(qs.OMEGA),
                     jnp.asarray(qs.FLOORS), jnp.asarray(qs.CAPACITY))
    np.testing.assert_allclose(out["alloc"].numpy(), np.asarray(want.alloc),
                               rtol=1e-4, atol=qs.CAPACITY * 1e-5)
    assert out["floored"].tolist() == np.asarray(want.floored).tolist()
    assert bool(out["feasible"]) == bool(want.feasible)

    sc = paper_scenario()
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=400, seed=0),
        sc["work_models"])
    snaps = []
    Simulator(sc).run(reqs, StaticPlacement(), DeadlineAwareAllocation(),
                      epoch_hook=lambda rec, cl: snaps.append(rec.snapshot))
    decision = RefHAF(ref_agent("qwen3-32b-sim"), critic=None).decide(
        snaps[1])
    assert out["decision"] == decision.describe(sc["instances"],
                                                sc["nodes"])

    assert torch.isfinite(out["loss"]) and float(out["grad_norm"]) > 0
    assert out["logits"].shape == (2, 1, 256)
    assert torch.isfinite(out["logits"]).all()
    assert out["alloc"].device.type == "cpu"


def test_haf_serving_summaries_equal_reference_numpy(tmp_path):
    from repro.core import HAFPlacement as RefHAF, make_agent as ref_agent
    from repro.core.critic import Critic as RefCritic
    from repro.sim import (Simulator, WorkloadConfig, generate_workload,
                           paper_scenario)
    from repro.sim.engine import DeadlineAwareAllocation, StaticPlacement
    from repro_torch.core.critic import Critic, init_params
    path = tmp_path / "critic.json"
    Critic(init_params(0)).save(str(path))
    out = example("haf_serving").main(
        ["--device", "cpu", "--requests", "300", "--critic", str(path)])
    assert not out["critic_trained"]

    sc = paper_scenario()
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=300, seed=0),
        sc["work_models"])
    sim = Simulator(sc, epoch_interval=5.0)
    assert out["n_requests"] == len(reqs)
    same_summary(out["static"], sim.run(reqs, StaticPlacement(),
                                        DeadlineAwareAllocation()).summary())
    critic = RefCritic.load(str(path))
    assert critic.fingerprint() == out["critic"]
    haf = sim.run(reqs, RefHAF(ref_agent("qwen3-32b-sim"), critic=critic),
                  DeadlineAwareAllocation())
    same_summary(out["haf"], haf.summary())
    assert len(out["migrations"]) == len(haf.migrations)


def test_train_100m_records_the_injected_restart(monkeypatch, tmp_path):
    """``--steps 4 --fail-at 2`` at seq 16, batch 2: the restart and the
    six losses (two steps, then all four again from the fresh start) equal
    the reference's ``train`` at the same preset from the same weights, at
    rtol 1e-4 as in test_torch_train.  Both ``Model.init``s return the
    reference's initial parameters with ``wq`` / ``wk`` tempered as in
    test_torch_train: the reference draws them at a fan-in of the head
    count, and the attention logits so made carry float32 rounding into
    the loss at 3e-4 (untempered, the first loss is 2.7e-4 apart)."""
    import jax
    from repro.data.pipeline import DataPipeline as RefPipeline
    from repro.distributed.failure import FailureInjector as RefInjector
    from repro.launch.train import preset_config as ref_preset
    from repro.models.api import Model as RefModel
    from repro.train import loop as ref_loop
    from repro_torch import convert
    from repro_torch.models.api import Model
    rcfg = ref_preset("qwen2-0.5b", "100m")
    rmodel = RefModel(rcfg, remat="none")
    init = jax.tree.map(np.array, rmodel.init(jax.random.PRNGKey(0)))
    for key in ("wq", "wk"):
        init["layers"]["attn"][key] = init["layers"]["attn"][key] * 0.125
    monkeypatch.setattr(RefModel, "init", lambda self, key: jax.tree.map(
        jax.numpy.asarray, init))
    want = ref_loop.train(
        rmodel, RefPipeline(vocab_size=rcfg.vocab_size, seq_len=16,
                            global_batch=2),
        ref_loop.TrainConfig(steps=4, checkpoint_every=50,
                             checkpoint_dir=str(tmp_path), log_every=20),
        injector=RefInjector([2]), verbose=False)

    monkeypatch.setattr(Model, "init", lambda self, gen: (
        convert.params_from_numpy(self.cfg, init, device=self.device)))
    out = example("train_100m").main(
        ["--device", "cpu", "--steps", "4", "--seq-len", "16", "--batch",
         "2", "--fail-at", "2"])
    assert out["restarts"] == want["restarts"] == [2]
    assert len(out["loss"]) == len(want["loss"]) == 2 + 4
    for i, (got, ref) in enumerate(zip(out["loss"], want["loss"])):
        assert got == pytest.approx(ref, rel=1e-4), i
    assert all(p.device.type == "cpu" for p in out["params"])


def test_critic_training_trains_and_gates():
    """The harvest yields as many samples as the reference's at the same
    sizes, and the ungated run (which no critic touches) equals the
    reference's numpy ``Simulator.run`` exactly; the gated run completes."""
    from repro.core import HAFPlacement as RefHAF, make_agent as ref_agent
    from repro.core.datagen import harvest as ref_harvest
    from repro.sim import (Simulator, WorkloadConfig, generate_workload,
                           paper_scenario)
    from repro.sim.engine import DeadlineAwareAllocation
    out = example("critic_training").main(
        ["--device", "cpu", "--harvest-bulk", "150", "--harvest-probe",
         "150", "--epochs", "20", "--requests", "200"])

    sc = paper_scenario()
    assert out["n_samples"] == len(ref_harvest(sc, bulk_requests=150,
                                               probe_requests=150))
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=200, seed=0),
        sc["work_models"])
    want = Simulator(sc, epoch_interval=5.0).run(
        reqs, RefHAF(ref_agent("deepseek-r1-70b-sim"), critic=None),
        DeadlineAwareAllocation()).summary()
    same_summary(out["HAF-NoCritic"], want)
    gated = out["HAF(+Critic)"]
    assert 0.0 <= gated["overall"] <= 1.0 and not gated["truncated"]


def test_scenario_sweep_writes_runs_and_resumes(tmp_path,
                                                        monkeypatch):
    """The first run's rows equal the reference's ``run_experiment`` of the
    same spec on its numpy engine, ``overall`` and ``n_events`` row by row;
    the second run resumes all twelve.  The script's spawn workers are run
    in this process (``workers=1``: spawn re-imports ``__main__``), which
    the spec's identity excludes."""
    from repro.exp import ExperimentSpec as RefSpec
    from repro.exp import run_experiment as ref_run
    mod = example("scenario_sweep")
    real = mod.run_experiment
    monkeypatch.setattr(mod, "run_experiment", lambda spec, **kw: real(
        spec.replace(workers=1), **kw))
    out = mod.main(["--device", "cpu", "--out", str(tmp_path)])
    assert pathlib.Path(out["spec_file"]).is_file()
    assert pathlib.Path(out["report"]).is_file()
    first = out["first"]
    assert first["n_runs"] == 12 and first["n_failed"] == 0
    assert first["provenance"]["resumed_rows"] == 0
    assert out["resumed"] == out["again"]["n_runs"] == 12
    assert [r["overall"] for r in out["again"]["runs"]] == \
        [r["overall"] for r in first["runs"]]

    want = ref_run(RefSpec(                 # examples/scenario_sweep.py's
        name="scenario-sweep-demo", methods=("haf-static", "round-robin"),
        scenarios=("flash-crowd(magnitude=6.0)", "node-outage",
                   "dense-urban(n_nodes=12)"),
        seeds=(0, 1), n_ai_requests=400, workers=1,
        engine="numpy", out=str(tmp_path / "reference.json")))
    for key in ("identity_hash", "scenario_fingerprints"):
        assert first["provenance"][key] == want["provenance"][key], key

    def rows(report):
        return {(r["method"], r["scenario"], r["seed"]):
                (r["overall"], r["n_events"]) for r in report["runs"]}
    assert rows(first) == rows(want)


@pytest.mark.parametrize("name", NAMES)
def test_example_refuses_to_fall_back_to_the_cpu(name, monkeypatch,
                                                  tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--out", str(tmp_path)] if name == "scenario_sweep" else []
    with pytest.raises(RuntimeError, match="CUDA"):
        example(name).main(argv)
    assert not list(tmp_path.iterdir())
