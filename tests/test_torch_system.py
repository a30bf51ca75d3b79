"""End-to-end behaviour of the paper's system through the port (Tables
II/III shape): ``tests/test_system.py`` run on ``repro_torch``.

Small workloads (runtime-bounded); the port's host engine (``engine=
"numpy"``), which is the reference's numpy engine bit for bit, so the
summaries are also held equal to the reference's on the same scenario and
workload.  The paper's qualitative claims hold end to end:
  H1 (Table III): HAF beats the static placement by fixing the binding
      large-AI consolidation with a large-AI migration.
  H2 (Table II):  the critic prunes migrations and never hurts a noisy
      agent; it approves the decisive early migration (skipped without a
      trained critic artifact, as in the reference).
  H3 (Fig. 2):    the HAF advantage shrinks at ρ=1.25 (capacity-limited).
"""
import pathlib

import pytest

from repro_torch.core import HAFPlacement, make_agent
from repro_torch.core.critic import Critic
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             paper_scenario)
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement
from repro_torch.sim.types import InstanceCategory

CRITIC_PATH = pathlib.Path(__file__).resolve().parents[1] / "artifacts" / \
    "critic.json"
ENGINE = "numpy"


@pytest.fixture(scope="module")
def scenario():
    return paper_scenario()


@pytest.fixture(scope="module")
def workload(scenario):
    wcfg = WorkloadConfig(rho=1.0, n_ai_requests=1500, seed=0)
    return generate_workload(wcfg, scenario["work_models"])[0]


@pytest.fixture(scope="module")
def critic(scenario):
    if CRITIC_PATH.exists():
        return Critic.load(str(CRITIC_PATH))
    pytest.skip("no trained critic artifact (run benchmarks.critic_data)")


def _sim(scenario):
    return Simulator(scenario, epoch_interval=5.0, engine=ENGINE)


def test_haf_beats_static(scenario, workload):
    sim = _sim(scenario)
    static = sim.run(workload, StaticPlacement(),
                     DeadlineAwareAllocation()).summary()
    haf = sim.run(workload,
                  HAFPlacement(make_agent("qwen3-32b-sim"), critic=None),
                  DeadlineAwareAllocation()).summary()
    assert haf["overall"] > static["overall"] + 0.10
    assert haf["large_ai"] > static["large_ai"] + 0.30
    assert haf["mig_large"] >= 1           # the binding migration happened
    assert static["small_ai"] > 0.95       # small-AI never the bottleneck


def test_haf_and_static_equal_reference(scenario, workload):
    """The same scenario and workload through the reference: equal
    summaries (the host engines are bit for bit each other's)."""
    import repro.core as ref_core
    import repro.sim as ref_sim
    import repro.sim.engine as ref_engine
    ref_sc = ref_sim.paper_scenario()
    ref_wl = ref_sim.generate_workload(
        ref_sim.WorkloadConfig(rho=1.0, n_ai_requests=1500, seed=0),
        ref_sc["work_models"])[0]
    ref = ref_sim.Simulator(ref_sc, epoch_interval=5.0)
    sim = _sim(scenario)
    for ref_pl, pl in (
            (ref_engine.StaticPlacement(), StaticPlacement()),
            (ref_core.HAFPlacement(ref_core.make_agent("qwen3-32b-sim"),
                                   critic=None),
             HAFPlacement(make_agent("qwen3-32b-sim"), critic=None))):
        want = ref.run(ref_wl, ref_pl,
                       ref_engine.DeadlineAwareAllocation()).summary()
        got = sim.run(workload, pl, DeadlineAwareAllocation()).summary()
        assert got == want


def test_critic_gates_noisy_agent(scenario, workload, critic):
    sim = _sim(scenario)
    agent = "deepseek-r1-70b-sim"          # eager/noisy stand-in
    nc = sim.run(workload, HAFPlacement(make_agent(agent), critic=None),
                 DeadlineAwareAllocation()).summary()
    wc = sim.run(workload, HAFPlacement(make_agent(agent), critic=critic),
                 DeadlineAwareAllocation()).summary()
    assert wc["mig_total"] < nc["mig_total"]          # fewer migrations
    assert wc["overall"] >= nc["overall"] - 0.02      # never hurts


def test_critic_approves_decisive_migration(scenario, workload, critic):
    sim = _sim(scenario)
    res = sim.run(workload,
                  HAFPlacement(make_agent("qwen3-32b-sim"), critic=critic),
                  DeadlineAwareAllocation())
    large_migs = [a for _, a in res.migrations
                  if a.category == InstanceCategory.LARGE_AI]
    assert len(large_migs) >= 1
    assert res.summary()["overall"] > 0.85


def test_advantage_shrinks_at_saturation(scenario):
    sim = _sim(scenario)
    gaps = {}
    for rho in (1.0, 1.25):
        wcfg = WorkloadConfig(rho=rho, n_ai_requests=1200, seed=1)
        reqs, _ = generate_workload(wcfg, scenario["work_models"])
        s = sim.run(reqs, StaticPlacement(),
                    DeadlineAwareAllocation()).summary()
        h = sim.run(reqs,
                    HAFPlacement(make_agent("qwen3-32b-sim"), critic=None),
                    DeadlineAwareAllocation()).summary()
        gaps[rho] = h["ai"] - s["ai"]
    assert gaps[1.25] < gaps[1.0]          # capacity-limited convergence
