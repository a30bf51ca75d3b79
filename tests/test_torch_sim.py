"""The ported fast-timescale path as a whole: repro_torch.sim against repro.sim.

For every ported scenario family the two packages must build the same
scenario and the same workload field by field, and the port's host engine
must reproduce the reference's numpy engine EXACTLY (summary, event count,
drops, per-request finish times and routing, migrations) under HAF-Static,
solo and batched.  The eager torch engine on the CPU is held to the device
bar: discrete outcomes equal, finish times ``rtol=0, atol=1e-9``.
"""
import dataclasses
import enum
import math

import numpy as np
import pytest

import repro.sim as ref_sim
import repro.sim.engine as ref_engine
import repro.sim.types as ref_types
import repro_torch.sim as port_sim
import repro_torch.sim.engine as port_engine
import repro_torch.sim.types as port_types
from repro_torch import convert

FAMILIES = ("dense-urban", "diurnal", "diurnal-flash", "flash-crowd",
            "heavy-tail", "node-outage", "paper", "skewed-hetero",
            "spot-churn", "trace")
SLOW_FAMILIES = ("paper", "node-outage", "dense-urban")
SEEDS = (0, 1)
BATCH_SEEDS = (0, 1, 2)
N_REQ = 120


def _plain(obj):
    """Dataclasses -> dicts, enums -> values, tuples kept: what crosses
    between the packages."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def _fingerprint(res):
    summary = {k: None if isinstance(v, float) and math.isnan(v) else v
               for k, v in res.summary().items()}
    return (summary, res.n_events, res.infeasible_events,
            sorted(res.dropped),
            [(r.rid, r.finish, r.target_sid) for r in res.requests],
            [(t, a.sid, a.src, a.dst, a.category.value)
             for t, a in res.migrations])


def _haf_static(engine_mod):
    return engine_mod.StaticPlacement(), engine_mod.DeadlineAwareAllocation()


def _solo(pkg, engine_mod, family, seed, engine="numpy", n=N_REQ,
          placement=None, **kw):
    sc = pkg.make_scenario(family, seed=0)
    reqs, _ = pkg.workload_for(sc, seed=seed, n_ai_requests=n)
    pl, al = _haf_static(engine_mod)
    sim_kw = {k: kw.pop(k) for k in ("drop_expired",) if k in kw}
    if pkg is port_sim:
        sim_kw["device"] = "cpu"
    sim = pkg.Simulator(sc, engine=engine, **sim_kw)
    return sim.run(reqs, placement or pl, al, **kw)


def _batch(pkg, engine_mod, family, seeds, engine="numpy", n=N_REQ,
           placements=None, **kw):
    sc = pkg.make_scenario(family, seed=0)
    wl = [pkg.workload_for(sc, seed=s, n_ai_requests=n)[0] for s in seeds]
    sim_kw = {k: kw.pop(k) for k in ("drop_expired",) if k in kw}
    if pkg is port_sim:
        sim_kw["device"] = "cpu"
    sim = pkg.Simulator(sc, engine=engine, **sim_kw)
    return sim.run_batch(
        wl, placements or (lambda b: engine_mod.StaticPlacement()),
        lambda b: engine_mod.DeadlineAwareAllocation(), **kw)


# --------------------------------------------------------------------------- #
# scenario + workload agree field by field
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_scenario_and_workload_equal(family, seed):
    ref_sc = ref_sim.make_scenario(family, seed=seed)
    port_sc = port_sim.make_scenario(family, seed=seed)
    assert _plain(ref_sc) == _plain(port_sc)
    assert ref_sim.scenario_fingerprint(ref_sc) == \
        port_sim.scenario_fingerprint(port_sc)
    ref_reqs, ref_meta = ref_sim.workload_for(ref_sc, seed=seed,
                                              n_ai_requests=N_REQ)
    port_reqs, port_meta = port_sim.workload_for(port_sc, seed=seed,
                                                 n_ai_requests=N_REQ)
    assert [_plain(r) for r in ref_reqs] == [_plain(r) for r in port_reqs]
    assert _plain(ref_meta) == _plain(port_meta)
    # and the plain form rebuilds the port's own objects
    rebuilt = convert.scenario_from_plain(_plain(ref_sc))
    assert port_sim.scenario_fingerprint(rebuilt) == \
        port_sim.scenario_fingerprint(port_sc)
    assert convert.requests_from_records(
        [_plain(r) for r in ref_reqs]) == port_reqs
    assert convert.requests_from_records(
        [dataclasses.astuple(r) for r in ref_reqs[:5]]) == port_reqs[:5]


# --------------------------------------------------------------------------- #
# host engine: exactly the reference's numpy engine
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_engine_solo_equals_reference(family, seed):
    want = _fingerprint(_solo(ref_sim, ref_engine, family, seed))
    got = _fingerprint(_solo(port_sim, port_engine, family, seed))
    assert got == want


@pytest.mark.parametrize("family", FAMILIES)
def test_numpy_engine_run_batch_equals_reference(family):
    want = [_fingerprint(r)
            for r in _batch(ref_sim, ref_engine, family, BATCH_SEEDS)]
    got = [_fingerprint(r)
           for r in _batch(port_sim, port_engine, family, BATCH_SEEDS)]
    assert got == want
    solos = [_fingerprint(_solo(port_sim, port_engine, family, s))
             for s in BATCH_SEEDS]
    assert got == solos                       # batched ≡ solo in the port


@pytest.mark.parametrize("family", SLOW_FAMILIES)
def test_scalar_engine_equals_reference_numpy(family):
    want = _fingerprint(_solo(ref_sim, ref_engine, family, 0))
    assert _fingerprint(_solo(port_sim, port_engine, family, 0,
                              engine="scalar")) == want
    want_b = [_fingerprint(r)
              for r in _batch(ref_sim, ref_engine, family, BATCH_SEEDS)]
    got_b = [_fingerprint(r) for r in _batch(
        port_sim, port_engine, family, BATCH_SEEDS, engine="scalar")]
    assert got_b == want_b


def _device_bar(got, want):
    """Discrete outcomes equal; finish times within 1e-9 (the reference's
    bar for its device cores)."""
    assert _fingerprint(got)[:4] == _fingerprint(want)[:4]
    fa = np.array([r.finish for r in want.requests])
    fb = np.array([r.finish for r in got.requests])
    np.testing.assert_allclose(fb, fa, rtol=0, atol=1e-9)
    assert [r.target_sid for r in got.requests] == \
        [r.target_sid for r in want.requests]


@pytest.mark.parametrize("family", SLOW_FAMILIES)
def test_torch_engine_on_cpu_solo(family):
    want = _solo(ref_sim, ref_engine, family, 0)
    got = _solo(port_sim, port_engine, family, 0, engine="torch")
    assert got.engine == "torch"
    _device_bar(got, want)


@pytest.mark.parametrize("family", SLOW_FAMILIES)
def test_torch_engine_on_cpu_run_batch(family):
    want = _batch(ref_sim, ref_engine, family, BATCH_SEEDS)
    got = _batch(port_sim, port_engine, family, BATCH_SEEDS, engine="torch")
    for g, w in zip(got, want):
        _device_bar(g, w)


# --------------------------------------------------------------------------- #
# the PlacementPolicy seam: epoch commit + migration without core/
# --------------------------------------------------------------------------- #
class ScriptedPlacement:
    """{epoch: (instance name, destination node)} — the same script drives
    both packages; ``action_cls`` is the package's own MigrationAction."""
    name = "scripted"

    def __init__(self, script, action_cls):
        self.script = dict(script)
        self.action_cls = action_cls
        self.last_shortlist = []

    def decide(self, snap):
        want = self.script.get(snap.epoch)
        if want is None:
            return None
        name, dst = want
        for inst in snap.instances:
            if inst.name == name:
                src = int(snap.placement[inst.sid])
                if src == dst:
                    return None
                return self.action_cls(sid=inst.sid, src=src, dst=dst)
        return None


SCRIPT = {1: ("large0", 1), 2: ("small1", 0), 3: ("small0", 2)}


def test_scripted_migrations_solo_and_batched_equal_reference():
    def pol(types_mod):
        return ScriptedPlacement(SCRIPT, types_mod.MigrationAction)

    want = [_solo(ref_sim, ref_engine, "paper", s, n=150,
                  placement=pol(ref_types)) for s in BATCH_SEEDS]
    assert any(len(r.migrations) >= 1 for r in want)    # it really moves
    got = [_solo(port_sim, port_engine, "paper", s, n=150,
                 placement=pol(port_types)) for s in BATCH_SEEDS]
    assert [_fingerprint(r) for r in got] == [_fingerprint(r) for r in want]
    assert [len(r.epochs) for r in got] == [len(r.epochs) for r in want]
    batch = _batch(port_sim, port_engine, "paper", BATCH_SEEDS, n=150,
                   placements=lambda b: pol(port_types))
    assert [_fingerprint(r) for r in batch] == \
        [_fingerprint(r) for r in want]
    tb = _batch(port_sim, port_engine, "paper", BATCH_SEEDS, n=150,
                engine="torch", placements=lambda b: pol(port_types))
    for g, w in zip(tb, want):
        _device_bar(g, w)
        assert [(t, a.sid, a.dst) for t, a in g.migrations] == \
            [(t, a.sid, a.dst) for t, a in w.migrations]


def test_drop_expired_flash_crowd_equals_reference():
    want = _solo(ref_sim, ref_engine, "flash-crowd", 0, n=300,
                 drop_expired=True)
    got = _solo(port_sim, port_engine, "flash-crowd", 0, n=300,
                drop_expired=True)
    assert _fingerprint(got) == _fingerprint(want)
    batch = _batch(port_sim, port_engine, "flash-crowd", BATCH_SEEDS, n=300,
                   drop_expired=True)
    want_b = _batch(ref_sim, ref_engine, "flash-crowd", BATCH_SEEDS, n=300,
                    drop_expired=True)
    assert [_fingerprint(r) for r in batch] == \
        [_fingerprint(r) for r in want_b]


def test_max_events_truncation_equals_reference():
    want = [_solo(ref_sim, ref_engine, "paper", s, max_events=400)
            for s in BATCH_SEEDS]
    got = _batch(port_sim, port_engine, "paper", BATCH_SEEDS, max_events=400)
    for w, g in zip(want, got):
        assert w.truncated and g.truncated
        assert _fingerprint(g) == _fingerprint(w)


def test_streamed_run_equals_materialized():
    """Windowed heap refill without retaining requests: same outcome."""
    sc = port_sim.make_scenario("paper", seed=0)
    reqs, _ = port_sim.workload_for(sc, seed=1, n_ai_requests=N_REQ)
    stream = port_sim.workload_stream_for(sc, seed=1, n_ai_requests=N_REQ,
                                          window=16)
    sim = port_sim.Simulator(sc, engine="numpy", device="cpu")
    a = sim.run(reqs, *_haf_static(port_engine))
    b = sim.run(stream, *_haf_static(port_engine), retain_requests=False)
    assert a.summary() == b.summary() and a.n_events == b.n_events
    assert b.requests == []


def test_profiler_splits_device_core_phases():
    """obs-on ≡ obs-off, and the torch core reports h2d / kernel / d2h."""
    from repro_torch import obs
    sc = port_sim.make_scenario("paper", seed=0)
    wl = [port_sim.workload_for(sc, seed=s, n_ai_requests=60)[0]
          for s in (0, 1)]
    sim = port_sim.Simulator(sc, engine="torch", device="cpu")
    mk = (lambda b: port_engine.StaticPlacement(),
          lambda b: port_engine.DeadlineAwareAllocation())
    off = sim.run_batch(wl, *mk)
    on = sim.run_batch(wl, *mk, obs=obs.ObsConfig(profile=True))
    assert [_fingerprint(r) for r in on] == [_fingerprint(r) for r in off]
    phases = on[0].profile["phases"]
    for name in ("core.h2d", "core.kernel", "core.d2h", "engine.step"):
        assert phases[name]["count"] > 0
