"""repro_torch.faults and repro_torch.sim.tracefile against the reference.

The fault scripts are pure functions of their seeds, so the port's must give
exactly the reference's schedules, draws and fail/ok splits; the retry loop
must make the same attempts and sleeps under a fake clock.  The trace reader
must parse the checked-in trace into the same rows and requests, the writer
and its CLI must write the same bytes, and the two families these modules
feed — ``spot-churn`` and ``trace`` — must run in the port's host engine
exactly as in the reference's (forced migrations included), solo and
batched, with the port's eager torch engine bit for bit its host engine.
"""
import dataclasses
import enum
import io
import math
import pathlib
from contextlib import redirect_stdout

import numpy as np
import pytest

import repro.faults as ref_faults
import repro.sim as ref_sim
import repro.sim.engine as ref_engine
import repro.sim.tracefile as ref_trace
import repro_torch.faults as port_faults
import repro_torch.sim as port_sim
import repro_torch.sim.engine as port_engine
import repro_torch.sim.tracefile as port_trace

TRACE = str(pathlib.Path(__file__).resolve().parents[1]
            / "experiments" / "traces" / "synthetic_2k.csv")
SEEDS = (0, 1)
N_REQ = 200


def _plain(obj):
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return {f.name: _plain(getattr(obj, f.name))
                for f in dataclasses.fields(obj)}
    if isinstance(obj, enum.Enum):
        return obj.value
    if isinstance(obj, dict):
        return {k: _plain(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_plain(v) for v in obj)
    return obj


def _fingerprint(res):
    summary = {k: None if isinstance(v, float) and math.isnan(v) else v
               for k, v in res.summary().items()}
    return (summary, res.n_events, res.infeasible_events,
            sorted(res.dropped),
            [(r.rid, r.finish, r.target_sid) for r in res.requests],
            [(t, a.sid, a.src, a.dst, a.forced) for t, a in res.migrations])


# --------------------------------------------------------------------------- #
# errors
# --------------------------------------------------------------------------- #
def test_error_taxonomy_equals_reference():
    names = ("LLMEndpointError", "LLMCrashError", "LLMTimeoutError",
             "LLMMalformedError")
    for name in names:
        ref_cls, port_cls = getattr(ref_faults, name), getattr(port_faults,
                                                               name)
        assert port_cls.kind == ref_cls.kind
        assert [c.__name__ for c in port_cls.__mro__] == \
            [c.__name__ for c in ref_cls.__mro__]
        err = port_cls("boom", stderr_tail="tail")
        assert isinstance(err, port_faults.LLMEndpointError)
        assert isinstance(err, RuntimeError)
        assert (str(err), err.stderr_tail) == ("boom", "tail")
    assert port_faults.MalformedShortlistError is \
        port_faults.LLMMalformedError
    assert port_faults.__all__ == ref_faults.__all__


# --------------------------------------------------------------------------- #
# scripts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed", (0, 3, 11))
@pytest.mark.parametrize("n_nodes,horizon,kw", (
    (6, 100.0, {}),
    (6, 800.0, {"n_preemptions": 5, "down_s": 20.0, "notice_s": 0.0}),
    (3, 50.0, {"flaps": 3, "flap_scale": 0.25, "scale": 0.1}),
    (40, 1234.5, {"n_preemptions": 7, "window": (0.0, 1.0), "flaps": 2}),
))
def test_churn_schedule_equals_reference(seed, n_nodes, horizon, kw):
    want = ref_faults.churn_schedule(seed, n_nodes, horizon, **kw)
    got = port_faults.churn_schedule(seed, n_nodes, horizon, **kw)
    assert got == want and len(got) > 0


def test_fault_draw_and_flaky_split_equal_reference():
    prompts = [f"prompt {i} " * (i % 5 + 1) for i in range(64)]
    for seed in (0, 1, 7):
        assert [port_faults.fault_draw(p, seed) for p in prompts] == \
            [ref_faults.fault_draw(p, seed) for p in prompts]

    def split(mod, rate, seed):
        fc = mod.flaky_complete(lambda p: "ok:" + p, rate, seed=seed)
        out = []
        for p in prompts:
            try:
                out.append(fc(p))
            except mod.LLMCrashError as err:
                out.append(("crash", str(err)))
        return out

    for rate, seed in ((0.5, 0), (0.2, 3), (0.0, 1), (1.0, 2)):
        got = split(port_faults, rate, seed)
        assert got == split(ref_faults, rate, seed)
    assert {type(x) for x in split(port_faults, 0.5, 0)} == {str, tuple}
    fc = port_faults.flaky_complete(lambda p: p, 1.0,
                                    error=port_faults.LLMTimeoutError)
    with pytest.raises(port_faults.LLMTimeoutError):
        fc("x")


# --------------------------------------------------------------------------- #
# retry
# --------------------------------------------------------------------------- #
def _retry_trace(mod, policy_kw, fail_first, err_name="LLMCrashError",
                 attempt_cost=0.0):
    """Drive call_with_retries with a fake clock: (outcome, calls, sleeps)."""
    clock = {"t": 0.0}
    calls, sleeps = [], []

    def fake_sleep(s):
        sleeps.append(s)
        clock["t"] += s

    def fn():
        calls.append(clock["t"])
        clock["t"] += attempt_cost
        if len(calls) <= fail_first:
            raise getattr(mod, err_name)("boom")
        return "ok"

    try:
        out = mod.call_with_retries(fn, mod.RetryPolicy(**policy_kw),
                                    sleep=fake_sleep,
                                    clock=lambda: clock["t"])
    except mod.LLMEndpointError as err:
        out = (type(err).__name__, err.kind)
    return out, calls, sleeps


@pytest.mark.parametrize("policy_kw,fail_first,err,cost", (
    ({"retries": 2, "backoff_s": 0.25}, 2, "LLMCrashError", 0.0),   # b, 2b
    ({"retries": 2, "backoff_s": 0.1}, 99, "LLMTimeoutError", 0.0),  # spent
    ({"retries": 10, "backoff_s": 1.0, "deadline_s": 3.0}, 99,
     "LLMCrashError", 1.0),                                          # wall
    ({"retries": 6, "backoff_s": 0.5, "deadline_s": 4.2}, 4,
     "LLMTimeoutError", 0.3),                    # deadline clips the sleep
    ({"retries": 5}, 99, "LLMMalformedError", 0.0),       # never retried
    ({"retries": 0}, 1, "LLMCrashError", 0.0),            # fail fast
))
def test_call_with_retries_equals_reference(policy_kw, fail_first, err,
                                            cost):
    got = _retry_trace(port_faults, policy_kw, fail_first, err, cost)
    want = _retry_trace(ref_faults, policy_kw, fail_first, err, cost)
    assert got == want
    if err == "LLMMalformedError":
        assert len(got[1]) == 1 and got[2] == []
    if fail_first == 2 and err == "LLMCrashError":
        assert got == ("ok", [0.0, 0.25, 0.75], [0.25, 0.5])


def test_with_retries_wraps_a_completion():
    seen = []

    def complete(prompt):
        seen.append(prompt)
        if len(seen) < 2:
            raise port_faults.LLMCrashError("first call dies")
        return prompt.upper()

    sleeps = []
    wrapped = port_faults.with_retries(
        complete, port_faults.RetryPolicy(retries=1, backoff_s=0.5),
        sleep=sleeps.append)
    assert wrapped("go") == "GO"
    assert seen == ["go", "go"] and sleeps == [0.5]


# --------------------------------------------------------------------------- #
# tracefile
# --------------------------------------------------------------------------- #
def test_parse_class_map_equals_reference():
    for text in ("", "chat=small,batch=large", " a = large , , b=small "):
        assert port_trace.parse_class_map(text) == \
            ref_trace.parse_class_map(text)
    for bad in ("chat", "chat=huge"):
        with pytest.raises(ValueError):
            port_trace.parse_class_map(bad)


@pytest.mark.parametrize("chunk,limit", ((4096, None), (97, None),
                                         (128, 500)))
def test_read_trace_chunks_and_metadata_equal_reference(chunk, limit):
    want = list(ref_trace.read_trace_chunks(TRACE, chunk=chunk, limit=limit))
    got = list(port_trace.read_trace_chunks(TRACE, chunk=chunk, limit=limit))
    assert got == want
    assert port_trace.trace_metadata(TRACE, limit=limit) == \
        ref_trace.trace_metadata(TRACE, limit=limit)


def test_trace_metadata_rejects_unsorted(tmp_path):
    path = tmp_path / "bad.csv"
    path.write_text("arrival,cls,prompt_tokens,output_tokens\n"
                    "2.0,large,10,10\n1.0,small,10,10\n")
    with pytest.raises(ValueError, match="not sorted"):
        port_trace.trace_metadata(str(path))


@pytest.mark.parametrize("spec,seed,n", (
    ({"file": TRACE, "speedup": 2.0}, 0, None),
    ({"file": TRACE, "class_map": "large=small,small=large",
      "n_cells": 3}, 1, 300),
    ({"file": ""}, 5, 400),                      # built-in synthetic trace
))
def test_trace_stream_equals_reference_and_restarts(spec, seed, n):
    ref_models = ref_sim.make_scenario("paper", seed=0)["work_models"]
    port_models = port_sim.make_scenario("paper", seed=0)["work_models"]
    want = ref_trace.trace_stream(spec, ref_models, seed=seed, n_requests=n)
    got = port_trace.trace_stream(spec, port_models, seed=seed,
                                  n_requests=n)
    assert (got.horizon, got.n_requests, got.info) == \
        (want.horizon, want.n_requests, want.info)
    rows = [_plain(r) for chunk in got.chunks() for r in chunk]
    assert rows == [_plain(r) for chunk in want.chunks() for r in chunk]
    assert len(rows) == got.n_requests
    arrivals = [r["arrival"] for r in rows]
    assert arrivals == sorted(arrivals)
    # restartable: a second pass realizes the same requests
    assert [_plain(r) for chunk in got.chunks() for r in chunk] == rows


@pytest.mark.parametrize("name,kw", (
    ("t.csv", {"n_requests": 700, "seed": 3}),
    ("t.jsonl", {"n_requests": 300, "seed": 0, "duration": 120.0,
                 "large_fraction": 0.6, "diurnal_depth": 0.2,
                 "chunk": 64}),
))
def test_write_synthetic_trace_bytes_equal_reference(tmp_path, name, kw):
    a, b = tmp_path / ("ref_" + name), tmp_path / ("port_" + name)
    ref_trace.write_synthetic_trace(str(a), **kw)
    port_trace.write_synthetic_trace(str(b), **kw)
    assert b.read_bytes() == a.read_bytes()
    assert port_trace.trace_metadata(str(b))[0] == kw["n_requests"]


def test_tracefile_cli_writes_the_reference_file(tmp_path):
    argv = ["--n", "500", "--seed", "2", "--duration", "300",
            "--large-fraction", "0.5", "--depth", "0.4"]
    outs = []
    for mod, name in ((ref_trace, "ref.csv"), (port_trace, "port.csv")):
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert mod.main([str(tmp_path / name)] + argv) == 0
        outs.append(buf.getvalue().replace(name, "<path>"))
    assert (tmp_path / "port.csv").read_bytes() == \
        (tmp_path / "ref.csv").read_bytes()
    assert outs[0] == outs[1] and "wrote 500 rows" in outs[1]


# --------------------------------------------------------------------------- #
# the two families these modules feed
# --------------------------------------------------------------------------- #
def _run(pkg, engine_mod, family, seeds, engine="numpy", batched=False):
    sc = pkg.make_scenario(family, seed=0)
    wl = [pkg.workload_for(sc, seed=s, n_ai_requests=N_REQ)[0]
          for s in seeds]
    kw = {"device": "cpu"} if pkg is port_sim else {}
    sim = pkg.Simulator(sc, engine=engine, **kw)
    if batched:
        return sim.run_batch(wl, lambda b: engine_mod.StaticPlacement(),
                             lambda b: engine_mod.DeadlineAwareAllocation())
    return [sim.run(w, engine_mod.StaticPlacement(),
                    engine_mod.DeadlineAwareAllocation()) for w in wl]


@pytest.mark.parametrize("family", ("spot-churn", "trace"))
def test_family_runs_equal_reference(family):
    ref_sc = ref_sim.make_scenario(family, seed=0)
    port_sc = port_sim.make_scenario(family, seed=0)
    assert port_sim.scenario_fingerprint(port_sc) == \
        ref_sim.scenario_fingerprint(ref_sc)
    want = [_fingerprint(r)
            for r in _run(ref_sim, ref_engine, family, SEEDS)]
    solo = _run(port_sim, port_engine, family, SEEDS)
    assert [_fingerprint(r) for r in solo] == want
    batch = _run(port_sim, port_engine, family, SEEDS, batched=True)
    assert [_fingerprint(r) for r in batch] == want
    # the eager torch engine (the cuda engine's plain version) bit for bit
    tb = _run(port_sim, port_engine, family, SEEDS, engine="torch",
              batched=True)
    assert [_fingerprint(r) for r in tb] == want
    assert tb[0].engine == "torch"


def test_forced_vs_elective_scripted_migration():
    """The reference's scripted du3 → n0 move: forced under the seed-0
    preemption notice, elective on the clean topology."""
    from repro.core.controller import ScriptedPlacement as RefScripted
    from repro_torch.core.controller import ScriptedPlacement

    def scripted(pkg, engine_mod, pol_cls, family):
        sc = pkg.make_scenario(family, seed=0, n_ai_requests=N_REQ) \
            if family == "spot-churn" else pkg.make_scenario(family)
        reqs, _ = pkg.workload_for(sc, seed=0, n_ai_requests=N_REQ)
        kw = {"device": "cpu"} if pkg is port_sim else {}
        return pkg.Simulator(sc, engine="numpy", **kw).run(
            reqs, pol_cls({1: ("du3", 0)}),
            engine_mod.DeadlineAwareAllocation())

    for family, forced in (("spot-churn", True), ("paper", False)):
        got = scripted(port_sim, port_engine, ScriptedPlacement, family)
        want = scripted(ref_sim, ref_engine, RefScripted, family)
        assert _fingerprint(got) == _fingerprint(want)
        assert [(a.src, a.dst, a.forced) for _, a in got.migrations] == \
            [(3, 0, forced)]
        assert got.summary()["mig_forced"] == int(forced)


def test_churn_capacity_visible_in_port_snapshots():
    sc = port_sim.make_scenario("spot-churn", seed=0, n_ai_requests=N_REQ,
                                n_preemptions=1, flaps=2, flap_scale=0.5)
    assert sum(1 for ev in sc["churn"] if ev["scale"] == 0.5) == 2
    reqs, _ = port_sim.workload_for(sc, seed=0, n_ai_requests=N_REQ)
    seen = []
    port_sim.Simulator(sc, engine="numpy").run(
        reqs, port_engine.StaticPlacement(),
        port_engine.DeadlineAwareAllocation(),
        epoch_hook=lambda rec, cl: seen.append(cl.node_scale.copy()))
    assert 0.5 in {float(s) for row in seen for s in row}
    assert np.all(np.asarray(seen[-1]) == 1.0)
