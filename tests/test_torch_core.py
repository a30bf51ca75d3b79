"""The port's slow timescale (repro_torch.core) against the reference.

Every module of the epoch step — features, placement, prompts, agents,
critic, controller — and the baselines and critic-data harvest are held
to ``repro.core`` on the same inputs: snapshots come from each package's
own Simulator run of the same scenario and seed (those runs are bit for bit
equal), and critics are the reference's own saved artifacts.  Host paths
must be bitwise equal; the torch training forward and one Adam step are
held to ``1e-6`` of the JAX reference.  End to end, HAF (agent-only and
critic-gated) and the five baselines must run in the port's host engine
exactly as in the reference's, batched ≡ solo, and in the port's eager
torch engine (the CPU stand-in for the cuda engine: same wrapper, plain
kernel version) bit for bit as in its host engine.
"""
import functools
import json
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

import repro.core.agent as ref_agent
import repro.core.baselines as ref_base
import repro.core.controller as ref_ctrl
import repro.core.critic as ref_critic
import repro.core.datagen as ref_datagen
import repro.core.features as ref_feat
import repro.core.placement as ref_place
import repro.core.prompts as ref_prompts
import repro.exp.artifacts as ref_art
import repro.faults as ref_faults
import repro.sim as ref_sim
import repro.sim.engine as ref_engine
import repro_torch.core.agent as port_agent
import repro_torch.core.baselines as port_base
import repro_torch.core.controller as port_ctrl
import repro_torch.core.critic as port_critic
import repro_torch.core.datagen as port_datagen
import repro_torch.core.features as port_feat
import repro_torch.core.placement as port_place
import repro_torch.core.prompts as port_prompts
import repro_torch.exp.artifacts as port_art
import repro_torch.faults as port_faults
import repro_torch.sim as port_sim
import repro_torch.sim.engine as port_engine

sys.path.insert(0, str(pathlib.Path(__file__).parent))
import mock_llm  # noqa: E402  (imports no repro: a plain stand-in endpoint)

N_REQ = 400
SNAP_FAMILIES = ("paper", "node-outage", "spot-churn")
HAF_FAMILIES = ("paper", "flash-crowd", "node-outage")
SEEDS = (0, 1)
# the reference's harvest settings for its batch-invariance test
HARVEST_KW = dict(bulk_runs=((1.0, 2), (0.75, 5)), bulk_requests=200,
                  probe_requests=200, probe_epochs_pre=(1, 2),
                  probe_epochs_post=(3,))

REF = dict(sim=ref_sim, engine=ref_engine, agent=ref_agent,
           ctrl=ref_ctrl, base=ref_base, critic=ref_critic)
PORT = dict(sim=port_sim, engine=port_engine, agent=port_agent,
            ctrl=port_ctrl, base=port_base, critic=port_critic)


def _ids(actions):
    return [port_place.action_id(a) for a in actions]


def _fingerprint(res):
    summary = {k: None if isinstance(v, float) and math.isnan(v) else v
               for k, v in res.summary().items()}
    return (summary, res.n_events, res.infeasible_events,
            sorted(res.dropped), res.truncated,
            [(r.rid, r.finish, r.target_sid) for r in res.requests],
            [(t, a.sid, a.src, a.dst, a.forced) for t, a in res.migrations])


def _simulator(pkg, sc, engine="numpy"):
    kw = {"device": "cpu"} if pkg is PORT else {}
    return pkg["sim"].Simulator(sc, engine=engine, **kw)


@functools.lru_cache(maxsize=None)
def _snapshots(family):
    """(reference, port) snapshots of every epoch of a HAF-Static run."""
    # spot-churn sizes its churn window by the stream it is built for
    kw = {"n_ai_requests": N_REQ} if family == "spot-churn" else {}
    out = []
    for pkg in (REF, PORT):
        sc = pkg["sim"].make_scenario(family, seed=0, **kw)
        reqs, _ = pkg["sim"].workload_for(sc, seed=0, n_ai_requests=N_REQ)
        snaps = []
        _simulator(pkg, sc).run(
            reqs, pkg["engine"].StaticPlacement(),
            pkg["engine"].DeadlineAwareAllocation(),
            epoch_hook=lambda rec, cl: snaps.append(rec.snapshot))
        out.append(snaps)
    assert len(out[0]) == len(out[1]) >= 8
    return tuple(out)


def _pairs(family, every=1):
    ref, port = _snapshots(family)
    return list(zip(ref, port))[::every]


@pytest.fixture(scope="module")
def critic_files(tmp_path_factory):
    """Critics trained and saved by the reference (its batched-HAF test's
    recipe), one file per architecture."""
    rng = np.random.default_rng(1)
    samples = [(rng.normal(size=port_feat.FEATURE_DIM).astype(np.float32),
                rng.uniform(size=3).astype(np.float32),
                np.ones(3, np.float32)) for _ in range(40)]
    root = tmp_path_factory.mktemp("critics")
    paths = {}
    for arch in ("factored", "mlp"):
        critic = ref_critic.train_critic(samples, epochs=30, hidden=16,
                                         seed=0, arch=arch)
        paths[arch] = str(root / f"{arch}.json")
        critic.save(paths[arch])
    return paths


def _critics(files, arch="factored"):
    """(reference, port) loads of the same reference-saved file."""
    return (ref_critic.Critic.load(files[arch]),
            port_critic.Critic.load(files[arch]))


# --------------------------------------------------------------------------- #
# features, placement, prompts
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("family", SNAP_FAMILIES)
def test_candidates_and_features_equal_reference(family):
    churn_rows = 0
    for ref_snap, port_snap in _pairs(family):
        ref_c = ref_place.candidate_actions(ref_snap)
        port_c = port_place.candidate_actions(port_snap)
        assert _ids(port_c) == [ref_place.action_id(a) for a in ref_c]
        for movable in ((port_place.MOVABLE, ref_place.MOVABLE),
                        (port_base.BASELINE_MOVABLE,
                         ref_base.BASELINE_MOVABLE)):
            assert _ids(port_place.candidate_actions(
                port_snap, movable=movable[0])) == _ids(
                ref_place.candidate_actions(ref_snap, movable=movable[1]))
        got = port_feat.featurize_batch(port_snap, port_c)
        want = ref_feat.featurize_batch(ref_snap, ref_c)
        assert got.dtype == np.float32 and got.shape == \
            (len(port_c), port_feat.FEATURE_DIM)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(port_feat.node_blocks(port_snap),
                                      ref_feat.node_blocks(ref_snap))
        for a_p, a_r in list(zip(port_c, ref_c))[:6]:
            np.testing.assert_array_equal(port_feat.featurize(port_snap, a_p),
                                          ref_feat.featurize(ref_snap, a_r))
        for a in port_c[1:4]:
            tok = port_place.action_id(a)
            assert port_place.parse_action_id(tok, port_c) == a
        churn = got[:, port_feat.CHURN:port_feat.CHURN + 3]
        churn_rows += int(churn.any(axis=1).sum())
    # the churn block is non-zero only under churn, and then somewhere
    assert (churn_rows > 0) == (family == "spot-churn")


@pytest.mark.parametrize("family", ("paper", "spot-churn"))
def test_prompt_text_equals_reference(family):
    for ref_snap, port_snap in _pairs(family, every=3):
        ref_c = ref_place.candidate_actions(ref_snap)
        port_c = port_place.candidate_actions(port_snap)
        for K in (1, 3, 5):
            assert port_prompts.build_prompt(port_snap, port_c, K) == \
                ref_prompts.build_prompt(ref_snap, ref_c, K)


REPLIES = (
    '["mig:s12:n0->n1", "no-migration"]',
    '```json\n["{a}", "{b}"]\n```',
    'I would pick {b} then {a}; maybe no-migration.',
    '["no-migration"]',
    '["{a}", "{a}", "{b}", "{c}", "{d}"]',
    '[1, 2, 3]',
    '[not json',
    'I cannot help with that.',
    '',
    None,
)


@pytest.mark.parametrize("reply", REPLIES)
def test_parse_response_equals_reference(reply):
    ref_snap, port_snap = _pairs("paper")[2]
    ref_c = ref_place.candidate_actions(ref_snap)
    port_c = port_place.candidate_actions(port_snap)
    ids = _ids(port_c[1:5])
    text = None if reply is None else reply.format(
        a=ids[0], b=ids[1], c=ids[2], d=ids[3])
    for K in (2, 3):
        got = port_prompts.parse_response(text, port_c, K)
        want = ref_prompts.parse_response(text, ref_c, K)
        assert _ids(got) == [ref_place.action_id(a) for a in want]


# --------------------------------------------------------------------------- #
# agents
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name", sorted(port_agent.AGENT_ZOO))
def test_standin_scores_and_shortlists_equal_reference(name):
    assert port_agent.AGENT_ZOO[name].__dict__ == \
        ref_agent.AGENT_ZOO[name].__dict__
    pairs = _pairs("paper") + _pairs("spot-churn", every=2)
    for seed in SEEDS:
        p_ag = port_agent.make_agent(name, seed=seed)
        r_ag = ref_agent.make_agent(name, seed=seed)
        assert p_ag.batch_key() == r_ag.batch_key()
        ps, rs, pc, rc = [], [], [], []
        for ref_snap, port_snap in pairs:
            port_c = port_place.candidate_actions(port_snap)
            ref_c = ref_place.candidate_actions(ref_snap)
            migs_p = [a for a in port_c if a is not None]
            migs_r = [a for a in ref_c if a is not None]
            got = p_ag.score_candidates(port_snap, migs_p)
            want = r_ag.score_candidates(ref_snap, migs_r)
            np.testing.assert_array_equal(got, want)
            assert _ids(p_ag.shortlist(port_snap, port_c, 3)) == \
                _ids(r_ag.shortlist(ref_snap, ref_c, 3))
            ps.append(port_snap)
            rs.append(ref_snap)
            pc.append(port_c)
            rc.append(ref_c)
        got_b = p_ag.shortlist_batch(ps, pc, K=4)
        assert [_ids(s) for s in got_b] == \
            [_ids(s) for s in r_ag.shortlist_batch(rs, rc, K=4)]
        assert [_ids(s) for s in got_b] == \
            [_ids(p_ag.shortlist(s, c, 4)) for s, c in zip(ps, pc)]
    with pytest.raises(KeyError):
        port_agent.make_agent("no-such-agent")


def _mock_complete(prompt):
    """In process, the answer tests/mock_llm.py writes for ``prompt``."""
    return json.dumps(mock_llm.shortlist(prompt))


def test_external_llm_agent_equals_reference():
    seen = []
    for ref_snap, port_snap in _pairs("paper", every=2):
        port_c = port_place.candidate_actions(port_snap)
        ref_c = ref_place.candidate_actions(ref_snap)
        p_ag = port_agent.ExternalLLMAgent(_mock_complete, name="mock")
        r_ag = ref_agent.ExternalLLMAgent(_mock_complete, name="mock")
        assert p_ag.batch_key() is None
        got = p_ag.shortlist(port_snap, port_c, 3)
        assert _ids(got) == _ids(r_ag.shortlist(ref_snap, ref_c, 3))
        assert p_ag.last_prompt == r_ag.last_prompt
        assert p_ag.last_response == r_ag.last_response
        assert got[-1] is None and len(got) <= 3
        seen.append(len(got))
    assert max(seen) > 1                     # the mock really proposes moves
    snap = _pairs("paper")[1][1]
    cands = port_place.candidate_actions(snap)
    garbage = port_agent.ExternalLLMAgent(lambda p: "I refuse.")
    with pytest.raises(port_faults.MalformedShortlistError) as ei:
        garbage.shortlist(snap, cands)
    assert ei.value.kind == "malformed"
    stay = port_agent.ExternalLLMAgent(lambda p: '["no-migration"]')
    assert stay.shortlist(snap, cands) == [None]


# --------------------------------------------------------------------------- #
# critic
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ("factored", "mlp"))
def test_reference_critic_loads_scores_and_saves_identically(
        arch, tmp_path, critic_files):
    ref_c, port_c = _critics(critic_files, arch)
    assert port_c.fingerprint() == ref_c.fingerprint()
    assert port_c.class_weights == ref_c.class_weights
    path = critic_files[arch]
    # re-saving gives the reference's bytes, and the reference reads it back
    port_c.save(str(tmp_path / "port.json"))
    assert (tmp_path / "port.json").read_bytes() == \
        pathlib.Path(path).read_bytes()
    assert ref_critic.Critic.load(str(tmp_path / "port.json")) \
        .fingerprint() == ref_c.fingerprint()
    # deployment forward and Eq. 11 selection, bitwise
    pairs = _pairs("paper") + _pairs("spot-churn", every=2)
    p_opts, r_opts = [], []
    for ref_snap, port_snap in pairs:
        pc = port_place.candidate_actions(port_snap)
        rc = ref_place.candidate_actions(ref_snap)
        x = port_feat.featurize_batch(port_snap, pc)
        np.testing.assert_array_equal(
            port_critic.forward_np(port_c.params_np, x),
            ref_critic.forward_np(ref_c.params_np, x))
        np.testing.assert_array_equal(port_c.predict_batch(port_snap, pc),
                                      ref_c.predict_batch(ref_snap, rc))
        p_opts.append(pc[:1 + len(p_opts) % 5])
        r_opts.append(rc[:1 + len(r_opts) % 5])
    p_snaps = [p for _, p in pairs]
    r_snaps = [r for r, _ in pairs]
    got, got_s = port_c.select_batch(p_snaps, p_opts)
    want, want_s = ref_c.select_batch(r_snaps, r_opts)
    assert _ids(got) == _ids(want)
    for g, w in zip(got_s, want_s):
        np.testing.assert_array_equal(g, w)
    for snap, opts, choice, scores in zip(p_snaps, p_opts, got, got_s):
        c1, s1 = port_c.select(snap, opts)      # solo ≡ batched
        assert c1 == choice
        np.testing.assert_array_equal(s1, scores)


def test_manifests_interchange_with_reference(tmp_path, critic_files):
    ref_c, port_c = _critics(critic_files)
    port_art.save_critic(port_c, tmp_path / "p.json", families=["paper"],
                         data_hash="abc", meta={"epochs": 30})
    man = ref_art.read_manifest(tmp_path / "p.json")
    assert man["fingerprint"] == ref_c.fingerprint()
    assert (man["families"], man["data_hash"], man["artifact_kind"]) == \
        (["paper"], "abc", "critic")
    ref_art.save_critic(ref_c, tmp_path / "r.json")
    assert port_art.read_manifest(tmp_path / "r.json")["fingerprint"] == \
        port_c.fingerprint()
    assert port_art.read_manifest(tmp_path / "none.json") is None
    cached = port_critic.load_critic_cached(
        str(tmp_path / "r.json"), expect_fingerprint=port_c.fingerprint())
    assert cached is port_critic.load_critic_cached(str(tmp_path / "r.json"))
    with pytest.raises(port_art.FingerprintMismatch):
        port_critic.load_critic_cached(str(tmp_path / "r.json"),
                                       expect_fingerprint="0" * 64)
    (tmp_path / "bad.json.manifest.json").write_text('{"kind": "other"}')
    with pytest.raises(port_art.ArtifactError):
        port_art.read_manifest(tmp_path / "bad.json")


def _batch_arrays(n=96, seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, port_feat.FEATURE_DIM)).astype(np.float32)
    x[:, port_critic.MIG_FLAG] = rng.random(n) < 0.6
    r = rng.uniform(size=(n, 3)).astype(np.float32)
    m = (rng.random((n, 3)) < 0.8).astype(np.float32) * \
        np.float32([3.0, 1.0, 1.0])
    return x, r, m


@pytest.mark.parametrize("arch", ("factored", "mlp"))
def test_torch_training_forward_within_1e6_of_reference(arch,
                                                         critic_files):
    import jax.numpy as jnp
    ref_c, port_c = _critics(critic_files, arch)
    x, _, _ = _batch_arrays()
    want = np.asarray(ref_critic.forward(ref_c.params, jnp.asarray(x)))
    net = port_critic.CriticNet.from_params(port_c.params)
    assert isinstance(net, torch.nn.Module)
    got = net(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    # and the frozen net's tree round-trips through nn.Linear's [out, in]
    params = net.params()
    for part, leaves in params.items():
        for k, v in leaves.items():
            np.testing.assert_array_equal(v, port_c.params[part][k])
    first = net.net if arch == "mlp" else net.delta
    assert first.l1.weight.shape == (16, port_feat.FEATURE_DIM)  # [out, in]


@pytest.mark.parametrize("steps", (1, 3))
def test_adam_steps_within_1e6_of_reference(steps, critic_files):
    import jax.numpy as jnp
    ref_c, port_c = _critics(critic_files)
    x, r, m = _batch_arrays()
    params = ref_c.params
    opt = ref_critic._adam_init(params)
    net = port_critic.CriticNet.from_params(port_c.params)
    state = port_critic.adam_init(net)
    for i in range(steps):
        sl = slice(i * 32, i * 32 + 48)
        params, opt, want_loss = ref_critic._train_step(
            params, opt, jnp.asarray(x[sl]), jnp.asarray(r[sl]),
            jnp.asarray(m[sl]))
        got_loss = port_critic.train_step(
            net, state, torch.from_numpy(x[sl]), torch.from_numpy(r[sl]),
            torch.from_numpy(m[sl]))
        np.testing.assert_allclose(float(got_loss), float(want_loss),
                                   rtol=1e-6)
    got = net.params()
    for part in ("base", "delta"):
        for k in ("w1", "b1", "w2", "b2", "w3", "b3"):
            want = np.asarray(params[part][k])
            scale = float(np.abs(want).max())
            np.testing.assert_allclose(got[part][k], want, rtol=1e-6,
                                       atol=1e-6 * scale)
            if k.startswith("w"):        # the update is not a no-op
                assert not np.array_equal(want, ref_c.params[part][k])


@functools.lru_cache(maxsize=None)
def _harvests(batch_size=8, engine="numpy"):
    sc_r = ref_sim.make_scenario("paper", seed=0)
    sc_p = port_sim.make_scenario("paper", seed=0)
    ref = ref_datagen.harvest(sc_r, batch_size=8, **HARVEST_KW)
    port = port_datagen.harvest(sc_p, batch_size=batch_size, engine=engine,
                                device="cpu", **HARVEST_KW)
    return ref, port


def _held_out_loss(critic, x, r, m):
    pred = port_critic.forward_np(critic.params_np, x)
    return float(np.sum((pred - r) ** 2 * m) / max(np.sum(m), 1.0))


def test_train_critic_on_cpu_reaches_the_references_held_out_loss():
    samples = _harvests()[1]
    n = len(samples)
    order = np.random.default_rng(0).permutation(n)
    cut = int(0.8 * n)
    train = [samples[i] for i in order[:cut]]
    xs, rs, ms = port_critic.stack_samples([samples[i]
                                            for i in order[cut:]])
    kw = dict(hidden=16, epochs=40, batch=64, seed=0)
    port_c = port_critic.train_critic(train, device="cpu", **kw)
    ref_c = ref_critic.train_critic(train, **kw)
    untrained = port_critic.Critic(port_critic.init_params(0, 16))
    got = _held_out_loss(port_c, xs, rs, ms)
    want = _held_out_loss(ref_c, xs, rs, ms)
    base = _held_out_loss(untrained, xs, rs, ms)
    assert got < base
    # stated bar: the port's held-out loss within 1.5x the reference's
    # (different initial weights, same data, order and optimiser)
    assert got <= 1.5 * want, (got, want, base)
    # and the same seed trains the same weights again
    again = port_critic.train_critic(train, device="cpu", **kw)
    assert again.fingerprint() == port_c.fingerprint()


def test_train_critic_without_a_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default trains on it")
    samples = [(np.zeros(port_feat.FEATURE_DIM, np.float32),
                np.ones(3, np.float32), np.ones(3, np.float32))] * 4
    with pytest.raises(RuntimeError, match="CUDA"):
        port_critic.train_critic(samples, epochs=1)


def test_epoch_records_to_samples_equal_reference():
    runs = []
    for pkg in (REF, PORT):
        sc = pkg["sim"].make_scenario("paper", seed=0)
        reqs, _ = pkg["sim"].workload_for(sc, seed=3, n_ai_requests=N_REQ)
        runs.append(_simulator(pkg, sc).run(
            reqs, pkg["ctrl"].RandomPlacement(seed=3, cooldown=2),
            pkg["engine"].DeadlineAwareAllocation()))
    assert len(runs[1].migrations) >= 1
    for horizon in (None, 1, 4):
        want = ref_critic.epoch_records_to_samples(runs[0].epochs, horizon)
        got = port_critic.epoch_records_to_samples(runs[1].epochs, horizon)
        assert len(got) == len(want) > 5
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------- #
# controller
# --------------------------------------------------------------------------- #
def _haf(pkg, agent, seed=0, critic=None, **kw):
    return pkg["ctrl"].HAFPlacement(pkg["agent"].make_agent(agent, seed=seed),
                                    critic=critic, **kw)


@pytest.mark.parametrize("gated", (False, True))
@pytest.mark.parametrize("name", sorted(port_agent.AGENT_ZOO))
def test_decide_group_equals_looped_decide_and_reference(name, gated,
                                                         critic_files):
    ref_c, port_c = _critics(critic_files) if gated else (None, None)
    pairs = _pairs("paper") + _pairs("node-outage", every=2)
    solo = [_haf(PORT, name, critic=port_c) for _ in pairs]
    group = [_haf(PORT, name, critic=port_c) for _ in pairs]
    refs = [_haf(REF, name, critic=ref_c) for _ in pairs]
    assert len({p.batch_key() for p in group}) == 1
    looped = [pol.decide(p) for pol, (_, p) in zip(solo, pairs)]
    batched = port_ctrl.HAFPlacement.decide_group(group,
                                                  [p for _, p in pairs])
    want = [pol.decide(r) for pol, (r, _) in zip(refs, pairs)]
    assert _ids(batched) == _ids(looped) == _ids(want)
    for a, b, w in zip(solo, group, refs):
        assert _ids(a.last_shortlist) == _ids(b.last_shortlist) == \
            _ids(w.last_shortlist)
        assert a.last_margin == b.last_margin == w.last_margin
        if gated:
            np.testing.assert_array_equal(a.last_scores, b.last_scores)
            np.testing.assert_array_equal(a.last_scores, w.last_scores)
        else:
            assert a.last_scores is b.last_scores is w.last_scores is None
    if gated:
        assert any(m is not None for m in (p.last_margin for p in group))


def test_degradation_ladder_equals_reference():
    pairs = _pairs("paper")[:8]
    out = {}
    for tag, pkg, faults in (("port", PORT, port_faults),
                             ("ref", REF, ref_faults)):
        flaky = faults.flaky_complete(_mock_complete, 0.5, seed=0)
        fb = pkg["agent"].make_agent("qwen3-32b-sim")
        pol = pkg["ctrl"].HAFPlacement(
            pkg["agent"].ExternalLLMAgent(flaky), fallback_agent=fb)
        snaps = [p if tag == "port" else r for r, p in pairs]
        rows = []
        for snap in snaps:
            rows.append((port_place.action_id(pol.decide(snap)),
                         pol.last_degraded))
        out[tag] = rows
        # without a fallback the endpoint's error propagates
        bare = pkg["ctrl"].HAFPlacement(pkg["agent"].ExternalLLMAgent(
            faults.flaky_complete(_mock_complete, 1.0)))
        with pytest.raises(faults.LLMCrashError):
            bare.decide(snaps[0])
    assert out["port"] == out["ref"]
    reasons = [r for _, r in out["port"]]
    assert "crash" in reasons and None in reasons


def test_degraded_epochs_are_counted_in_a_run():
    def run(pkg, faults):
        sc = pkg["sim"].make_scenario("paper", seed=0)
        reqs, _ = pkg["sim"].workload_for(sc, seed=0, n_ai_requests=200)
        pol = pkg["ctrl"].HAFPlacement(
            pkg["agent"].ExternalLLMAgent(
                faults.flaky_complete(_mock_complete, 0.5, seed=1)),
            fallback_agent=pkg["agent"].make_agent("qwen3-32b-sim"))
        return _simulator(pkg, sc).run(
            reqs, pol, pkg["engine"].DeadlineAwareAllocation())

    got, want = run(PORT, port_faults), run(REF, ref_faults)
    assert _fingerprint(got) == _fingerprint(want)
    assert got.degraded == want.degraded and got.degraded


def test_scripted_and_random_placements_equal_reference():
    for ref_snap, port_snap in _pairs("paper")[:6]:
        for script in ({1: ("large0", 1)}, {2: ("du0", 1)},
                       {3: ("nope", 1)}):
            got = port_ctrl.ScriptedPlacement(script).decide(port_snap)
            want = ref_ctrl.ScriptedPlacement(script).decide(ref_snap)
            assert _ids([got]) == _ids([want])
    p_rand = port_ctrl.RandomPlacement(seed=4, cooldown=1)
    r_rand = ref_ctrl.RandomPlacement(seed=4, cooldown=1)
    got = [p_rand.decide(p) for _, p in _pairs("paper")]
    want = [r_rand.decide(r) for r, _ in _pairs("paper")]
    assert _ids(got) == _ids(want)
    assert any(a is not None for a in got)


# --------------------------------------------------------------------------- #
# end to end: HAF and the five baselines through the simulator
# --------------------------------------------------------------------------- #
def _haf_runs(pkg, family, critic, engine="numpy", batched=False):
    sc = pkg["sim"].make_scenario(family, seed=0)
    wl = [pkg["sim"].workload_for(sc, seed=s, n_ai_requests=N_REQ)[0]
          for s in SEEDS]
    sim = _simulator(pkg, sc, engine)
    alloc = pkg["engine"].DeadlineAwareAllocation
    if batched:
        return sim.run_batch(
            wl, lambda b: _haf(pkg, "qwen3-32b-sim", critic=critic),
            lambda b: alloc())
    return [sim.run(w, _haf(pkg, "qwen3-32b-sim", critic=critic), alloc())
            for w in wl]


@pytest.mark.parametrize("gated", (False, True))
@pytest.mark.parametrize("family", HAF_FAMILIES)
def test_haf_runs_equal_reference(family, gated, critic_files):
    ref_c, port_c = _critics(critic_files) if gated else (None, None)
    want = [_fingerprint(r) for r in _haf_runs(REF, family, ref_c)]
    solo = [_fingerprint(r) for r in _haf_runs(PORT, family, port_c)]
    assert solo == want
    batched = _haf_runs(PORT, family, port_c, batched=True)
    assert [_fingerprint(r) for r in batched] == want
    dev = _haf_runs(PORT, family, port_c, engine="torch", batched=True)
    assert dev[0].engine == "torch"
    assert [_fingerprint(r) for r in dev] == want
    assert [len(r.epochs) for r in dev] == [len(r.epochs) for r in batched]


def test_haf_moves_something_on_every_engine():
    """The runs above are not vacuous: agent-only HAF migrates."""
    res = _haf_runs(PORT, "paper", None, engine="torch", batched=True)
    assert all(len(r.migrations) >= 1 for r in res)


def _method(pkg, name):
    """(placement, allocation, rr_dispatch) as the reference's method
    registry composes each baseline."""
    base, eng = pkg["base"], pkg["engine"]
    return {
        "haf-static": lambda: (eng.StaticPlacement(),
                               eng.DeadlineAwareAllocation(), False),
        "round-robin": lambda: (eng.StaticPlacement(),
                                base.EqualShareAllocation(), True),
        "lyapunov": lambda: (base.LyapunovPlacement(V=0.25),
                             base.MaxWeightAllocation(), False),
        "game-theory": lambda: (base.GameTheoryPlacement(toll=0.1),
                                base.MarketAllocation(), False),
        "caora": lambda: (eng.StaticPlacement(),
                          base.AlphaSplitAllocation(0.5), False),
    }[name]()


BASELINES = ("haf-static", "round-robin", "lyapunov", "game-theory", "caora")


@pytest.mark.parametrize("name", BASELINES)
def test_baselines_equal_reference(name):
    def runs(pkg, engine="numpy", batched=False):
        sc = pkg["sim"].make_scenario("paper", seed=0)
        wl = [pkg["sim"].workload_for(sc, seed=s, n_ai_requests=N_REQ)[0]
              for s in SEEDS]
        sim = _simulator(pkg, sc, engine)
        rr = _method(pkg, name)[2]
        if batched:
            ms = [_method(pkg, name) for _ in wl]
            return sim.run_batch(wl, [m[0] for m in ms], [m[1] for m in ms],
                                 rr_dispatch=rr)
        return [sim.run(w, *_method(pkg, name)[:2], rr_dispatch=rr)
                for w in wl]

    want = [_fingerprint(r) for r in runs(REF)]
    assert [_fingerprint(r) for r in runs(PORT)] == want
    assert [_fingerprint(r) for r in runs(PORT, batched=True)] == want
    assert [_fingerprint(r)
            for r in runs(PORT, "torch", batched=True)] == want


def test_caora_alpha_per_node_and_fit_equal_reference():
    sc_r = ref_sim.make_scenario("paper", seed=0)
    sc_p = port_sim.make_scenario("paper", seed=0)
    reqs_r, _ = ref_sim.workload_for(sc_r, seed=0, n_ai_requests=200)
    reqs_p, _ = port_sim.workload_for(sc_p, seed=0, n_ai_requests=200)
    grid = (0.1, 0.5, 0.9)
    got = port_base.fit_caora_alpha(_simulator(PORT, sc_p), reqs_p, grid)
    want = ref_base.fit_caora_alpha(_simulator(REF, sc_r), reqs_r, grid)
    assert got == want
    alpha = np.linspace(0.2, 0.8, len(sc_p["nodes"]))
    res = []
    for pkg, sc, reqs in ((PORT, sc_p, reqs_p), (REF, sc_r, reqs_r)):
        res.append(_simulator(pkg, sc).run(
            reqs, pkg["engine"].StaticPlacement(),
            pkg["base"].AlphaSplitAllocation(alpha)))
    assert _fingerprint(res[0]) == _fingerprint(res[1])


# --------------------------------------------------------------------------- #
# the critic's training data
# --------------------------------------------------------------------------- #
def _assert_samples_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_harvest_equals_reference_and_is_batch_invariant():
    ref, port = _harvests(batch_size=8)
    assert len(port) > 50
    _assert_samples_equal(port, ref)
    _assert_samples_equal(_harvests(batch_size=1)[1], port)
    assert port_datagen.samples_fingerprint(port) == \
        ref_datagen.samples_fingerprint(ref)


def test_harvest_on_the_torch_engine_equals_numpy():
    """The CPU form of the chip's check: the device engine's harvest (its
    random and scripted migrations included) is the host engine's."""
    _assert_samples_equal(_harvests(batch_size=8, engine="torch")[1],
                          _harvests(batch_size=8)[1])


def test_harvest_families_and_merge_equal_reference():
    kw = dict(HARVEST_KW, bulk_runs=((1.0, 2),), probe_epochs_post=())
    fams = ("paper", "node-outage")
    ref = ref_datagen.harvest_families(fams, **kw)
    port = port_datagen.harvest_families(fams, engine="numpy",
                                         device="cpu", **kw)
    assert list(port) == list(ref) == list(fams)
    for fam in fams:
        _assert_samples_equal(port[fam], ref[fam])
    _assert_samples_equal(port_datagen.merge_samples(port),
                          ref_datagen.merge_samples(ref))
    held = port_datagen.merge_samples(port, exclude=("node-outage",))
    assert len(held) == len(port["paper"])


def test_resolve_probes_equals_reference_on_foreign_topology():
    for family, kw in (("paper", {}), ("dense-urban", {"n_nodes": 6}),
                       ("skewed-hetero", {})):
        sc_r = ref_sim.make_scenario(family, seed=0, **kw)
        sc_p = port_sim.make_scenario(family, seed=0, **kw)
        for probes in ("PRE_SPLIT_PROBES", "POST_SPLIT_PROBES"):
            got = port_datagen.resolve_probes(
                sc_p, getattr(port_datagen, probes))
            assert got == ref_datagen.resolve_probes(
                sc_r, getattr(ref_datagen, probes))
    urban = port_sim.make_scenario("dense-urban", seed=0, n_nodes=6)
    derived = port_datagen.resolve_probes(urban,
                                          port_datagen.PRE_SPLIT_PROBES)
    assert derived[0] is None and len(derived) > 3
    names = {s.name for s in urban["instances"]}
    assert all(p[0] in names for p in derived[1:])
