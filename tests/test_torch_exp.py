"""The port's experiment layer (repro_torch.exp) against the reference's.

Case for case the reference's ``tests/test_exp.py`` where the behaviour is
the same, each holding the port to ``repro.exp`` on the same input: the
grammar parses and formats alike, a spec hashes alike (``identity_hash``,
and ``spec_hash`` at equal engine), the checked-in ``experiments/*.toml``
load through the standard library's ``tomllib`` into the spec the
reference builds from the same dict, artifacts resolve and verify through
one store from either package, and reports resume across packages.  Runs
use the host engine (``numpy``); the port's default engine is ``cuda``.
"""
import json
import pathlib
import subprocess
import sys
import tomllib

import jax
import numpy as np
import pytest

import repro.core.critic as ref_critic
import repro.eval.policies as ref_policies
import repro.exp as ref_exp
import repro.exp.provenance as ref_prov
import repro_torch.core.critic as port_critic
import repro_torch.exp as port_exp
import repro_torch.eval.sweep as sweep_mod
from repro_torch.eval import cli
from repro_torch.eval.policies import _load_critic
from repro_torch.exp import (ArtifactError, ExperimentSpec,
                             FingerprintMismatch, GrammarError, SpecError,
                             format_method, format_scenario, format_value,
                             parse_method, parse_methods, parse_scenario,
                             parse_seeds, parse_value, resolve_artifact,
                             run_experiment, save_critic)
from repro_torch.exp.provenance import (artifact_provenance, completed_rows,
                                        resume_key)

ROOT = pathlib.Path(__file__).resolve().parents[1]
MOCK_LLM = ROOT / "tests" / "mock_llm.py"
EXPERIMENTS = sorted((ROOT / "experiments").glob("*.toml"))


# --------------------------------------------------------------------------- #
# grammar
# --------------------------------------------------------------------------- #
VALUES = (3, -1, 0.75, 1.0, 2.5e-3, True, False, None, "qwen3-32b-sim",
          "@critic?", "a b, (c)=d", 'quo"te', "back\\slash", "0.75",
          "none", "rho=0.75", "")


def test_value_round_trip():
    for v in VALUES:
        assert parse_value(format_value(v)) == v, v
        assert format_value(v) == ref_exp.format_value(v), v


def test_parse_method_forms():
    assert parse_method("haf-static") == \
        {"name": "haf-static", "params": {}, "label": "haf-static"}
    m = parse_method("haf(agent=qwen3-32b-sim, critic=@critic, K=3)")
    assert m["name"] == "haf"
    assert m["params"] == {"agent": "qwen3-32b-sim",
                           "critic_path": "@critic", "K": 3}
    m = parse_method('caora(alpha=0.4, label=CAORA)')
    assert m == {"name": "caora", "params": {"alpha": 0.4}, "label": "CAORA"}


def test_haf_llm_cmd_may_contain_commas():
    cmd = 'curl -s localhost:8000 -d {"a": 1, "b": [2, 3]} | jq .text'
    m = parse_method(f'haf-llm(cmd="{cmd.replace(chr(92), "")}")')
    assert m["params"]["cmd"] == cmd.replace(chr(92), "")
    assert parse_method(format_method(m)) == m
    assert format_method(m) == ref_exp.format_method(m)


def test_legacy_haf_llm_sugar_still_parses():
    m = parse_method("haf-llm:curl -s localhost")
    assert m == ref_exp.parse_method("haf-llm:curl -s localhost")
    assert m["name"] == "haf-llm"
    assert m["params"] == {"cmd": "curl -s localhost"}
    assert m["label"] == "haf-llm(curl -s localhost)"


def test_legacy_haf_llm_with_comma_errors_at_parse():
    for text in ("haf-llm:curl -s x --data a, b",
                 "haf-llm:python serve.py --modes a,haf",
                 "haf-static,haf-llm:curl -s x"):
        with pytest.raises(GrammarError, match=r'haf-llm\(cmd='):
            parse_methods(text)
    assert parse_methods("haf-llm:curl -s x")[0]["params"]["cmd"] \
        == "curl -s x"
    spec = ExperimentSpec(methods=("haf-llm:curl -s x --data a,b",),
                          scenarios=("paper",))
    assert spec.methods[0]["params"]["cmd"] == "curl -s x --data a,b"


METHOD_TEXTS = ("haf-static",
                "haf(K=5, agent=qwen2.5-72b-sim, critic_path=@critic?)",
                'haf-llm(cmd="vllm serve m, n --port 80", timeout=9.5)',
                "caora(alpha=0.25, label=CAORA)",
                "lyapunov(V=0.5)",
                "haf(agent=qwen3-32b-sim, critic=@critic?, label=HAF)")
SCENARIO_TEXTS = ("paper",
                  "flash-crowd(magnitude=6.0, n_spikes=2, rho=0.95)",
                  'paper(n_ai_requests=3750, rho=0.75, label="rho=0.75")',
                  'trace(file="experiments/traces/synthetic_2k.csv", '
                  'speedup=2.0, window=4096, label="trace-2k-2x")')


@pytest.mark.parametrize("text", METHOD_TEXTS)
def test_method_grammar_round_trip(text):
    m = parse_method(text)
    assert m == ref_exp.parse_method(text)
    assert parse_method(format_method(m)) == m, text
    assert format_method(m) == ref_exp.format_method(m)


@pytest.mark.parametrize("text", SCENARIO_TEXTS)
def test_scenario_grammar_round_trip(text):
    s = parse_scenario(text)
    assert s == ref_exp.parse_scenario(text)
    assert parse_scenario(format_scenario(s)) == s, text
    assert format_scenario(s) == ref_exp.format_scenario(s)


def test_parse_seeds_forms():
    for text, want in (("3", [0, 1, 2]), ("0,2,5", [0, 2, 5]),
                       ("0..4", [0, 1, 2, 3, 4]), ("0,", [0]),
                       ("0..1,7", [0, 1, 7])):
        assert parse_seeds(text) == want == ref_exp.parse_seeds(text)


def test_parse_seeds_zero_points_at_spec_form():
    with pytest.raises(GrammarError, match="seeds = \\[0\\]"):
        parse_seeds("0")
    with pytest.raises(GrammarError):
        parse_seeds("-2")
    with pytest.raises(GrammarError):
        parse_seeds("1..x")


# --------------------------------------------------------------------------- #
# ExperimentSpec
# --------------------------------------------------------------------------- #
MINI_KW = dict(methods=("haf-static", "round-robin"),
               scenarios=("paper", "skewed-hetero(n_nodes=4)"),
               seeds=(0, 1), n_ai_requests=120)

HASH_CASES = (
    MINI_KW,
    dict(methods=("haf(agent=qwen3-32b-sim, critic=@critic?, label=HAF)",
                  "caora(alpha=0.5, label=CAORA)"),
         scenarios=('paper(rho=0.75, n_ai_requests=3750, label="rho=0.75")',
                    "flash-crowd(rho=0.95)"),
         seeds="0..4", rho=0.9, epoch_interval=2.5, max_events=10_000,
         scenario_seed=3, batch=4, workers=2, out="a/b.json", trace=True,
         metrics_interval=1.0, stream=True, window=64, name="h"),
    dict(methods=('haf-llm(cmd="python mock.py, x", label=LLM)',),
         scenarios=('trace(file="t.csv", window=4096)',), seeds=(3,)),
)


def test_engine_default_is_the_card():
    assert ExperimentSpec().engine == "cuda"
    assert sweep_mod.SweepSpec().engine == "cuda"
    assert ExperimentSpec(**MINI_KW).to_sweep_spec().device == "cuda"


@pytest.mark.parametrize("case", range(len(HASH_CASES)))
def test_hashes_equal_reference(case):
    kw = dict(HASH_CASES[case], engine="numpy")
    port, ref = ExperimentSpec(**kw), ref_exp.ExperimentSpec(**kw)
    assert port.canonical() == ref.canonical()
    assert port.canonical()["kind"] == "repro.exp.experiment"
    assert port.identity_hash() == ref.identity_hash()
    assert port.spec_hash() == ref.spec_hash()
    # the file form leaves each package's default engine out
    assert port.replace(engine="cuda").to_dict() == ref.to_dict()
    # the engine stays outside the identity: a cuda run resumes a numpy one
    assert port.replace(engine="cuda").identity_hash() == ref.identity_hash()


@pytest.mark.parametrize("path", EXPERIMENTS, ids=lambda p: p.name)
def test_experiment_files_load_as_the_reference_spec(path):
    """The reference cannot read these files here (it imports ``tomli``);
    the port reads them with ``tomllib`` into the spec the reference builds
    from the same dict."""
    port = ExperimentSpec.from_file(path)
    ref = ref_exp.ExperimentSpec.from_dict(tomllib.loads(path.read_text()),
                                           source=str(path))
    assert port.engine == "cuda" and ref.engine == "numpy"
    assert port.identity_hash() == ref.identity_hash()
    assert port.replace(engine="numpy").spec_hash() == ref.spec_hash()
    assert port.to_dict() == ref.to_dict()
    strip = ("device", "engine")
    assert [{k: v for k, v in j.items() if k not in strip}
            for j in port.expand()] == \
        [{k: v for k, v in j.items() if k not in strip}
         for j in ref.expand()]


def test_spec_file_round_trip(tmp_path):
    spec = ExperimentSpec(name="mini", workers=2, **MINI_KW)
    for suffix in (".toml", ".json"):
        path = spec.to_file(tmp_path / f"mini{suffix}")
        back = ExperimentSpec.from_file(path)
        assert back.spec_hash() == spec.spec_hash(), suffix
        assert back.expand() == spec.expand(), suffix
    # the port's TOML bytes are the reference's emitter's (each leaves its
    # own default engine out)
    ref = ref_exp.ExperimentSpec(name="mini", workers=2, **MINI_KW)
    ref.to_file(tmp_path / "ref.toml")
    assert (tmp_path / "ref.toml").read_text() == \
        (tmp_path / "mini.toml").read_text()


def test_spec_grammar_equals_raw_dicts():
    by_grammar = ExperimentSpec(
        methods=("haf(agent=qwen3-32b-sim, critic=@c?)",
                 "caora(alpha=0.3)"),
        scenarios=("flash-crowd(rho=0.95, n_ai_requests=400)",))
    by_dicts = ExperimentSpec(
        methods=({"name": "haf",
                  "params": {"agent": "qwen3-32b-sim",
                             "critic_path": "@c?"}, "label": "haf"},
                 {"name": "caora", "params": {"alpha": 0.3},
                  "label": "caora"}),
        scenarios=({"family": "flash-crowd",
                    "params": {"rho": 0.95, "n_ai_requests": 400},
                    "label": "flash-crowd"},))
    assert by_grammar.expand() == by_dicts.expand()
    assert by_grammar.identity_hash() == by_dicts.identity_hash()


def test_spec_expand_matches_sweep():
    from repro_torch.eval import expand_jobs
    spec = ExperimentSpec(**MINI_KW)
    assert spec.expand() == expand_jobs(spec.to_sweep_spec())
    assert len(spec.expand()) == 2 * 2 * 2
    assert {j["engine"] for j in spec.expand()} == {"cuda"}
    cpu = spec.replace(engine="torch").to_sweep_spec("cpu")
    assert {(j["engine"], j["device"]) for j in expand_jobs(cpu)} == \
        {("torch", "cpu")}


def test_identity_hash_scope():
    spec = ExperimentSpec(**MINI_KW)
    assert spec.replace(workers=8, engine="scalar", batch=4, seeds=(0,),
                        name="x", out="y.json").identity_hash() \
        == spec.identity_hash()
    assert spec.replace(engine="numpy").identity_hash() \
        == spec.identity_hash()
    assert spec.replace(n_ai_requests=121).identity_hash() \
        != spec.identity_hash()
    assert spec.with_scenario_params("paper", rho=0.8).identity_hash() \
        != spec.identity_hash()


def test_with_params_selectors():
    spec = ExperimentSpec(
        methods=("caora(alpha=0.5, label=CAORA)", "haf-static"),
        scenarios=("paper",))
    out = spec.with_method_params("CAORA", alpha=0.125)
    assert out.methods[0]["params"]["alpha"] == 0.125
    with pytest.raises(SpecError, match="no method matches"):
        spec.with_method_params("nope", alpha=1.0)


@pytest.mark.parametrize("kw,match", [
    (dict(methods=("definitely-not-a-method",)), "unknown method"),
    (dict(scenarios=("not-a-family",)), "unknown scenario family"),
    (dict(scenarios=("flash-crowd(magnitud=6)",)), "unknown parameter"),
    (dict(methods=("haf(agnt=x)",)), "unknown parameter"),
    (dict(methods=("haf-llm",)), "needs cmd="),
    (dict(engine="pallas"), "unknown engine"),
    (dict(engine="jax", batch=4), "unknown engine"),
    (dict(batch=0), "batch must be >= 1"),
    (dict(workers=0), "workers must be >= 1"),
    (dict(seeds=()), "no seeds"),
    (dict(scenarios=("paper(rho=0.75)", "paper(rho=1.25)")),
     "duplicate scenario labels"),
    (dict(methods=("haf(K=3)", "haf(K=5)")), "duplicate method labels"),
])
def test_validate_catches_everything(kw, match):
    spec = ExperimentSpec(**{**dict(methods=("haf-static",),
                                    scenarios=("paper",)), **kw})
    with pytest.raises(SpecError, match=match):
        spec.validate()


@pytest.mark.parametrize("engine", ("numpy", "scalar", "torch", "cuda"))
def test_every_engine_validates_at_batch_1(engine):
    """``cuda`` at batch 1 runs as a one-replica run_batch, so the three
    checked-in files (batch left at 1) run unchanged on the card."""
    ExperimentSpec(methods=("haf-static",), scenarios=("paper",),
                   engine=engine, batch=1).validate()


def test_spec_file_unknown_key(tmp_path):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"methods": ["haf-static"], "typo_key": 1}))
    with pytest.raises(SpecError, match="typo_key"):
        ExperimentSpec.from_file(path)
    bad = tmp_path / "bad.toml"
    bad.write_text("methods = [\n")
    with pytest.raises(SpecError, match="not valid TOML"):
        ExperimentSpec.from_file(bad)


# --------------------------------------------------------------------------- #
# artifact store
# --------------------------------------------------------------------------- #
def _port_critic(seed: int = 0) -> port_critic.Critic:
    return port_critic.Critic(params=port_critic.init_params(seed, hidden=8))


def _ref_critic(seed: int = 0) -> ref_critic.Critic:
    return ref_critic.Critic(
        params=ref_critic.init_params(jax.random.PRNGKey(seed), hidden=8))


def test_artifact_refs(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    critic = _port_critic()
    save_critic(critic, tmp_path / "critic.json", families=("paper",),
                data_hash="d" * 64)
    path, fp = resolve_artifact("@critic")
    assert pathlib.Path(path) == tmp_path / "critic.json"
    assert fp == critic.fingerprint()
    assert resolve_artifact("@nope?") == (None, None)
    with pytest.raises(ArtifactError, match="@nope"):
        resolve_artifact("@nope")
    pin = f"critic@{critic.fingerprint()[:10]}"
    assert resolve_artifact(pin) == (path, critic.fingerprint())
    with pytest.raises(ArtifactError, match="no artifact"):
        resolve_artifact("critic@" + "0" * 12)
    ppath, pfp = resolve_artifact(str(tmp_path / "critic.json"))
    assert (ppath, pfp) == (str(tmp_path / "critic.json"),
                            critic.fingerprint())
    # every form resolves as the reference resolves it
    for ref in ("@critic", "@nope?", pin, str(tmp_path / "critic.json")):
        assert resolve_artifact(ref) == ref_exp.resolve_artifact(ref), ref


def test_load_critic_verifies_fingerprint(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    critic = _port_critic()
    save_critic(critic, tmp_path / "critic.json", families=("paper",))
    loaded = _load_critic("@critic")
    assert loaded.fingerprint() == critic.fingerprint()
    _port_critic(seed=1).save(str(tmp_path / "critic.json"))
    with pytest.raises(FingerprintMismatch):
        _load_critic("@critic")
    _port_critic(seed=2).save(str(tmp_path / "bare.json"))
    assert _load_critic(str(tmp_path / "bare.json")) is not None
    assert _load_critic("@absent?") is None


def test_critic_store_interchanges_with_reference(tmp_path, monkeypatch):
    """A critic the reference trains and saves loads in the port through
    ``@critic`` with the same fingerprint, and the other way round; a file
    changed under its manifest raises in the port as in the reference."""
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    rng = np.random.default_rng(1)
    samples = [(rng.normal(size=port_critic.FEATURE_DIM).astype(np.float32),
                rng.uniform(size=3).astype(np.float32),
                np.ones(3, np.float32)) for _ in range(40)]
    trained = ref_critic.train_critic(samples, epochs=10, hidden=8, seed=0)
    ref_exp.save_critic(trained, tmp_path / "critic.json",
                        families=("paper",), data_hash="a" * 64)
    loaded = _load_critic("@critic")
    assert loaded.fingerprint() == trained.fingerprint()
    assert _load_critic(f"critic@{trained.fingerprint()[:8]}") is loaded

    save_critic(_port_critic(seed=3), tmp_path / "other.json")
    back = ref_policies._load_critic("@other")
    assert back.fingerprint() == _port_critic(seed=3).fingerprint()

    _ref_critic(seed=4).save(str(tmp_path / "critic.json"))
    with pytest.raises(FingerprintMismatch):
        _load_critic("@critic")
    with pytest.raises(ref_exp.FingerprintMismatch):
        ref_policies._load_critic("@critic")


# --------------------------------------------------------------------------- #
# provenance + resume
# --------------------------------------------------------------------------- #
@pytest.fixture()
def small_spec(tmp_path):
    return ExperimentSpec(methods=("haf-static",), scenarios=("paper",),
                          seeds=(0, 1), n_ai_requests=100, engine="numpy",
                          out=str(tmp_path / "report.json"))


def _row_key(r):
    return (r["method"], r["scenario"], r["seed"])


def test_report_embeds_provenance(small_spec):
    report = run_experiment(small_spec, resume=False)
    prov = report["provenance"]
    assert report["kind"] == "repro.eval.sweep_report"
    assert prov["spec_hash"] == small_spec.spec_hash()
    assert prov["identity_hash"] == small_spec.identity_hash()
    assert prov["spec"]["methods"][0]["name"] == "haf-static"
    assert len(prov["scenario_fingerprints"]["paper"]) == 64
    backend = prov["backend"]
    assert backend["engine"] == "numpy" and backend["device"] is None
    import torch
    assert backend["torch"] == torch.__version__
    assert backend["cuda"] == torch.version.cuda
    assert "jax" not in backend
    loaded = json.loads(pathlib.Path(small_spec.out).read_text())
    assert loaded["provenance"]["spec_hash"] == small_spec.spec_hash()


def test_resume_skips_completed_rows(small_spec, monkeypatch):
    ran = []
    real = sweep_mod.run_sweep

    def counting(spec, verbose=False, jobs=None):
        ran.append(0 if jobs is None else len(jobs))
        return real(spec, verbose=verbose, jobs=jobs)

    monkeypatch.setattr(sweep_mod, "run_sweep", counting)
    r1 = run_experiment(small_spec)
    assert ran == [2] and r1["provenance"]["resumed_rows"] == 0

    r2 = run_experiment(small_spec)
    assert ran == [2] and r2["provenance"]["resumed_rows"] == 2
    assert sorted(map(_row_key, r2["runs"])) \
        == sorted(map(_row_key, r1["runs"]))

    path = pathlib.Path(small_spec.out)
    report = json.loads(path.read_text())
    report["runs"] = report["runs"][:1]
    path.write_text(json.dumps(report))
    r3 = run_experiment(small_spec)
    assert ran == [2, 1] and r3["provenance"]["resumed_rows"] == 1
    for a, b in zip(sorted(r1["runs"], key=_row_key),
                    sorted(r3["runs"], key=_row_key)):
        assert a["overall"] == b["overall"]
        assert a["n_events"] == b["n_events"]

    r4 = run_experiment(small_spec, resume=False)
    assert ran == [2, 1, 2] and r4["provenance"]["resumed_rows"] == 0

    r5 = run_experiment(small_spec.replace(n_ai_requests=101,
                                           out=small_spec.out))
    assert ran == [2, 1, 2, 2] and r5["provenance"]["resumed_rows"] == 0


def test_resume_key_rejects_foreign_reports(small_spec):
    run_experiment(small_spec)
    report = json.loads(pathlib.Path(small_spec.out).read_text())
    assert len(completed_rows(report, report["provenance"]["resume_key"])) \
        == 2
    assert completed_rows(report, "not-the-key") == {}
    report["runs"][0]["truncated"] = True
    assert len(completed_rows(report, report["provenance"]["resume_key"])) \
        == 1


def test_resume_invalidated_by_artifact_retrain(tmp_path, monkeypatch):
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    spec = ExperimentSpec(methods=("haf(critic=@critic)",),
                          scenarios=("paper",), seeds=(0,))
    save_critic(_port_critic(seed=0), tmp_path / "critic.json")
    key0 = resume_key(spec, artifact_provenance(spec))
    save_critic(_port_critic(seed=1), tmp_path / "critic.json")
    key1 = resume_key(spec, artifact_provenance(spec))
    assert key0 != key1
    # the reference keys the same spec and store alike
    ref_spec = ref_exp.ExperimentSpec(methods=("haf(critic=@critic)",),
                                      scenarios=("paper",), seeds=(0,))
    assert key1 == ref_prov.resume_key(
        ref_spec, ref_prov.artifact_provenance(ref_spec))


@pytest.mark.parametrize("writer", ("reference", "port"))
def test_reports_resume_across_packages(writer, tmp_path):
    """A report either package wrote resumes, row for row, in the other."""
    kw = dict(methods=("haf-static", "round-robin"), scenarios=("paper",),
              seeds=(0, 1), n_ai_requests=100, engine="numpy",
              out=str(tmp_path / "report.json"))
    first, second = (ref_exp, port_exp) if writer == "reference" \
        else (port_exp, ref_exp)
    a = first.run_experiment(first.ExperimentSpec(**kw))
    b = second.run_experiment(second.ExperimentSpec(**kw))
    assert b["provenance"]["resume_key"] == a["provenance"]["resume_key"]
    assert b["provenance"]["resumed_rows"] == 4
    assert sorted(map(_row_key, b["runs"])) == sorted(map(_row_key,
                                                          a["runs"]))


# --------------------------------------------------------------------------- #
# CLI
# --------------------------------------------------------------------------- #
def test_cli_spec_file_equals_raw_flags(tmp_path):
    methods = ("haf(agent=qwen3-32b-sim, critic=@critic?, label=HAF)",
               "haf-static(label=HAF-Static)")
    scenarios = ("paper(n_ai_requests=400, rho=1.0)",)
    spec = ExperimentSpec(methods=methods, scenarios=scenarios, seeds=(0,),
                          name="parity")
    path = spec.to_file(tmp_path / "parity.toml")

    ap = cli._build_parser()
    from_file = cli.build_experiment(ap.parse_args(["--spec", str(path)]))
    from_flags = cli.build_experiment(ap.parse_args(
        ["--methods", ",".join(methods),
         "--scenarios", ",".join(scenarios),
         "--seeds", "0,"]))
    assert from_file.expand() == from_flags.expand()
    assert from_file.identity_hash() == from_flags.identity_hash()
    assert from_file.engine == from_flags.engine == "cuda"


def test_cli_flags_override_spec_file(tmp_path):
    spec = ExperimentSpec(methods=("haf-static",), scenarios=("paper",),
                          seeds=(0,), workers=4)
    path = spec.to_file(tmp_path / "base.toml")
    ap = cli._build_parser()
    built = cli.build_experiment(ap.parse_args(
        ["--spec", str(path), "--seeds", "0..2", "--engine", "scalar",
         "--requests", "99", "--workers", "1"]))
    assert built.seeds == (0, 1, 2)
    assert built.engine == "scalar"
    assert built.n_ai_requests == 99
    assert built.workers == 1
    assert built.methods == spec.methods
    with pytest.raises(SystemExit):
        ap.parse_args(["--engine", "pallas"])


def test_cli_validate_runs_nothing(tmp_path, capsys):
    out = tmp_path / "never_written.json"
    rc = cli.main(["--validate", "--methods", "haf-static,round-robin",
                   "--scenarios", "paper", "--seeds", "2",
                   "--out", str(out)])
    assert rc == 0
    assert not out.exists()
    text = capsys.readouterr().out
    assert "validate only" in text and "nothing run" in text
    assert text.count("pending") == 4
    assert text.count(" cuda ") == 4        # the default engine, batch 1


@pytest.mark.parametrize("path", EXPERIMENTS, ids=lambda p: p.name)
def test_cli_validates_experiment_files(path, tmp_path, monkeypatch, capsys):
    """The checked-in files validate unchanged (no card is needed to
    expand and fingerprint) with the critic optional and absent."""
    monkeypatch.setenv("REPRO_ARTIFACTS", str(tmp_path))
    monkeypatch.chdir(ROOT)
    out = tmp_path / "r.json"
    assert cli.main(["--spec", str(path), "--validate",
                     "--out", str(out)]) == 0
    text = capsys.readouterr().out
    spec = ExperimentSpec.from_file(path)
    n = len(spec.methods) * len(spec.scenarios) * len(spec.seeds)
    assert f"{n} jobs expanded" in text and not out.exists()
    assert "MISSING (optional)" in text


def test_cli_seeds_zero_error_mentions_spec_grammar(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--seeds", "0", "--methods", "haf-static",
                  "--scenarios", "paper"])
    err = capsys.readouterr().err
    assert "seed COUNT" in err and "spec file" in err


def test_cli_legacy_haf_llm_comma_error(capsys):
    with pytest.raises(SystemExit):
        cli.main(["--validate", "--scenarios", "paper",
                  "--methods", "haf-llm:curl -s x --data a, b"])
    err = capsys.readouterr().err
    assert 'haf-llm(cmd=' in err


# --------------------------------------------------------------------------- #
# mock LLM end to end (the haf-llm path with zero network)
# --------------------------------------------------------------------------- #
def test_mock_llm_sweep_end_to_end():
    """haf-llm(cmd=...) drives a sweep offline, reproducibly, and equal to
    the reference's row."""
    cmd = f"{sys.executable} {MOCK_LLM}"
    kw = dict(methods=(f'haf-llm(cmd="{cmd}", label=HAF-MockLLM)',),
              scenarios=("paper",), seeds=(0,), n_ai_requests=100,
              engine="numpy")
    a = run_experiment(ExperimentSpec(**kw), resume=False)
    b = run_experiment(ExperimentSpec(**kw), resume=False)
    ref = ref_exp.run_experiment(ref_exp.ExperimentSpec(**kw), resume=False)
    row_a, row_b, row_r = a["runs"][0], b["runs"][0], ref["runs"][0]
    assert row_a["method"] == "HAF-MockLLM"
    assert 0.0 <= row_a["overall"] <= 1.0
    assert row_a["n_requests"] >= 100
    for key in ("overall", "ran", "ai", "mig_total", "n_events",
                "degraded_decisions"):
        assert row_a[key] == row_b[key] == row_r[key], key
    assert "critic_degraded" not in row_a

