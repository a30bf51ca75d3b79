"""repro_torch.analysis — the port's invariant linter, against the
reference's.

Every case of ``tests/test_analysis.py`` runs here on the port's linter
(the reference's fixtures are read, never edited); on those fixtures both
linters report the same ``(rule, path, line)`` for every rule; both are
clean over ``src/repro_torch`` (the reference's run pins the restored
``wall-clock`` pragmas); and the torch forms that the port's rules add fire
on the fixtures in ``tests/torch_analysis_fixtures/`` and stay silent on
their ``generator=`` / ``dtype=`` forms.
"""
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro_torch.analysis import (AnalysisError, Finding, analyze,
                                  default_root, get_rule, rule_names, rules)
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.core import Rule, register
from repro_torch.analysis.rules.determinism import WALL_CLOCK_ALLOWLIST

TESTS = pathlib.Path(__file__).parent
FIXTURES = TESTS / "analysis_fixtures"
TORCH_FIXTURES = TESTS / "torch_analysis_fixtures"
SRC = TESTS.parent / "src" / "repro_torch"

#: rule -> (fixture file, expected finding lines), the reference's table
EXPECTED = {
    "no-module-rng": ("no_module_rng.py", [2, 7]),
    "wall-clock": ("wall_clock.py", [6]),
    "set-iteration": ("set_iteration.py", [5, 9, 17]),
    "obs-guard": ("obs_guard.py", [12, 16]),
    "identity-hash": ("identity_hash.py", [6, 15]),
    "no-bare-print": ("no_bare_print.py", [5]),
    "mutable-default-arg": ("mutable_default.py", [4, 9]),
    "float-dtype": ("float_dtype.py", [7, 12]),
}

#: the torch extensions: rule -> fixture whose ``# VIOLATION`` lines fire
TORCH_EXPECTED = {
    "float-dtype": "torch_float_dtype.py",
    "no-module-rng": "torch_module_rng.py",
}


def _run(args, code=False):
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    cmd = [sys.executable, "-c", args] if code else \
        [sys.executable, "-m", *args]
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          cwd=str(SRC.parents[1]), timeout=120)


# --------------------------------------------------------------------- #
# registry
# --------------------------------------------------------------------- #
def test_registry_has_the_full_battery():
    names = rule_names()
    assert set(EXPECTED) == set(names)
    for rule in rules().values():
        assert rule.name and rule.description and rule.hint


def test_duplicate_registration_raises():
    with pytest.raises(AnalysisError, match="duplicate"):
        @register
        class Clash(Rule):
            name = "no-bare-print"
            description = "clash"

            def check(self, mod):
                return []


def test_unknown_rule_raises():
    with pytest.raises(AnalysisError, match="unknown rule"):
        get_rule("no-such-rule")


# --------------------------------------------------------------------- #
# the port's tree is clean — one sweep per rule, by either linter
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rule", sorted(EXPECTED))
def test_src_repro_torch_is_clean(rule):
    findings, n_files = analyze(rule_filter=[rule])
    assert n_files > 90          # the whole package was walked
    assert findings == [], "\n".join(f.format() for f in findings)


@pytest.mark.parametrize("rule", sorted(EXPECTED))
def test_reference_linter_finds_nothing_in_the_port(rule):
    """The reference's rules over ``src/repro_torch`` (its ``wall-clock``
    rule held the three reads the port had left without pragmas)."""
    from repro.analysis import analyze as ref_analyze
    findings, n_files = ref_analyze(root=SRC, rule_filter=[rule])
    assert n_files > 90
    assert findings == [], "\n".join(f.format() for f in findings)


def test_default_root_is_the_installed_package():
    assert default_root() == SRC.resolve()


# --------------------------------------------------------------------- #
# positive fixtures — each rule catches its planted violation
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rule", sorted(EXPECTED))
def test_rule_fires_on_fixture(rule):
    fname, lines = EXPECTED[rule]
    findings, _ = analyze(root=FIXTURES, rule_filter=[rule],
                          paths=[FIXTURES / fname])
    assert [(f.path, f.line) for f in findings] == \
        [(fname, ln) for ln in lines]
    for f in findings:
        assert f.rule == rule and f.message and f.hint


@pytest.mark.parametrize("rule", sorted(EXPECTED))
def test_findings_equal_reference_linters_on_its_fixtures(rule):
    from repro.analysis import analyze as ref_analyze
    mine, n_mine = analyze(root=FIXTURES, rule_filter=[rule])
    theirs, n_theirs = ref_analyze(root=FIXTURES, rule_filter=[rule])
    assert n_mine == n_theirs == len(list(FIXTURES.glob("*.py")))
    assert [(f.rule, f.path, f.line) for f in mine] == \
        [(f.rule, f.path, f.line) for f in theirs]
    assert mine                     # every rule fires somewhere


def test_fixture_sweep_totals():
    findings, n_files = analyze(root=FIXTURES)
    assert n_files == len(list(FIXTURES.glob("*.py")))
    per_rule = {}
    for f in findings:
        per_rule.setdefault(f.rule, []).append((f.path, f.line))
    assert per_rule == {
        rule: [(fname, ln) for ln in lines]
        for rule, (fname, lines) in EXPECTED.items()}


def test_suppressed_fixture_reports_nothing():
    findings, _ = analyze(root=FIXTURES,
                          paths=[FIXTURES / "suppressed.py"])
    assert findings == []


# --------------------------------------------------------------------- #
# the torch extensions
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("rule", sorted(TORCH_EXPECTED))
def test_torch_extension_fires_on_marked_lines_only(rule):
    fname = TORCH_EXPECTED[rule]
    path = TORCH_FIXTURES / fname
    marked = [i for i, line in enumerate(path.read_text().splitlines(), 1)
              if "# VIOLATION" in line]
    findings, _ = analyze(root=TORCH_FIXTURES, rule_filter=[rule],
                          paths=[path])
    assert [(f.path, f.line) for f in findings] == \
        [(fname, ln) for ln in marked]
    assert len(marked) >= 9
    # every other rule is silent there, and so is the reference's linter,
    # which reads only numpy's names
    others, _ = analyze(root=TORCH_FIXTURES, paths=[path])
    assert {f.rule for f in others} == {rule}
    from repro.analysis import analyze as ref_analyze
    assert ref_analyze(root=TORCH_FIXTURES, paths=[path])[0] == []


def test_torch_float_dtype_is_scoped_to_the_f64_paths(tmp_path):
    src = "import torch\n\n\ndef f(n):\n    return torch.zeros(n)\n"
    assert _findings_for(tmp_path, src, "float-dtype") == []
    d = tmp_path / "sim"
    d.mkdir()
    found = _findings_for(d, src, "float-dtype", name="event_core.py",
                          root=tmp_path)
    assert [f.line for f in found] == [5]


# --------------------------------------------------------------------- #
# suppression forms
# --------------------------------------------------------------------- #
def _findings_for(tmp_path, source, rule, name="mod.py", root=None):
    p = tmp_path / name
    p.write_text(source)
    findings, _ = analyze(root=root or tmp_path, rule_filter=[rule],
                          paths=[p])
    return findings


def test_trailing_named_suppression(tmp_path):
    src = "import time\n\n\ndef f():\n" \
          "    return time.time()  # repro: allow(wall-clock): why\n"
    assert _findings_for(tmp_path, src, "wall-clock") == []


def test_bare_allow_suppresses_every_rule(tmp_path):
    src = "import time\n\n\ndef f():\n" \
          "    return time.time()  # repro: allow\n"
    assert _findings_for(tmp_path, src, "wall-clock") == []


def test_wrong_rule_name_does_not_suppress(tmp_path):
    src = "import time\n\n\ndef f():\n" \
          "    return time.time()  # repro: allow(no-bare-print)\n"
    found = _findings_for(tmp_path, src, "wall-clock")
    assert [f.line for f in found] == [5]


def test_standalone_comment_covers_next_line(tmp_path):
    src = "import time\n\n\ndef f():\n" \
          "    # repro: allow(wall-clock): next-line form\n" \
          "    return time.time()\n"
    assert _findings_for(tmp_path, src, "wall-clock") == []


def test_standalone_comment_does_not_leak_past_next_line(tmp_path):
    src = "import time\n\n\ndef f():\n" \
          "    # repro: allow(wall-clock)\n" \
          "    a = 1\n" \
          "    return a, time.time()\n"
    found = _findings_for(tmp_path, src, "wall-clock")
    assert [f.line for f in found] == [7]


def test_allow_file_suppresses_whole_module(tmp_path):
    src = "# repro: allow-file(wall-clock): fixture\nimport time\n\n\n" \
          "def f():\n    return time.time()\n\n\n" \
          "def g():\n    return time.time()\n"
    assert _findings_for(tmp_path, src, "wall-clock") == []


def test_scope_pragma_opts_into_scoped_rule(tmp_path):
    src = "def f(self, t):\n    self.trace.emit('x', t)\n"
    # without the pragma the module is out of obs-guard's scope
    assert _findings_for(tmp_path, src, "obs-guard") == []
    src = "# repro: scope(obs-guard)\n" + src
    found = _findings_for(tmp_path, src, "obs-guard")
    assert [f.line for f in found] == [3]


# --------------------------------------------------------------------- #
# allowlist handling
# --------------------------------------------------------------------- #
def test_wall_clock_allowlist_by_rel_path(tmp_path):
    assert "eval/sweep.py" in WALL_CLOCK_ALLOWLIST
    d = tmp_path / "eval"
    d.mkdir()
    p = d / "sweep.py"
    p.write_text("import time\n\n\ndef f():\n    return time.time()\n")
    findings, _ = analyze(root=tmp_path, rule_filter=["wall-clock"],
                          paths=[p])
    assert findings == []          # rel path matches the allowlist
    # the same source elsewhere is a violation
    q = tmp_path / "other.py"
    q.write_text(p.read_text())
    findings, _ = analyze(root=tmp_path, rule_filter=["wall-clock"],
                          paths=[q])
    assert [f.line for f in findings] == [5]


# --------------------------------------------------------------------- #
# JSON output schema
# --------------------------------------------------------------------- #
def test_json_report_round_trip(capsys):
    rc = cli_main(["--root", str(FIXTURES), "--format", "json"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert report["kind"] == "repro.analysis.report"
    assert report["version"] == 1
    assert report["root"] == str(FIXTURES)
    assert set(report["rules"]) == set(rule_names())
    assert report["files_scanned"] == len(list(FIXTURES.glob("*.py")))
    assert report["n_findings"] == len(report["findings"]) > 0
    for d in report["findings"]:
        f = Finding.from_dict(d)
        assert f.to_dict() == d
        assert f.location == f"{d['path']}:{d['line']}"


def test_json_reports_of_both_linters_read_alike(capsys):
    from repro.analysis.cli import main as ref_main
    reports = []
    for main in (cli_main, ref_main):
        assert main(["--root", str(FIXTURES), "--format", "json"]) == 1
        reports.append(json.loads(capsys.readouterr().out))
    mine, theirs = reports
    assert set(mine) == set(theirs)
    for key in ("kind", "version", "root", "rules", "files_scanned",
                "n_findings"):
        assert mine[key] == theirs[key], key
    loc = lambda r: [(d["rule"], d["path"], d["line"])
                     for d in r["findings"]]
    assert loc(mine) == loc(theirs)


# --------------------------------------------------------------------- #
# CLI contract
# --------------------------------------------------------------------- #
def test_cli_clean_tree_exits_zero(capsys):
    rc = cli_main([])              # default root: src/repro_torch
    out = capsys.readouterr().out
    assert rc == 0
    assert "# repro_torch.analysis: 0 findings" in out


def test_cli_findings_exit_one(capsys):
    rc = cli_main(["--root", str(FIXTURES)])
    out = capsys.readouterr().out
    assert rc == 1
    assert "[no-bare-print]" in out
    assert "hint:" in out


def test_cli_rules_filter(capsys):
    rc = cli_main(["--root", str(FIXTURES), "--rules",
                   "no-bare-print", "--format", "json"])
    assert rc == 1
    report = json.loads(capsys.readouterr().out)
    assert report["rules"] == ["no-bare-print"]
    assert {f["rule"] for f in report["findings"]} == {"no-bare-print"}


def test_cli_unknown_rule_exits_two(capsys):
    rc = cli_main(["--rules", "bogus"])
    assert rc == 2
    assert "unknown rule" in capsys.readouterr().err


def test_cli_missing_path_exits_two(capsys):
    rc = cli_main(["does/not/exist.py"])
    assert rc == 2


def test_cli_list_rules(capsys):
    rc = cli_main(["--list-rules"])
    assert rc == 0
    out = capsys.readouterr().out
    for name in rule_names():
        assert name in out


def test_module_entry_point_runs_clean_without_torch():
    """``python -m repro_torch.analysis`` exits 0, and the linter loads
    neither torch, numpy, jax nor the reference package."""
    proc = _run(["repro_torch.analysis"])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    code = (
        "import runpy, sys\n"
        "sys.argv = ['repro_torch.analysis']\n"
        "try:\n"
        "    runpy.run_module('repro_torch.analysis', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "             ('torch', 'numpy', 'jax', 'jaxlib', 'repro'))\n"
        "print('RESULT', rc, bad)\n")
    proc = _run(code, code=True)
    assert proc.stdout.splitlines()[-1] == "RESULT 0 []", \
        proc.stdout + proc.stderr


def test_reference_module_entry_point_is_clean_over_the_port():
    proc = _run(["repro.analysis", "--root", str(SRC)])
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "0 findings" in proc.stdout


# --------------------------------------------------------------------- #
# ExperimentSpec field-partition guard (the runtime half of the
# identity-hash rule), on the port's spec
# --------------------------------------------------------------------- #
def test_spec_partition_holds_and_registries_drive_identity():
    import dataclasses

    from repro_torch.exp import spec as spec_mod

    spec_mod._check_field_partition()   # current tree passes
    names = {f.name for f in dataclasses.fields(spec_mod.ExperimentSpec)}
    ident = set(spec_mod._IDENTITY_FIELDS)
    excl = set(spec_mod._EXCLUDED_FIELDS)
    assert ident | excl == names and not ident & excl
    s = spec_mod.ExperimentSpec()
    assert set(s.identity()) == ident


def test_spec_partition_guard_raises_on_drift(monkeypatch):
    from repro_torch.exp import spec as spec_mod

    monkeypatch.setattr(spec_mod, "_IDENTITY_FIELDS",
                        spec_mod._IDENTITY_FIELDS[:-1])
    with pytest.raises(AssertionError, match="unclassified"):
        spec_mod._check_field_partition()
    monkeypatch.setattr(spec_mod, "_EXCLUDED_FIELDS",
                        spec_mod._EXCLUDED_FIELDS + ("bogus",))
    with pytest.raises(AssertionError, match="not fields"):
        spec_mod._check_field_partition()


def test_identity_hash_stable_across_refactor():
    from repro_torch.exp.spec import ExperimentSpec

    s = ExperimentSpec()
    assert set(s.identity()) == {"methods", "scenarios", "n_ai_requests",
                                 "rho", "epoch_interval", "max_events",
                                 "scenario_seed"}
