"""The harness driven on the CPU at tiny sizes (the look for a card
skipped): a sound run is correct; the control and each fault a cell can
have, planted under the timed path, make it not correct; the result line's
format; no result without a card or outside a checkout."""
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

import repro_torch.models.api as api
from servebench.core import cli, spec
from servebench.core.control import Control
from servebench.tests.tiny import CELLS, cell, sizes

CPU = torch.device("cpu")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]


def run(name, seed=2**31 + 77):
    c = cell(name)
    return cli.run_cell(c, seed, 0.2, False, CPU, numbers=sizes(c))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct_and_well_formed(name):
    result, verdicts = run(name)
    assert list(result) == KEYS
    assert result["correct"] is True, result["check"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    # the window holds whole passes over the traffic
    c_tiny = cell(name)
    assert result["attempted"] % (c_tiny.traffic["rows"]
                                  * c_tiny.traffic["per_pass"]) == 0
    c = spec.load_cell(name)
    assert sorted(result["metrics"]) == sorted(m["name"]
                                               for m in c.end_to_end)
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert set(result["check"]) == set(c.checks["limits"])
    line = json.dumps(result)
    assert json.loads(line)["check"] == result["check"]
    lines = cli.check_lines(verdicts)
    assert len(lines) == len(c.checks["limits"])
    assert all(x.startswith("check ") and " limit " in x and
               x.endswith(" ok") for x in lines)


def _fault(monkeypatch, wrap):
    original = api.Model.prefill

    def prefill(self, params, batch):
        return wrap(*original(self, params, batch))
    monkeypatch.setattr(api.Model, "prefill", prefill)


def _state_unchanged(logits, cache):
    def zero(t):
        if isinstance(t, dict):
            return {k: zero(v) for k, v in t.items()}
        if isinstance(t, list):
            return [zero(v) for v in t]
        return torch.zeros_like(t)
    return logits, zero(cache)


def _half_batch(logits, cache):
    """The first half of the rows computed, the rest copies of them."""
    def half(t, axis):
        if isinstance(t, dict):
            return {k: half(v, axis) for k, v in t.items()}
        t = t.clone()
        n = t.shape[axis]
        keep = t.narrow(axis, 0, n // 2)
        rest = t.narrow(axis, n // 2, n - n // 2)
        rest.copy_(keep.narrow(axis, 0, 1).expand_as(rest))
        return t
    return half(logits, 0), half(cache, 1)


def _token_altered(logits, cache):
    """Row 0's best token takes its worst logit: it is served instead."""
    logits = logits.clone()
    row = logits[0, -1]
    best, worst = int(row.argmax()), int(row.argmin())
    row[best], row[worst] = row[worst].clone(), row[best].clone()
    return logits, cache


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


@pytest.mark.parametrize("name,fault", [
    (n, f) for n in CELLS for f in FAULTS
    if f != "half_batch" or spec.load_cell(n).traffic["rows"] > 1])
def test_a_fault_under_the_timed_path_is_not_correct(monkeypatch, name,
                                                      fault):
    _fault(monkeypatch, FAULTS[fault])
    result, _ = run(name)
    assert result["correct"] is False, result["check"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(monkeypatch, name):
    c = cell(name)
    build = api.build_model
    monkeypatch.setattr(api, "build_model", lambda cfg, **kw: Control(
        build(cfg, **kw), c.reference(), sizes(c), c.config["cache"]))
    result, _ = cli.run_cell(c, 3, 0.2, False, CPU, numbers=sizes(c))
    assert result["correct"] is False, result["check"]


def test_no_result_without_a_card(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main(["--workload", "llava.longdoc", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_no_result_from_the_benchmark_files_alone(tmp_path):
    shutil.copy(spec.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(spec.HERE, tmp_path / "servebench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    p = subprocess.run([sys.executable, "servebench/run.py", "--workload",
                        "llava.longdoc", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0
    assert p.stdout.strip() == ""
