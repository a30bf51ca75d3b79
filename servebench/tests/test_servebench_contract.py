"""BENCHMARK.json keeps to the benchmark's contract, and every name in it
finds its files: configuration, traffic, check limits, metric readers."""
import json
import re

import pytest

from servebench.core import spec
from servebench.core.check import Judge

BENCH = json.loads((spec.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 \
        and "\n" not in text and "\t" not in text


def test_top_level_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["servebench"]
    assert BENCH["command"][1].startswith("servebench/")
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = 24
    total = (2 + 14 * cells) * (BENCH["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
    assert len((spec.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    for w in BENCH["workloads"]:
        assert all(NAME.match(w[k]) for k in ("config", "traffic"))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_entries_have_just_their_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("servebench/") and _line(c["source"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _line(m["layer"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_reports_enough(w):
    cell = spec.load_cell(w["name"])
    e2e = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in e2e
        assert callable(spec.load_reader(m["name"]).read)
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert cell.config["name"] == conf["name"]
    assert cell.config["source"] == conf["source"]
    assert cell.config["reduced"] == conf["reduced"]
    # the file's sizes are the program's (port_config raises otherwise)
    spec.port_config(cell.config)
    numbers = {"logits_rel"} | {
        k["number"] for k in cell.config["cache"].values()}
    assert set(cell.checks["limits"]) <= numbers
    assert "longest" in cell.checks["sample"]
    assert Judge(cell.config["cache"]).numbers().keys() <= numbers


def test_each_config_and_traffic_file_says_where_from_who_and_why():
    for c in BENCH["configs"]:
        conf = json.loads((spec.ROOT / c["file"]).read_text())
        assert {"source", "who", "why", "assumed", "reduced"} <= set(conf)
    for w in BENCH["workloads"]:
        t = json.loads((spec.HERE / "traffic" /
                        f"{w['traffic']}.json").read_text())
        assert {"source", "who", "why"} <= set(t)


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
