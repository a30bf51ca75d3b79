"""A cell, found by its name in BENCHMARK.json: its configuration file, its
traffic file, its check file, its metrics and their readers."""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import pathlib
from types import ModuleType
from typing import Dict, List, Optional

ROOT = pathlib.Path(__file__).resolve().parents[2]
HERE = ROOT / "servebench"


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict          # servebench/configs/<config>.json
    traffic: dict         # servebench/traffic/<traffic>.json
    checks: dict          # servebench/checks/<cell>.json
    end_to_end: List[dict]
    per_layer: List[dict]

    @property
    def numbers(self) -> dict:
        """The configuration's sizes, as run."""
        return self.config["config"]

    @property
    def prefix(self) -> int:
        return self.numbers.get("num_patches", 0)

    def reference(self) -> ModuleType:
        return importlib.import_module(
            f"servebench.reference.{self.config['reference']}")


def _read(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: pathlib.Path = ROOT) -> Cell:
    bench = _read(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; workloads: "
                       f"{sorted(cells)}")
    w = cells[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "servebench"
    return Cell(
        name=name, chips=w["chips"],
        config=_read(root / conf["file"]),
        traffic=_read(here / "traffic" / f"{w['traffic']}.json"),
        checks=_read(here / "checks" / f"{name}.json"),
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, name)])


def load_reader(metric: str, root: pathlib.Path = ROOT) -> ModuleType:
    """``servebench/metrics/<metric>.py``: its ``read(trace)`` returns the
    metric's value, or None where the trace holds nothing for it."""
    path = root / "servebench" / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "servebench.metrics." + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def port_config(config: dict, numbers: Optional[Dict] = None):
    """The program's configuration of ``config["port_config"]`` in the
    configuration's dtype.  Every size the file states must be the
    program's: a configuration file is a copy of what runs.  ``numbers``
    (tests only) replaces the sizes instead.

    A size is the field of the same name of the program's configuration,
    or the dotted path that the file's ``fields`` gives it (``"num_patches":
    "vlm.num_patches"``: the field of a sub-configuration)."""
    from repro_torch.configs import get_config
    base = get_config(config["port_config"])
    fields = config.get("fields", {})
    cfg = _replace(base, numbers or config["config"], fields)
    cfg = dataclasses.replace(cfg, param_dtype=config["dtype"],
                              compute_dtype=config["dtype"])
    if numbers is None and _replace(base, config["config"], fields) != base:
        raise ValueError(f"{config['name']}: the sizes in its file differ "
                         f"from the program's {config['port_config']!r}")
    return cfg


def _replace(cfg, numbers: dict, fields: Dict[str, str]):
    top, subs = {}, {}
    for key, value in numbers.items():
        *sub, field = fields.get(key, key).split(".")
        if sub:
            subs.setdefault(sub[0], {})[field] = value
        else:
            top[field] = value
    for sub, values in subs.items():
        top[sub] = dataclasses.replace(getattr(cfg, sub), **values)
    return dataclasses.replace(cfg, **top)
