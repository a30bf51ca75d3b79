"""`ExperimentSpec`: experiments-as-data for every frontend.

A spec names the full grid — methods × scenarios × seeds plus the shared
run parameters (engine, batching, workers, workload overrides) — in one
typed, hashable object.  Methods and scenarios are canonical dicts (the
:mod:`repro_torch.exp.grammar` forms), so a spec round-trips exactly through
grammar strings, JSON and TOML files, and the CLI::

    spec = ExperimentSpec(
        methods=("haf(agent=qwen3-32b-sim, critic=@critic?)", "haf-static"),
        scenarios=("paper", "flash-crowd(rho=0.95)"),
        seeds=(0, 1, 2))
    spec.to_file("experiments/my_sweep.toml")
    # later / elsewhere:
    #   python -m repro_torch.eval --spec experiments/my_sweep.toml

Two hashes stamp provenance and drive resume:

  * :meth:`spec_hash` — the full canonical spec (anything changes it);
  * :meth:`identity_hash` — only the **result-affecting** fields
    (methods, scenarios, workload overrides, epoch/event limits,
    scenario seed).  Seeds are excluded — a (cell, seed) row is keyed
    individually — and so are engine/batch/workers, which the engine
    equivalence suite holds bit-identical.  Extending the seed list or
    changing worker counts therefore still resumes a partial report.

The canonical form, both hashes and the file formats are the JAX
package's (``"kind": "repro.exp.experiment"``), so for equal fields a
spec hashes alike in both packages and a report written by either
resumes in the other.  The engines are this package's, and the default
is ``cuda``: the port's entry points run on the card unless the caller
asks for the host (``engine="numpy"``).

TOML files read through the standard library's ``tomllib``; writing uses
a minimal emitter (the standard library has no TOML writer) restricted
to the flat spec schema.
"""
from __future__ import annotations

import dataclasses
import hashlib
import inspect
import json
import pathlib
import tomllib
from typing import Dict, List, Optional, Sequence, Tuple, Union

from repro_torch.exp import grammar
from repro_torch.exp.grammar import GrammarError

__all__ = ["ExperimentSpec", "SpecError", "load_experiment"]

# numpy / scalar: the host engines; torch: the eager float64 core on a
# device; cuda: the hand-written event_step kernel, one launch a tick of a
# [B, S] block (a group of one seed runs as a one-replica block)
ENGINES = ("numpy", "scalar", "torch", "cuda")


class SpecError(ValueError):
    """An experiment spec that cannot run; the message lists every problem."""


# -------------------------------------------------------------------- #
# field classification registries
#
# Every ExperimentSpec field lives in EXACTLY one of these two tuples —
# _check_field_partition() asserts it at import time, so a new field
# cannot silently stay out of identity_hash and poison resume.
# identity() is built FROM _IDENTITY_FIELDS.
# -------------------------------------------------------------------- #

#: result-affecting: changing one of these invalidates every cached row
_IDENTITY_FIELDS = ("methods", "scenarios", "n_ai_requests", "rho",
                    "epoch_interval", "max_events", "scenario_seed")

#: provably non-result-affecting, excluded from identity_hash:
#:   seeds           — rows are keyed (cell, seed) individually, so
#:                     extending the seed list still resumes
#:   name, out       — labels/paths, never inputs
#:   engine/batch/workers — held bit-identical by the equivalence suites
#:                     (a cuda row equals the numpy row of the same job)
#:   trace/profile/metrics_interval — obs is zero-overhead-when-off and
#:                     obs-on ≡ obs-off bit-for-bit
#:   stream/window   — memory knobs; streamed ≡ materialized contract
_EXCLUDED_FIELDS = ("seeds", "name", "out", "engine", "batch", "workers",
                    "trace", "profile", "metrics_interval",
                    "stream", "window")


def _canon_method(entry) -> Dict:
    if isinstance(entry, str):
        return grammar.parse_method(entry)
    out = {"name": entry["name"], "params": dict(entry.get("params", {}))}
    out["label"] = entry.get("label", out["name"])
    return out


def _canon_scenario(entry) -> Dict:
    if isinstance(entry, str):
        return grammar.parse_scenario(entry)
    out = {"family": entry["family"],
           "params": dict(entry.get("params", {}))}
    out["label"] = entry.get("label", out["family"])
    return out


def _canon_seeds(seeds) -> Tuple[int, ...]:
    if isinstance(seeds, str):
        return tuple(grammar.parse_seeds(seeds))
    if isinstance(seeds, int):
        return tuple(grammar.parse_seeds(str(seeds)))
    return tuple(int(s) for s in seeds)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """The declarative experiment: grid + run parameters + output."""
    methods: Sequence = ("haf", "haf-static", "round-robin", "lyapunov")
    scenarios: Sequence = ("paper", "diurnal", "flash-crowd")
    seeds: Sequence = (0, 1)
    name: str = "experiment"
    n_ai_requests: Optional[int] = None     # override every scenario
    rho: Optional[float] = None             # override every scenario's ρ
    epoch_interval: float = 5.0
    max_events: int = 5_000_000
    scenario_seed: int = 0
    engine: str = "cuda"                    # the card; "numpy" on the host
    batch: int = 1                          # >1: fan seeds into run_batch
    workers: int = 1
    out: Optional[str] = None               # report path (CLI may override)
    # observability (repro_torch.obs) — excluded from identity_hash, so a
    # traced rerun of an experiment resumes the untraced report and vice versa
    trace: bool = False
    profile: bool = False
    metrics_interval: float = 0.0           # 0 = no time-series sampling
    # streaming arrivals (repro_torch.sim.stream) — memory knobs, provably
    # non-result-affecting (the streamed ≡ materialized contract), so
    # both are excluded from identity_hash: a streamed rerun resumes a
    # materialized report and vice versa.  window=0 keeps the source
    # stream's native chunking; trace-family scenarios always stream.
    stream: bool = False
    window: int = 0

    def __post_init__(self):
        object.__setattr__(self, "methods",
                           tuple(_canon_method(m) for m in self.methods))
        object.__setattr__(self, "scenarios",
                           tuple(_canon_scenario(s) for s in self.scenarios))
        object.__setattr__(self, "seeds", _canon_seeds(self.seeds))

    # ------------------------------------------------------------------ #
    # canonical forms + hashes
    # ------------------------------------------------------------------ #
    def canonical(self) -> Dict:
        """The full canonical dict (JSON-stable; the provenance form)."""
        return {
            "kind": "repro.exp.experiment",
            "version": 1,
            "name": self.name,
            "methods": [dict(m, params=dict(m["params"]))
                        for m in self.methods],
            "scenarios": [dict(s, params=dict(s["params"]))
                          for s in self.scenarios],
            "seeds": list(self.seeds),
            "n_ai_requests": self.n_ai_requests,
            "rho": self.rho,
            "epoch_interval": self.epoch_interval,
            "max_events": self.max_events,
            "scenario_seed": self.scenario_seed,
            "engine": self.engine,
            "batch": self.batch,
            "workers": self.workers,
            "out": self.out,
            "trace": self.trace,
            "profile": self.profile,
            "metrics_interval": self.metrics_interval,
            "stream": self.stream,
            "window": self.window,
        }

    def identity(self) -> Dict:
        """The result-affecting subset (see ``_IDENTITY_FIELDS``)."""
        c = self.canonical()
        out = {k: c[k] for k in _IDENTITY_FIELDS}
        # a scenario's own window= is the streaming refill granularity
        # (trace family) — a memory knob like the spec-level one, so it
        # must not fork the identity either
        out["scenarios"] = [
            dict(s, params={k: v for k, v in s["params"].items()
                            if k != "window"})
            for s in out["scenarios"]]
        return out

    @staticmethod
    def _hash(obj) -> str:
        blob = json.dumps(obj, sort_keys=True, default=str).encode()
        return hashlib.sha256(blob).hexdigest()

    def spec_hash(self) -> str:
        return self._hash(self.canonical())

    def identity_hash(self) -> str:
        return self._hash(self.identity())

    # ------------------------------------------------------------------ #
    # execution views
    # ------------------------------------------------------------------ #
    def to_sweep_spec(self, device="cuda"):
        """The runnable :class:`repro_torch.eval.SweepSpec` view of this
        spec; ``device`` is where the ``torch`` / ``cuda`` engines run (a
        placement, like ``engine`` outside the result identity)."""
        from repro_torch.eval.sweep import SweepSpec
        trace_dir = None
        if self.trace:
            base = pathlib.Path(self.out) if self.out else \
                pathlib.Path("artifacts/sweep_report.json")
            trace_dir = str(base.parent / f"{base.stem}_traces")
        return SweepSpec(
            methods=self.methods,
            scenarios=self.scenarios,
            seeds=self.seeds,
            n_ai_requests=self.n_ai_requests,
            rho=self.rho,
            epoch_interval=self.epoch_interval,
            max_events=self.max_events,
            workers=self.workers,
            scenario_seed=self.scenario_seed,
            engine=self.engine,
            batch_seeds=self.batch,
            trace=self.trace,
            profile=self.profile,
            metrics_interval=self.metrics_interval,
            trace_dir=trace_dir,
            stream=self.stream,
            window=self.window,
            device=device,
        )

    def expand(self) -> List[Dict]:
        """The full expanded job list (one simulator run per entry)."""
        from repro_torch.eval.sweep import expand_jobs
        return expand_jobs(self.to_sweep_spec())

    # ------------------------------------------------------------------ #
    # derivation helpers
    # ------------------------------------------------------------------ #
    def replace(self, **changes) -> "ExperimentSpec":
        return dataclasses.replace(self, **changes)

    def _with_params(self, field: str, selector: str, key_field: str,
                     params: Dict) -> "ExperimentSpec":
        entries, hit = [], False
        for e in getattr(self, field):
            if selector in (e["label"], e[key_field]):
                e = dict(e, params=dict(e["params"], **params))
                hit = True
            entries.append(e)
        if not hit:
            known = sorted({e["label"] for e in getattr(self, field)}
                           | {e[key_field] for e in getattr(self, field)})
            raise SpecError(f"no {field[:-1]} matches {selector!r}; "
                            f"known: {known}")
        return self.replace(**{field: tuple(entries)})

    def with_method_params(self, selector: str, **params) -> "ExperimentSpec":
        """A copy with ``params`` merged into every method whose label or
        name equals ``selector`` (runtime-fitted values, e.g. CAORA α)."""
        return self._with_params("methods", selector, "name", params)

    def with_scenario_params(self, selector: str, **params
                             ) -> "ExperimentSpec":
        return self._with_params("scenarios", selector, "family", params)

    # ------------------------------------------------------------------ #
    # files
    # ------------------------------------------------------------------ #
    def to_dict(self) -> Dict:
        """The spec-file form: grammar strings for methods/scenarios."""
        d: Dict = {"name": self.name,
                   "methods": [grammar.format_method(m)
                               for m in self.methods],
                   "scenarios": [grammar.format_scenario(s)
                                 for s in self.scenarios],
                   "seeds": list(self.seeds)}
        defaults = {f.name: f.default for f in dataclasses.fields(self)}
        for key in ("n_ai_requests", "rho", "epoch_interval", "max_events",
                    "scenario_seed", "engine", "batch", "workers", "out",
                    "trace", "profile", "metrics_interval",
                    "stream", "window"):
            val = getattr(self, key)
            if val != defaults[key]:
                d[key] = val
        return d

    _FILE_KEYS = {"name", "methods", "scenarios", "seeds", "n_ai_requests",
                  "rho", "epoch_interval", "max_events", "scenario_seed",
                  "engine", "batch", "workers", "out",
                  "trace", "profile", "metrics_interval",
                  "stream", "window",
                  "batch_seeds", "requests"}   # accepted aliases

    @classmethod
    def from_dict(cls, d: Dict, source: str = "<dict>") -> "ExperimentSpec":
        d = dict(d)
        d.pop("kind", None)
        d.pop("version", None)
        unknown = sorted(set(d) - cls._FILE_KEYS)
        if unknown:
            raise SpecError(f"{source}: unknown spec keys {unknown}; "
                            f"known: {sorted(cls._FILE_KEYS)}")
        if "batch_seeds" in d:
            d["batch"] = d.pop("batch_seeds")
        if "requests" in d:
            d["n_ai_requests"] = d.pop("requests")
        try:
            return cls(**d)
        except GrammarError as err:
            raise SpecError(f"{source}: {err}") from None

    @classmethod
    def from_file(cls, path) -> "ExperimentSpec":
        path = pathlib.Path(path)
        text = path.read_text()
        if path.suffix.lower() == ".toml":
            try:
                data = tomllib.loads(text)
            except tomllib.TOMLDecodeError as err:
                raise SpecError(f"{path}: not valid TOML: {err}") from None
        elif path.suffix.lower() == ".json":
            data = json.loads(text)
        else:
            raise SpecError(f"{path}: spec files are .toml or .json")
        return cls.from_dict(data, source=str(path))

    def to_file(self, path) -> pathlib.Path:
        path = pathlib.Path(path)
        path.parent.mkdir(parents=True, exist_ok=True)
        d = self.to_dict()
        if path.suffix.lower() == ".toml":
            path.write_text(_toml_dumps(d))
        elif path.suffix.lower() == ".json":
            path.write_text(json.dumps(d, indent=2))
        else:
            raise SpecError(f"{path}: spec files are .toml or .json")
        return path

    # ------------------------------------------------------------------ #
    # validation
    # ------------------------------------------------------------------ #
    def validate(self) -> None:
        """Raise :class:`SpecError` listing every problem (else return)."""
        from repro_torch.eval.policies import _REGISTRY, method_names
        from repro_torch.sim.scenarios import family_names
        from repro_torch.sim.scenarios.registry import family_params

        problems: List[str] = []
        # labels key result rows (aggregation cells AND resume job keys),
        # so two entries sharing one would silently merge/cross-resume
        for kind, entries in (("method", self.methods),
                              ("scenario", self.scenarios)):
            seen: Dict[str, int] = {}
            for e in entries:
                seen[e["label"]] = seen.get(e["label"], 0) + 1
            dups = sorted(label for label, n in seen.items() if n > 1)
            if dups:
                problems.append(
                    f"duplicate {kind} labels {dups}: rows are keyed by "
                    f"label, so same-named {kind}s would merge in the "
                    "aggregate and cross-resume; disambiguate with "
                    "label=... on each entry")
        legacy_llm = any(m["name"] == "haf-llm"
                         and m["label"].startswith("haf-llm(")
                         for m in self.methods)
        for m in self.methods:
            if m["name"] not in method_names():
                msg = (f"unknown method {m['name']!r}; "
                       f"known: {method_names()}")
                if legacy_llm:
                    msg += ("; if this fragment belongs to a haf-llm:<cmd> "
                            "command, the legacy sugar cannot contain "
                            "commas — write haf-llm(cmd=\"...\") instead")
                problems.append(msg)
                continue
            sig = inspect.signature(_REGISTRY[m["name"]])
            has_var = any(p.kind is p.VAR_KEYWORD
                          for p in sig.parameters.values())
            problems += _check_params(f"method {m['label']!r}", m["params"],
                                      set(sig.parameters), has_var)
            if m["name"] == "haf-llm" and "cmd" not in m["params"]:
                problems.append(
                    f"method {m['label']!r}: haf-llm needs cmd= "
                    "(haf-llm(cmd=\"<shell command>\"))")
        for s in self.scenarios:
            if s["family"] not in family_names():
                problems.append(f"unknown scenario family {s['family']!r}; "
                                f"known: {family_names()}")
                continue
            names, has_var = family_params(s["family"])
            problems += _check_params(f"scenario {s['label']!r}",
                                      s["params"], names, has_var)
        if not self.seeds:
            problems.append(f"no seeds ({grammar.SEEDS_HINT})")
        if self.engine not in ENGINES:
            problems.append(f"unknown engine {self.engine!r}; "
                            f"known: {ENGINES}")
        if self.batch < 1:
            problems.append("batch must be >= 1")
        if self.workers < 1:
            problems.append("workers must be >= 1")
        if self.epoch_interval <= 0:
            problems.append("epoch_interval must be > 0")
        if self.metrics_interval < 0:
            problems.append("metrics_interval must be >= 0")
        if self.window < 0:
            problems.append("window must be >= 0 (0 = native chunking)")
        if problems:
            raise SpecError("; ".join(problems))


def _check_field_partition() -> None:
    """Import-time guard: the two registries partition the dataclass."""
    names = {f.name for f in dataclasses.fields(ExperimentSpec)}
    ident, excl = set(_IDENTITY_FIELDS), set(_EXCLUDED_FIELDS)
    problems = []
    if ident & excl:
        problems.append(f"fields in BOTH registries: {sorted(ident & excl)}")
    if names - ident - excl:
        problems.append(
            f"unclassified ExperimentSpec fields: "
            f"{sorted(names - ident - excl)} — add each to "
            "_IDENTITY_FIELDS (result-affecting) or _EXCLUDED_FIELDS "
            "(with a why-comment)")
    if (ident | excl) - names:
        problems.append(f"registry entries that are not fields: "
                        f"{sorted((ident | excl) - names)}")
    if problems:
        raise AssertionError(
            "repro_torch.exp.spec field registries out of sync: "
            + "; ".join(problems))


_check_field_partition()


def _check_params(where: str, params: Dict, names, has_var: bool
                  ) -> List[str]:
    """Unknown-parameter problems for one method/scenario entry."""
    if has_var:
        return []
    bad = sorted(set(params) - set(names))
    if bad:
        return [f"{where}: unknown parameter {bad}; "
                f"known: {sorted(names)}"]
    return []


def load_experiment(path) -> ExperimentSpec:
    """Shorthand for :meth:`ExperimentSpec.from_file`."""
    return ExperimentSpec.from_file(path)


# ------------------------------------------------------------------ #
# minimal TOML emitter (flat schema: scalars + lists of scalars)
# ------------------------------------------------------------------ #
def _toml_scalar(v) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return repr(v)
    if isinstance(v, str):
        return '"' + v.replace("\\", "\\\\").replace('"', '\\"') + '"'
    raise SpecError(f"cannot write {type(v).__name__} value {v!r} to TOML")


def _toml_dumps(d: Dict) -> str:
    lines: List[str] = []
    for key, val in d.items():
        if val is None:
            continue
        if isinstance(val, (list, tuple)):
            if all(isinstance(x, (int, float)) and not isinstance(x, bool)
                   for x in val):
                lines.append(f"{key} = [" +
                             ", ".join(_toml_scalar(x) for x in val) + "]")
            else:
                lines.append(f"{key} = [")
                lines.extend(f"  {_toml_scalar(x)}," for x in val)
                lines.append("]")
        else:
            lines.append(f"{key} = {_toml_scalar(val)}")
    return "\n".join(lines) + "\n"
