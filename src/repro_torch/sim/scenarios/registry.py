"""Scenario-family registry: name -> parameterized, seeded generator.

A family is a callable ``family(seed=0, **params) -> scenario dict``.
Generators must be deterministic in (seed, params): the same call returns
a byte-identical scenario dict (verified by :func:`scenario_fingerprint`).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, Dict, List

import numpy as np

REGISTRY: Dict[str, Callable[..., Dict]] = {}


def register(name: str) -> Callable:
    """Decorator: add a scenario family under ``name``."""
    def deco(fn: Callable[..., Dict]) -> Callable[..., Dict]:
        if name in REGISTRY:
            raise ValueError(f"scenario family {name!r} already registered")
        REGISTRY[name] = fn
        fn.family_name = name
        return fn
    return deco


def make_scenario(name: str, seed: int = 0, **params) -> Dict:
    """Instantiate a registered family."""
    try:
        fn = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario family {name!r}; "
                       f"known: {family_names()}") from None
    return fn(seed=seed, **params)


def family_names() -> List[str]:
    return sorted(REGISTRY)


def family_params(name: str):
    """``(parameter names, accepts arbitrary kwargs)`` for a family.

    The spec layer validates scenario grammar entries against this before
    any simulator runs, so a typo like ``flash-crowd(magnitud=6)`` fails
    at parse time with the family's real parameter list instead of a
    ``TypeError`` deep inside a sweep worker.
    """
    import inspect
    try:
        fn = REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown scenario family {name!r}; "
                       f"known: {family_names()}") from None
    sig = inspect.signature(fn)
    has_var = any(p.kind is p.VAR_KEYWORD for p in sig.parameters.values())
    return set(sig.parameters) - {"seed"}, has_var


# --------------------------------------------------------------------------- #
# determinism certificate
# --------------------------------------------------------------------------- #
def _canon(obj):
    """Scenario dict -> nested plain structure with a stable ordering."""
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj).__name__,
                tuple((f.name, _canon(getattr(obj, f.name)))
                      for f in dataclasses.fields(obj)))
    if isinstance(obj, dict):
        return tuple(sorted((str(k), _canon(v)) for k, v in obj.items()))
    if isinstance(obj, (list, tuple)):
        return tuple(_canon(v) for v in obj)
    if isinstance(obj, np.ndarray):
        return ("ndarray", obj.shape, tuple(obj.ravel().tolist()))
    if isinstance(obj, (np.floating, np.integer)):
        return obj.item()
    if callable(obj):                    # work-model helpers etc.
        return getattr(obj, "__qualname__", repr(obj))
    return obj


def scenario_fingerprint(scenario: Dict) -> str:
    """Stable hash of a scenario dict — equal iff byte-identical content."""
    blob = repr(_canon(scenario)).encode()
    return hashlib.sha256(blob).hexdigest()
