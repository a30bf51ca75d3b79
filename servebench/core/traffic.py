"""The one traffic generator: a closed loop of prefill calls whose lengths
follow the law in a traffic file.

A traffic file (``servebench/traffic/<name>.json``) holds:

* ``rows``: prompts a call (one length a call; the port prefills equal-length
  rows);
* ``law``: ``{"kind": "choice", "values": [...]}`` (uniform over the values)
  or ``{"kind": "lognormal", "mu", "sigma", "low", "high"}`` (clipped and
  truncated to whole tokens, as ``sim/workload.py`` draws prompts);
* ``measures``: ``"positions"`` (the drawn number is the whole prompt,
  patches included) or ``"text"`` (text tokens, after the patches);
* ``per_pass``: how many calls make one pass over the law.

Every seed serves the same set of lengths, in another order: a pass is the
law's ``per_pass`` stratified quantiles ((i + 0.5) / per_pass; for
``choice`` each value ``per_pass / len(values)`` times), and the seed draws
the order of each pass.  So the work of a window, and the tails of its
requests, do not change with the seed, and a run's spread is the system's.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Iterator, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class Call:
    """One prefill call: ``rows`` prompts of ``text`` tokens after
    ``prefix`` patch positions (``positions`` = prefix + text a row)."""
    index: int
    rows: int
    text: int
    prefix: int

    @property
    def positions(self) -> int:
        return self.prefix + self.text


def pass_lengths(spec: dict) -> List[int]:
    """The drawn quantity of one pass, in the law's order (ascending)."""
    law, k = spec["law"], spec["per_pass"]
    if law["kind"] == "choice":
        values = law["values"]
        if k % len(values):
            raise ValueError(f"per_pass {k} is not a multiple of the "
                             f"{len(values)} values of the law")
        return sorted(values * (k // len(values)))
    if law["kind"] == "lognormal":
        nd = NormalDist()
        out = []
        for i in range(k):
            x = math.exp(law["mu"] + law["sigma"]
                         * nd.inv_cdf((i + 0.5) / k))
            out.append(int(min(max(x, law["low"]), law["high"])))
        return out
    raise ValueError(f"unknown law {law['kind']!r}")


def text_lengths(spec: dict, prefix: int) -> List[int]:
    """Text tokens of each call of one pass (ascending)."""
    lengths = pass_lengths(spec)
    if spec["measures"] == "positions":
        lengths = [n - prefix for n in lengths]
    elif spec["measures"] != "text":
        raise ValueError(f"measures must be 'positions' or 'text', got "
                         f"{spec['measures']!r}")
    if min(lengths) < 1:
        raise ValueError(f"a call of {min(lengths)} text tokens after "
                         f"{prefix} patches")
    return lengths


def order_rng(seed: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed % 2**64, 1]))


def calls(spec: dict, prefix: int, seed: int) -> Iterator[Call]:
    """The calls of a run, pass after pass, each pass in an order drawn
    from ``seed``."""
    lengths = text_lengths(spec, prefix)
    rng = order_rng(seed)
    index = 0
    while True:
        for j in rng.permutation(len(lengths)):
            yield Call(index, spec["rows"], lengths[j], prefix)
            index += 1


def first_pass(spec: dict, prefix: int, seed: int) -> List[Call]:
    it = calls(spec, prefix, seed)
    return [next(it) for _ in range(spec["per_pass"])]
