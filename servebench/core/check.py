"""What decides ``correct``: the window's logits, and the caches of the
calls it served, against the float32 reference.

For each call kept from the window (``sample`` in the cell's check file:
its longest call, and the others named there), the reference runs once over
the same prompts and the same weights, and these numbers are taken, each the
worst over the kept rows, layers and tensors:

* ``logits_rel``: |program - reference| / |reference| of a row's
  last-position logits (L2 norms);
* one number a cache kind (``cache`` in the configuration file): |program -
  reference| / |reference| of each layer's tensor over the kept rows (the
  attention keys and values, through the flash path), the program's cache
  being that of the kept call served again on the same model after the
  window (``window.reserve``).

The usual number of a served model, the gap by which the served token's
reference logit lies below the reference's best, is not compared: a prefill
serves one token a request, and the float8 control's argmax agrees with the
reference's about as often as the program's does, so the gap separates
nothing (PERF.md).

A number is compared with the limit the cell's check file gives it; the
limits and the readings they were set from are in PERF.md.
"""
from __future__ import annotations

import math
from typing import Dict, List

import torch


class Judge:
    """Collects the numbers of one run.  ``cache_map``: kind -> {"path":
    keys into the program's cache, "number": the number it feeds}."""

    def __init__(self, cache_map: Dict[str, dict]):
        self.cache_map = cache_map
        self.sums: Dict = {}
        self.rows: Dict[str, float] = {"logits_rel": 0.0}

    def _program(self, cache, kind: str, index: int) -> torch.Tensor:
        t = cache
        for key in self.cache_map[kind]["path"]:
            t = t[key]
        return t[index]

    def cache_hook(self, cache):
        """The reference's ``on_cache`` for one call whose program cache is
        ``cache``."""
        def on_cache(kind, index, rows, ref):
            got = self._program(cache, kind, index)[rows].float()
            if got.shape != ref.shape:
                raise ValueError(f"cache {kind}[{index}]: program "
                                 f"{tuple(got.shape)}, reference "
                                 f"{tuple(ref.shape)}")
            key = (self.cache_map[kind]["number"], kind, index)
            d2 = float((got - ref).square().sum())
            r2 = float(ref.square().sum())
            s = self.sums.setdefault(key, [0.0, 0.0])
            s[0] += d2 if math.isfinite(d2) else math.inf
            s[1] += r2
        return on_cache

    def logits(self, got: torch.Tensor, ref: torch.Tensor) -> None:
        """``got`` the program's last-position logits [rows, V], ``ref``
        the reference's."""
        got, ref = got.float(), ref.float()
        rel = (got - ref).norm(dim=-1) / ref.norm(dim=-1)
        worst = float(rel.max()) if bool(torch.isfinite(rel).all()) \
            else math.inf
        self.rows["logits_rel"] = max(self.rows["logits_rel"], worst)

    def numbers(self) -> Dict[str, float]:
        out = dict(self.rows)
        for (number, _, _), (d2, r2) in self.sums.items():
            out[number] = max(out.get(number, 0.0), math.sqrt(d2 / r2))
        return out


def verdict(numbers: Dict[str, float], limits: Dict[str, float]
            ) -> List[dict]:
    """Each limited number beside its limit, and whether it holds.  A
    number the run did not produce fails."""
    out = []
    for name, limit in limits.items():
        value = numbers.get(name)
        ok = value is not None and math.isfinite(value) and value <= limit
        out.append({"name": name, "value": value, "limit": limit, "ok": ok})
    return out
