"""The control of the check: the reference put in the program's place,
computed one precision below the configuration's (bfloat16 -> float8 e4m3:
every weight product's operands rounded to e4m3, one scale per row of the
activations and per output column of the weights).

``Control(model, reference, sizes, cache_map)`` answers ``prefill`` like
the program: last-position logits ``[B, 1, V]`` and the cache in the
program's layout, so the harness serves and judges it unchanged.  A run
with the control must come out not correct; its readings are the upper
ends the check's limits are set below (PERF.md).
"""
from __future__ import annotations

from typing import Dict

import torch

from servebench.reference.plain import exact_float32, fp8_e4m3


class Control:
    def __init__(self, model, reference, sizes: Dict, cache_map: Dict):
        self.model = model
        self.reference = reference
        self.sizes = sizes
        self.cache_map = cache_map

    def param_defs(self):
        return self.model.param_defs()

    def prefill(self, params, batch):
        parts: Dict = {}

        def on_cache(kind, index, rows, t):
            parts.setdefault(kind, {}).setdefault(index, []).append(t)

        with exact_float32():
            logits = self.reference.prefill(params, batch, self.sizes,
                                            on_cache=on_cache,
                                            quant=fp8_e4m3)
        cache: Dict = {}
        for kind, by_index in parts.items():
            node = cache
            path = self.cache_map[kind]["path"]
            for key in path[:-1]:
                node = node.setdefault(key, {})
            node[path[-1]] = [torch.cat(by_index[i]) for i in
                              sorted(by_index)]
        return logits[:, None, :], cache
