"""Device-mesh shapes for sharding specs (twin of the reference's
``launch/mesh.py``).

A :class:`MeshShape` names the axes and their sizes and nothing else: it is
what ``distributed.sharding`` needs to compute specs.  The production
meshes are 256 and 512 cards; a ``torch.distributed`` mesh of that size
needs as many processes, and placing shards across cards is not done yet
(ROADMAP Queue A, multi-GPU placement).  Building one touches no device.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class MeshShape:
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 single pod (256 cards) or 2×16×16 two pods (512 cards)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_debug_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A small mesh over the CUDA devices there are (the host counts as
    one device where there is none), clamped as in the reference."""
    n = max(torch.cuda.device_count(), 1)
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return MeshShape(("data", "model"), (data, model))
