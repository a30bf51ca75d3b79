"""Device meshes (twin of the reference's ``launch/mesh.py``).

A :class:`MeshShape` names the axes and their sizes and nothing else: it is
what ``distributed.sharding`` needs to compute specs, and building one
touches no device.  :func:`make_device_mesh` turns it into a
``torch.distributed`` ``DeviceMesh`` over the ranks of the initialised
process group (one rank a card, or gloo ranks on the host), with the same
dim names; ``distributed.placement`` places tensors on it.  The production
meshes are 256 and 512 cards: ``launch.dryrun`` builds them on a fake
process group of that many ranks in one process.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

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


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (a ``MeshShape`` as it
    is)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(mesh.shape))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16×16 single pod (256 cards) or 2×16×16 two pods (512 cards)."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def make_device_mesh(mesh: MeshShape, device_type: Optional[str] = None):
    """A ``DeviceMesh`` of ``mesh``'s shape and axis names over the ranks
    of the initialised process group (whose world size must be
    ``mesh.size``); CUDA unless ``device_type`` says otherwise."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or "cuda", tuple(mesh.sizes),
                            mesh_dim_names=tuple(mesh.axis_names))


def _device_count() -> int:
    """The world size under an initialised process group, else the CUDA
    devices there are (the host counts as one where there is none)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1)


def make_debug_mesh(data: int = 1, model: int = 1) -> MeshShape:
    """A small mesh over the devices there are, clamped as in the
    reference (which clamps to ``len(jax.devices())``)."""
    n = _device_count()
    data = min(data, n)
    model = max(min(model, n // data), 1)
    return MeshShape(("data", "model"), (data, model))
