"""Logical-axis -> mesh-axis sharding rules (FSDP + TP, MaxText-style).

Twin of the reference's ``distributed/sharding.py``.  Every ParamDef carries
logical axis names; the rules map them onto the production mesh axes
("pod", "data", "model").  Parameters shard FSDP-style on "data" along
d_model and tensor-parallel on "model" along heads / ffn / experts / vocab;
"pod" is pure data parallelism.  Where a dimension is not divisible by its
mesh axis (qwen2's 14 heads on model=16, mamba2's 24 SSD heads), the rule
falls back to replication for that dim -- recorded per tensor by
``spec_report``.

A mesh is anything with a ``.shape`` mapping of axis name -> size
(``launch.mesh.MeshShape``; ``launch.mesh.mesh_shape`` of a
``DeviceMesh``).  A spec is a tuple with the entries of the reference's
``PartitionSpec`` (a mesh axis name, a tuple of them, or None per dim,
trailing Nones dropped); a tree of specs keeps the reference's stacked keys.
``distributed.placement`` places tensors on a device mesh by these specs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Tuple

Tree = Any
Spec = Tuple[Any, ...]

# logical axis -> preferred mesh axis (None = replicate)
DEFAULT_RULES: Dict[str, Optional[str]] = {
    "vocab": "model",
    "heads": "model",
    "kv_heads": "model",
    "d_ff": "model",
    "experts": "model",       # expert parallelism shares the TP axis
    "d_inner": "model",
    "ssm_heads": "model",
    "d_model": "data",        # FSDP: shard the residual dim over data
    "batch": ("pod", "data"),
    "kv_seq": None,           # decode KV-cache seq; "model" = flash-decoding
    "layers": None,           # scan dim — never sharded
    "shared_blocks": None,
    "groups": None,
}

# flash-decoding layout — decode caches shard the sequence dim over "model"
# (each card holds S/16 of every head's cache and computes partial
# attention).  Wins whenever kv_heads can't use the model axis (MLA: no
# heads; GQA with kv_heads % 16 != 0: phi3's 10, stablelm's 8).
DECODE_SEQ_SHARD = dict(DEFAULT_RULES)
DECODE_SEQ_SHARD["kv_seq"] = "model"
DECODE_SEQ_SHARD["kv_heads"] = None        # seq owns the model axis


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    rules: Tuple[Tuple[str, Any], ...] = tuple(DEFAULT_RULES.items())

    def lookup(self, name: Optional[str]):
        if name is None:
            return None
        return dict(self.rules).get(name, None)

    def replace(self, **kw) -> "ShardingRules":
        d = dict(self.rules)
        d.update(kw)
        return ShardingRules(tuple(d.items()))


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def spec_for(shape: Tuple[int, ...], axes: Tuple[Optional[str], ...],
             mesh, rules: ShardingRules = ShardingRules()) -> Spec:
    """The spec of one tensor, replicating non-divisible dims.  Each mesh
    axis is used at most once per tensor."""
    used: set = set()
    out: List[Any] = []
    for dim, name in zip(shape, axes):
        mesh_axis = rules.lookup(name)
        flat = tuple(a for a in (mesh_axis if isinstance(mesh_axis, tuple)
                                 else (mesh_axis,) if mesh_axis else ())
                     if a in mesh.shape)        # drop axes absent from mesh
        mesh_axis = (flat if len(flat) > 1 else flat[0] if flat else None)
        ok = (mesh_axis is not None
              and not any(a in used for a in flat)
              and dim % _axis_size(mesh, mesh_axis) == 0)
        if ok:
            out.append(mesh_axis)
            used.update(flat)
        else:
            out.append(None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _map_defs(fn, axes: Tree, specs: Tree, path: str = "") -> Tree:
    """``fn(path, axes, spec)`` per leaf of two trees of dicts (the axes'
    leaves are tuples, so the walk goes by dicts only)."""
    if isinstance(specs, dict):
        return {k: _map_defs(fn, axes[k], specs[k], f"{path}[{k!r}]")
                for k in sorted(specs)}
    return fn(path, axes, specs)


def tree_shardings(defs_axes: Tree, defs_shapes: Tree, mesh,
                   rules: ShardingRules = ShardingRules()) -> Tree:
    """(axes tree, shape tree) -> spec tree."""
    return _map_defs(lambda _, ax, sp: spec_for(tuple(sp.shape), ax, mesh,
                                                rules),
                     defs_axes, defs_shapes)


def params_shardings(model, mesh,
                     rules: ShardingRules = ShardingRules()) -> Tree:
    """The spec tree of a ``repro_torch.models`` Model's parameters (the
    reference's stacked keys)."""
    return tree_shardings(model.param_axes(), model.param_specs(), mesh,
                          rules)


def cache_shardings(model, mesh, batch: int, seq: int,
                    rules: ShardingRules = ShardingRules()) -> Tree:
    return tree_shardings(model.cache_axes(batch, seq),
                          model.cache_specs(batch, seq), mesh, rules)


def batch_sharding(mesh, ndim: int = 2,
                   rules: ShardingRules = ShardingRules()) -> Spec:
    """Input batches shard the leading (batch) dim over pod×data."""
    axis = rules.lookup("batch")
    flat = [a for a in (axis if isinstance(axis, tuple) else (axis,))
            if a in mesh.shape]
    return (tuple(flat) if len(flat) > 1 else (flat[0] if flat else None),
            *([None] * (ndim - 1)))


def check_specs(specs: Tree, shapes: Tree, mesh) -> None:
    """Raise ``ValueError`` unless every spec fits its tensor on ``mesh``:
    no more entries than dims, known mesh axes, each used once, each
    sharded dim divisible by its axes' size."""
    def one(path, spec, shape):
        dims = tuple(shape.shape)
        used: List[str] = []
        if len(spec) > len(dims):
            raise ValueError(f"{path}: spec {spec} longer than {dims}")
        for dim, entry in zip(dims, spec):
            names = entry if isinstance(entry, tuple) else \
                (entry,) if entry else ()
            for a in names:
                if a not in mesh.shape or a in used:
                    raise ValueError(f"{path}: mesh axis {a!r} unknown or "
                                     f"used twice in {spec}")
                used.append(a)
            if dim % _axis_size(mesh, entry) != 0:
                raise ValueError(f"{path}: dim {dim} not divisible by "
                                 f"{entry} in {spec}")
    _map_defs(one, specs, shapes)


def spec_report(model, mesh,
                rules: ShardingRules = ShardingRules()) -> List[str]:
    """Human-readable list of tensors that fell back to replication."""
    lines: List[str] = []

    def one(path, ax, spec):
        p = spec_for(tuple(spec.shape), ax, mesh, rules)
        want = [rules.lookup(a) for a in ax]
        got = list(p) + [None] * (len(ax) - len(p))
        for i, (w, g) in enumerate(zip(want, got)):
            if w is not None and g is None:
                lines.append(
                    f"{path} dim{i} ({ax[i]}={spec.shape[i]})"
                    f" replicated (not divisible by {w})")
    _map_defs(one, model.param_axes(), model.param_specs())
    return lines
