"""Placing parameter, optimizer, batch and cache trees on a device mesh.

The counterpart of the reference's ``jax.device_put(tree, shardings)`` and
``jit(..., in_shardings=...)`` (``train/loop.py``, ``launch/dryrun.py``),
on ``torch.distributed.tensor``: a tensor becomes a ``DTensor`` whose
placements follow the spec that ``distributed.sharding`` computes, and the
eager model functions then run unchanged on DTensors, as the reference's
run unchanged under GSPMD.

A spec entry at tensor dim ``i`` gives ``Shard(i)`` to every mesh dim it
names and ``Replicate()`` to every other mesh dim; an entry such as
``("pod", "data")`` shards dim ``i`` over both, ``pod`` the outer.  The
port holds a stacked subtree (``models.common.STACKED``) as a list of
per-layer trees: each piece takes the stacked spec without its leading
``layers`` entry, which the rules never shard.

A mesh here is a ``torch.distributed`` ``DeviceMesh`` whose dim names are
the ``launch.mesh.MeshShape``'s axis names (``launch.mesh.make_device_mesh``);
``distributed.sharding`` computes specs from it as from a ``MeshShape``.
Placing slices each rank's own copy (``src_data_rank=None``): every rank
must hold the same full tree, as it does when all draw from one seed or
read one checkpoint.
"""
from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.distributed.sharding import (DECODE_SEQ_SHARD, DEFAULT_RULES,
                                              ShardingRules, batch_sharding,
                                              cache_shardings,
                                              params_shardings)
from repro_torch.launch.mesh import mesh_shape

Tree = Any
Spec = Tuple[Any, ...]

# the reference's rule sets by name (its ``launch/dryrun.py`` RULE_SETS)
RULE_SETS = {
    "default": ShardingRules(tuple(DEFAULT_RULES.items())),
    "decode-seq-shard": ShardingRules(tuple(DECODE_SEQ_SHARD.items()))}


def spec_placements(spec: Spec, mesh_dim_names: Sequence[str]
                    ) -> Tuple[Placement, ...]:
    """One placement per mesh dim for a spec tuple."""
    out = [Replicate()] * len(mesh_dim_names)
    for i, entry in enumerate(spec):
        names = entry if isinstance(entry, tuple) else \
            (entry,) if entry else ()
        for a in names:
            out[list(mesh_dim_names).index(a)] = Shard(i)
    return tuple(out)


def _piece_specs(specs: Tree) -> Tree:
    """A stacked subtree's specs without their leading (``layers``)
    entry."""
    if isinstance(specs, dict):
        return {k: _piece_specs(v) for k, v in specs.items()}
    if specs and specs[0] is not None:
        raise ValueError(f"stacked spec {specs} shards the layers dim")
    return tuple(specs[1:])


def map_with_specs(fn, tree: Tree, specs: Tree) -> Tree:
    """``fn(leaf, spec)`` over a port tree (per-layer lists) and the spec
    tree in the reference's stacked layout."""
    if isinstance(tree, dict):
        return {k: map_with_specs(fn, tree[k], specs[k]) for k in tree}
    if isinstance(tree, list):
        piece = _piece_specs(specs)
        return [map_with_specs(fn, t, piece) for t in tree]
    return fn(tree, specs)


def place(t: torch.Tensor, mesh, spec: Spec) -> DTensor:
    """``t`` (the same full tensor on every rank) as a DTensor of ``spec``
    on ``mesh``; a meta tensor stays meta."""
    return distribute_tensor(t, mesh, spec_placements(spec,
                                                      mesh.mesh_dim_names),
                             src_data_rank=None)


def place_tree(tree: Tree, specs: Tree, mesh) -> Tree:
    return map_with_specs(lambda t, s: place(t, mesh, s), tree, specs)


def place_params(params: Tree, model, mesh,
                 rules: ShardingRules = ShardingRules()) -> Tree:
    return place_tree(params, params_shardings(model, mesh_shape(mesh), rules),
                      mesh)


def place_opt(opt, model, mesh, rules: ShardingRules = ShardingRules()):
    """AdamW state: ``m`` and ``v`` follow the parameters, ``step`` is
    replicated."""
    specs = params_shardings(model, mesh_shape(mesh), rules)
    return type(opt)(step=place(opt.step, mesh, ()),
                     m=place_tree(opt.m, specs, mesh),
                     v=place_tree(opt.v, specs, mesh))


def batch_spec(mesh, shape: Tuple[int, ...],
               rules: ShardingRules = ShardingRules()) -> Spec:
    """The batch dim over ``(pod, data)``; replicated where the batch does
    not divide that extent (``long_500k``'s B = 1) or for a scalar."""
    if not shape:
        return ()
    mesh = mesh_shape(mesh)
    spec = batch_sharding(mesh, len(shape), rules)
    entry = spec[0]
    names = entry if isinstance(entry, tuple) else (entry,) if entry else ()
    size = 1
    for a in names:
        size *= mesh.shape[a]
    return spec if shape[0] % size == 0 else ()


def place_batch(batch: Dict[str, torch.Tensor], mesh,
                rules: ShardingRules = ShardingRules()) -> Dict:
    return {k: place(v, mesh, batch_spec(mesh, tuple(v.shape), rules))
            for k, v in batch.items()}


def place_cache(cache: Tree, model, mesh, batch: int, seq: int,
                rules: ShardingRules = ShardingRules()) -> Tree:
    """A decode cache (the reference's stacked layout) by
    ``cache_shardings``; ``RULE_SETS["decode-seq-shard"]`` shards the KV
    sequence over ``model``."""
    return place_tree(cache, cache_shardings(model, mesh_shape(mesh), batch,
                                             seq, rules), mesh)


def redistribute_like(tree: Tree, like: Tree) -> Tree:
    """Each DTensor leaf of ``tree`` in the placements of its leaf in
    ``like`` (gradients come back ``Partial`` / replicated where their
    parameter is sharded); plain tensors pass through."""
    if isinstance(tree, dict):
        return {k: redistribute_like(tree[k], like[k]) for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(redistribute_like(t, l)
                          for t, l in zip(tree, like))
    if isinstance(tree, DTensor) and isinstance(like, DTensor) \
            and tree.placements != like.placements:
        return tree.redistribute(like.device_mesh, like.placements)
    return tree


def gather_full(tree: Tree) -> Tree:
    """Every DTensor leaf as its full (global) plain tensor, on every rank;
    other leaves as they are.  NamedTuples keep their type."""
    if isinstance(tree, dict):
        return {k: gather_full(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(gather_full(t) for t in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(gather_full(t) for t in tree)
    return to_plain(tree)


def to_plain(t):
    """A ``DTensor``'s full value (a plain tensor as it is)."""
    return t.full_tensor() if isinstance(t, DTensor) else t
