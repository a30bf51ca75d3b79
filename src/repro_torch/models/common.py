"""Shared model machinery: parameter definitions, norms, RoPE, SwiGLU.

Twin of the reference's ``models/common.py``.  Parameters are described by
trees (nested dicts) of :class:`ParamDef`, so one definition gives both the
parameter count and real tensors.  :func:`init_params` makes the tensors on
an explicit device from an explicit ``torch.Generator``, with the
reference's distributions (the values differ: the two frameworks' generators
do).

Differences from the reference, all forced by running eagerly:

- layer parameters are defined stacked (``[L, ...]``, :func:`stack_defs`,
  so counts and initial scales match the reference) and then held as a list
  of per-layer dicts (:func:`split_layers`); :data:`STACKED` names the
  subtrees that are stacked in the reference (:func:`split_stacked`);
- ``scan_layers`` is a Python loop over that list;
- :func:`shard_batch`, the reference's sharding constraint, redistributes a
  ``DTensor`` (``distributed.placement``) and is the identity on a plain
  tensor;
- activation checkpointing (:func:`checkpointed`) wraps one layer in
  ``torch.utils.checkpoint`` where the reference wraps the scan body in
  ``jax.checkpoint``.

:func:`param_specs` and :func:`param_axes` walk the *stacked* definition
tree, so their keys and shapes are the reference's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import math
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.obs.spans import span

Tree = Any

# the subtrees of a parameter tree that the reference stacks on a leading
# axis (layers of one kind, or the hybrid's shared blocks), and the
# published Zamba2's per-application weights (``apps``), stacked alike;
# ``mtp/block`` is a single layer and is not stacked
STACKED = ("layers", "dense_layers", "ssm_layers", "shared", "enc_layers",
           "dec_layers", "apps")

# elements of float32 noise drawn at once by init_params: a larger tensor is
# filled in pieces of this size, which bounds the transient memory of a
# multi-billion-parameter init (DeepSeek's expert stacks) to 256 MB
INIT_PIECE = 1 << 26


@dataclasses.dataclass(frozen=True)
class ParamDef:
    """Declarative parameter: shape + logical axes + init scheme."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (or None)
    init: str = "normal"              # normal | zeros | ones | small_normal
    scale: float = 1.0

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def tree_map(fn: Callable, tree: Tree) -> Tree:
    """Apply ``fn`` to every leaf of a tree of dicts / lists / tuples (dict
    keys in sorted order, as jax's tree utilities walk them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t) for t in tree)
    return fn(tree)


def tree_leaves(tree: Tree) -> List:
    out: List = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(like: Tree, leaves: Sequence) -> Tree:
    """``leaves`` (in :func:`tree_leaves` order) in the structure of
    ``like``."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), like)


@dataclasses.dataclass(frozen=True)
class TensorSpec:
    """A tensor's shape and dtype, nothing allocated (the reference's
    ``jax.ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


def param_specs(defs: Tree, dtype: torch.dtype) -> Tree:
    """The :class:`TensorSpec` of every ParamDef of a (stacked) tree."""
    return tree_map(lambda d: TensorSpec(tuple(d.shape), dtype), defs)


def param_axes(defs: Tree) -> Tree:
    """The logical axis names of every ParamDef: a tree whose leaves are
    tuples (walk it by the defs' structure, not with :func:`tree_map`)."""
    return tree_map(lambda d: d.axes, defs)


def _init_tensor(d: ParamDef, gen: torch.Generator, dtype: torch.dtype,
                 device: torch.device) -> torch.Tensor:
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=dtype, device=device)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=dtype, device=device)
    fan_in = d.shape[-2] if len(d.shape) >= 2 else max(d.shape[-1], 1)
    std = d.scale / math.sqrt(fan_in)
    if d.init == "small_normal":
        std = 0.02 * d.scale
    out = torch.empty(d.shape, dtype=dtype, device=device)
    flat = out.view(-1)
    for i in range(0, flat.numel(), INIT_PIECE):
        n = min(INIT_PIECE, flat.numel() - i)
        x = torch.randn(n, generator=gen, dtype=torch.float32, device=device)
        flat[i:i + n] = (x * std).to(dtype)
    return out


def init_params(defs: Tree, gen: torch.Generator, dtype: torch.dtype,
                device) -> Tree:
    """Real tensors for a ParamDef tree, drawn in sorted-key order from
    ``gen`` (a generator on ``device``)."""
    device = torch.device(device)
    return tree_map(lambda d: _init_tensor(d, gen, dtype, device), defs)


def param_count_tree(defs: Tree) -> int:
    return int(sum(math.prod(d.shape) for d in tree_leaves(defs)))


def stack_defs(defs: Tree, n: int, axis_name: str = "layers") -> Tree:
    """Prepend a stacking dim to every ParamDef (the reference's layout)."""
    return tree_map(lambda d: ParamDef((n,) + d.shape, (axis_name,) + d.axes,
                                       init=d.init, scale=d.scale), defs)


def split_layers(stacked: Tree) -> List[Tree]:
    """A tree of ``[L, ...]`` tensors -> a list of L per-layer trees (views
    of the stacked tensors, nothing is copied)."""
    n = tree_leaves(stacked)[0].shape[0]
    return [tree_map(lambda x, i=i: x[i], stacked) for i in range(n)]


def split_stacked(params: Tree) -> Tree:
    """``params`` with each subtree named in :data:`STACKED` split into a
    list of per-layer (per-block) trees; the other leaves as they are."""
    return {k: split_layers(v) if k in STACKED else v
            for k, v in params.items()}


def stack_stacked(params: Tree) -> Tree:
    """The inverse of :func:`split_stacked`: each per-layer list of a
    :data:`STACKED` subtree stacked into one tree of ``[L, ...]`` tensors
    (copies), the reference's layout."""
    return {k: stack_trees(v) if k in STACKED else v
            for k, v in params.items()}


def stack_trees(trees: Sequence[Tree]) -> Tree:
    """A list of per-layer trees of tensors -> one tree of ``[L, ...]``
    (dicts by key, tuples by position)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: stack_trees([t[k] for t in trees]) for k in sorted(first)}
    if isinstance(first, (tuple, list)):
        return type(first)(stack_trees([t[i] for t in trees])
                           for i in range(len(first)))
    return torch.stack(list(trees))


def scan_layers(body: Callable, carry, xs: Sequence):
    """``carry, y_l = body(carry, xs[l])`` for each layer in order.  Returns
    ``(carry, ys)`` with the per-layer outputs stacked on a leading axis,
    or ``None`` when ``body`` returns none."""
    ys = []
    for x in xs:
        carry, y = body(carry, x)
        ys.append(y)
    if not ys or ys[0] is None:
        return carry, None
    with span("repro.cache.stack"):
        return carry, stack_trees(ys)


# --------------------------------------------------------------------------- #
# activation checkpointing
# --------------------------------------------------------------------------- #
REMATS = ("none", "dots", "full")
_aten = torch.ops.aten


def _save_dots(ctx, op, *args, **kwargs):
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: keep
    the products without a batch dimension -- a projection ``bsd,de`` runs
    as ``mm`` or as ``bmm`` over one batch -- and recompute the rest
    (attention scores and the experts' grouped products have batch dims)."""
    if op in (_aten.mm.default, _aten.addmm.default) or (
            op is _aten.bmm.default and args[0].shape[0] == 1):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _dots_context():
    return create_selective_checkpoint_contexts(_save_dots)


def checkpointed(fn: Callable, remat: str) -> Callable:
    """``fn`` under the activation-checkpointing policy ``remat``:
    ``"none"`` keeps every activation for the backward pass, ``"full"``
    keeps only ``fn``'s inputs and recomputes the rest, ``"dots"`` also
    keeps the matrix products without batch dims.  Memory changes, values
    never do."""
    if remat not in REMATS:
        raise ValueError(f"remat must be one of {REMATS}, got {remat!r}")
    if remat == "none":
        return fn
    kw = {"context_fn": _dots_context} if remat == "dots" else {}
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


# --------------------------------------------------------------------------- #
# layers
# --------------------------------------------------------------------------- #
def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5,
             impl: str = "xla", groups: int = 1) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last axis (over
    each of its ``groups`` equal parts, where that is more than one), with
    float32 statistics and the output in ``x``'s dtype.  ``impl="xla"`` is
    the eager composite ``kref.rmsnorm_ref`` (differentiable); a kernel
    lowering (``"flash"``, ``"pallas"``) is the hand-written ``rmsnorm``
    kernel through ``ops.rmsnorm``: one launch a norm on the card, a
    ``DTensor``'s on each rank's rows, and a refusal under autograd."""
    with span("repro.rms_norm"):
        if impl != "xla":
            return kops.rmsnorm(x, weight, eps, groups)
        if groups == 1:
            return kref.rmsnorm_ref(x, weight, eps)
        d = x.shape[-1]
        return kref.rmsnorm_ref(
            x.reshape(*x.shape[:-1], groups, d // groups),
            weight.reshape(groups, d // groups), eps).reshape(x.shape)


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    idx = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
    return 1.0 / (theta ** (idx / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: [..., S, H, hd]; positions: broadcastable to [..., S]."""
    with span("repro.rope"):
        hd = x.shape[-1]
        freqs = rope_freqs(hd, theta, device=x.device)      # [hd/2]
        angles = positions[..., :, None].float() * freqs    # [..., S, hd/2]
        cos = torch.cos(angles)[..., :, None, :]        # [..., S, 1, hd/2]
        sin = torch.sin(angles)[..., :, None, :]
        x1, x2 = torch.chunk(x.float(), 2, dim=-1)
        out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
        return out.to(x.dtype)


@functools.lru_cache(maxsize=8)
def _sinusoid_table(length: int, d_model: int) -> np.ndarray:
    pos = np.arange(length)[:, None]
    dim = np.arange(0, d_model, 2)[None, :]
    angle = pos / np.power(10000.0, dim / d_model)
    out = np.zeros((length, d_model), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    out.flags.writeable = False
    return out


def sinusoidal_positions(length: int, d_model: int,
                         device=None) -> torch.Tensor:
    """``[length, d_model]`` float32 sine / cosine positions, computed in
    numpy float32 as the reference computes them (and cached: decode reads
    one row a step)."""
    return torch.tensor(_sinusoid_table(length, d_model), device=device)


def sinusoidal_position(length: int, d_model: int, pos: int,
                        device=None) -> torch.Tensor:
    """Row ``pos`` of :func:`sinusoidal_positions` as ``[1, d_model]``."""
    return torch.tensor(_sinusoid_table(length, d_model)[pos:pos + 1],
                        device=device)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    with span("repro.mlp"):
        g = mesh_einsum("...d,df->...f", x, w_gate)
        u = mesh_einsum("...d,df->...f", x, w_up)
        with span("repro.mlp.gate"):
            a = F.silu(g) * u
        return mesh_einsum("...f,fd->...d", a, w_down)


def mlp_defs(d_model: int, d_ff: int) -> Dict[str, ParamDef]:
    return {
        "gate": ParamDef((d_model, d_ff), ("d_model", "d_ff")),
        "up": ParamDef((d_model, d_ff), ("d_model", "d_ff")),
        "down": ParamDef((d_ff, d_model), ("d_ff", "d_model")),
    }


BATCH_MESH_DIMS = ("pod", "data")

_scope = threading.local()


@contextlib.contextmanager
def mesh_scope():
    """Plain tensors that meet ``DTensor``s (positions, masks, iotas made
    inside the model, and what autograd saved of them) taken as replicated;
    nothing changes for plain inputs.  Nests (``implicit_replication``
    alone clears its flag on the inner exit)."""
    depth = getattr(_scope, "depth", 0)
    _scope.depth = depth + 1
    try:
        if depth:
            yield
        else:
            with implicit_replication():
                yield
    finally:
        _scope.depth = depth



def batch_extent(mesh) -> int:
    """The ranks a batch is split over: the ``(pod, data)`` dims' sizes."""
    return math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                     if n in BATCH_MESH_DIMS)


def model_extent(mesh) -> int:
    names = mesh.mesh_dim_names
    return mesh.size(names.index("model")) if "model" in names else 1


def layout(mesh, batch, model=Replicate()) -> List:
    """One placement per mesh dim: ``batch`` on the ``(pod, data)`` dims,
    ``model`` on ``model``, replicated on any other."""
    return [batch if n in BATCH_MESH_DIMS else model if n == "model" else
            Replicate() for n in mesh.mesh_dim_names]


def placed_on(t: DTensor, mesh_dim: str):
    """``t``'s placement on the mesh dim named ``mesh_dim`` (None where the
    mesh has no such dim)."""
    return dict(zip(t.device_mesh.mesh_dim_names, t.placements)).get(
        mesh_dim)


def shard_as(x: torch.Tensor, batch: Optional[int] = 0,
             model: Optional[int] = None) -> torch.Tensor:
    """A ``DTensor`` redistributed to dim ``batch`` sharded over ``(pod,
    data)``, dim ``model`` over ``model`` and replicated otherwise (a dim
    its mesh dims do not divide stays replicated).  The identity on a
    plain tensor."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    split_b = batch is not None and x.shape[batch] % batch_extent(mesh) == 0
    split_m = model is not None and x.shape[model] % model_extent(mesh) == 0
    want = tuple(layout(mesh, Shard(batch) if split_b else Replicate(),
                        Shard(model) if split_m else Replicate()))
    return x if x.placements == want else x.redistribute(mesh, want)


def mesh_einsum(eq: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (batch first) and
    a weight ``w``.  On ``DTensor``s it is laid out as GSPMD lays out such a
    product under the FSDP + tensor-parallel rules: ``w`` gathered over
    ``(pod, data)`` and kept sharded over ``model`` on its one sharded dim
    (letter ``m``), ``x`` batch-sharded and sharded on ``m`` where it has
    it, the local einsum run on each rank's pieces, and the result
    batch-sharded and sharded on ``m`` (or ``Partial`` over ``model`` where
    ``m`` was contracted).  Left to itself, DTensor's propagation may shard
    a flattened ``heads × head_dim`` dim that the following view cannot
    split (14 heads over 16 shards).  Plain tensors take ``torch.einsum``
    as they are."""
    if not isinstance(x, DTensor) and not isinstance(w, DTensor):
        return torch.einsum(eq, x, w)
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    if "..." in xs:
        fill = "ABCDEFGH"[:x.dim() - len(xs) + 3]
        xs, out = xs.replace("...", fill), out.replace("...", fill)
    mesh = w.device_mesh
    on_w = placed_on(w, "model")
    m = ws[on_w.dim] if isinstance(on_w, Shard) else None
    split = x.shape[0] % batch_extent(mesh) == 0
    batch = Shard(0) if split else Replicate()

    def on(sub, otherwise):
        return Shard(sub.index(m)) if m and m in sub else otherwise

    rep = Replicate()
    contracted = Partial() if m else rep
    xl = x.redistribute(mesh, layout(mesh, batch, on(xs, rep))).to_local(
        grad_placements=layout(mesh, batch, on(xs, contracted)))
    wl = w.redistribute(mesh, layout(mesh, rep, on(ws, rep))).to_local(
        grad_placements=layout(mesh, Partial() if split else rep,
                               on(ws, rep)))
    return DTensor.from_local(torch.einsum(f"{xs},{ws}->{out}", xl, wl),
                              mesh, layout(mesh, batch, on(out, contracted)),
                              run_check=False)


def embed_lookup(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """Rows ``tokens`` of an embedding ``table [V, D]``.  On a device mesh
    vocab-parallel: the table gathered over ``(pod, data)`` and kept
    sharded over ``model`` on the vocabulary, each rank reading the rows it
    holds (zeros elsewhere), the result ``Partial`` over ``model``.
    DTensor's own index and its backward (an ``index_put``) have no rule for
    a sharded table in every release."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    tokens = shard_as(tokens, 0)
    batch = placed_on(tokens, "data") or Replicate()
    on_model = placed_on(table, "model")
    split = isinstance(on_model, Shard)
    rep = Replicate()
    local = table.redistribute(mesh, layout(mesh, rep, on_model or rep)) \
        .to_local(grad_placements=layout(
            mesh, Partial() if isinstance(batch, Shard) else rep,
            on_model or rep))
    ids = tokens.to_local().long()
    if split:
        ids = ids - mesh.get_local_rank("model") * local.shape[0]
        mine = (ids >= 0) & (ids < local.shape[0])
        rows = local[ids.clamp(0, local.shape[0] - 1)] * mine[..., None]
    else:
        rows = local[ids]
    return DTensor.from_local(rows, mesh,
                              layout(mesh, batch, Partial() if split else rep),
                              run_check=False)


def _nll_on_shards(logits: DTensor, labels: torch.Tensor) -> DTensor:
    """Per-token negative log-likelihood of batch- and vocab-sharded
    logits, vocab-parallel: each rank's log-sum-exp over its columns (the
    row maximum and the sum of exponentials reduced over ``model``) and the
    gold logit by the reference's iota-compare select and sum over its
    columns (``Partial`` over ``model``).  DTensor's own log-sum-exp and
    gather collect ``[B, S, V]`` whole."""
    vdim = logits.dim() - 1
    logits, labels = shard_as(logits, 0, vdim), shard_as(labels, 0)
    mesh = logits.device_mesh
    split = isinstance(placed_on(logits, "model"), Shard)
    batch = placed_on(logits, "data") or Replicate()

    def wrap(t, reduce_op):
        return DTensor.from_local(t, mesh, layout(
            mesh, batch, Partial(reduce_op) if split else Replicate()),
            run_check=False)
    ll = logits.to_local().float()
    v0 = mesh.get_local_rank("model") * ll.shape[-1] if split else 0
    whole = layout(mesh, batch)
    m = wrap(ll.detach().amax(dim=-1), "max").redistribute(mesh, whole) \
        .to_local()
    sumexp = wrap(torch.exp(ll - m[..., None]).sum(dim=-1), "sum") \
        .redistribute(mesh, whole)
    iota = v0 + torch.arange(ll.shape[-1], device=ll.device)
    gold = wrap(torch.sum(torch.where(
        labels.to_local().long()[..., None] == iota, ll, 0.0), dim=-1), "sum")
    m = DTensor.from_local(m, mesh, whole, run_check=False)
    return torch.log(sumexp) + m - gold


def shard_batch(x: torch.Tensor) -> torch.Tensor:
    """A ``[B, ...]`` activation sharded on batch over ``(pod, data)`` and
    replicated on every other mesh dim: the reference's
    ``with_sharding_constraint`` at layer boundaries, as a redistribution
    of a ``DTensor``.  The identity on a plain tensor."""
    return shard_as(x, 0)


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token negative log-likelihood in float32.  logits [..., V],
    labels [...] (integer).  The gold logit is read by ``gather`` from a
    plain tensor; on a device mesh see :func:`_nll_on_shards`."""
    if isinstance(logits, DTensor):
        nll = _nll_on_shards(logits, labels)
    else:
        logits = logits.float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = logits.gather(-1, labels.long()[..., None])[..., 0]
        nll = logz - gold
    if mask is not None:
        mask = mask.float()
        return torch.sum(nll * mask) / torch.sum(mask).clamp_min(1.0)
    return torch.mean(nll)
