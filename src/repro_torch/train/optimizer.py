"""AdamW, global-norm clipping and the cosine schedule, in float32.

Twin of the reference's ``train/optimizer.py``, in its order of operations;
every function works leaf by leaf over a parameter tree (dicts and per-layer
lists, ``models.common.tree_map``) and returns new tensors.  Moments and
arithmetic are float32; parameters are cast back to their own dtype (bf16
for the full configs).

Weight decay follows the reference's *stacked* rank: it decays a leaf of
rank >= 2 in the reference's layout, where every per-layer leaf carries a
leading ``[L]`` axis, so per-layer norms and Mamba2's ``A_log`` /
``D_skip`` / ``dt_bias`` are decayed.  Here those leaves are 1-D pieces of
per-layer lists, so the caller passes ``decay`` (``Model.decay_mask()``);
without it a leaf of rank >= 2 is decayed, the literal rule, right only for
a tree with no stacked subtree.

On a device mesh the leaves are ``DTensor``s: the update is elementwise
and keeps each leaf's placement, and the global norm reduces over the
global tensors.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

Tree = Any


class AdamWState(NamedTuple):
    step: torch.Tensor     # int32 scalar
    m: Tree
    v: Tree


def adamw_init(params: Tree) -> AdamWState:
    """Zero moments shaped (and, for ``DTensor`` parameters, placed) like
    the parameters; ``step`` a plain scalar."""
    zeros = lambda p: torch.zeros_like(
        p, dtype=torch.float32, memory_format=torch.contiguous_format)
    device = tree_leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_sum(terms) -> torch.Tensor:
    """The sum of scalars, plain or ``DTensor`` (``Partial`` over the mesh
    dims their tensor was sharded on), as a plain scalar: the
    ``DTensor`` terms of one placement are reduced by one collective."""
    plain = [t for t in terms if not isinstance(t, DTensor)]
    groups = {}
    for t in terms:
        if isinstance(t, DTensor):
            groups.setdefault((t.device_mesh, t.placements), []).append(
                t.to_local())
    total = sum(plain)
    for (mesh, placements), local in groups.items():
        total = total + DTensor.from_local(
            torch.stack(local), mesh, placements,
            run_check=False).full_tensor().sum()
    return total


def global_norm(tree: Tree) -> torch.Tensor:
    """The L2 norm over every leaf, the global tensors' where leaves are
    ``DTensor``s (a plain scalar either way)."""
    return torch.sqrt(global_sum([torch.sum(torch.square(x.float()))
                                  for x in tree_leaves(tree)]))


def clip_by_global_norm(grads: Tree, max_norm: float
                        ) -> Tuple[Tree, torch.Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(norm, 1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


@torch.no_grad()
def adamw_update(params: Tree, grads: Tree, state: AdamWState, *,
                 lr: torch.Tensor, b1: float = 0.9, b2: float = 0.95,
                 eps: float = 1e-8, weight_decay: float = 0.1,
                 decay: Optional[Tree] = None) -> Tuple[Tree, AdamWState]:
    """One AdamW step; ``decay`` is a tree of bools beside ``params`` (see
    the module docstring)."""
    step = state.step + 1
    t = step.float()
    bc1 = 1 - b1 ** t            # the reference's m / (1 - b1 ** t)
    bc2 = 1 - b2 ** t
    if decay is None:
        decay = tree_map(lambda p: p.dim() >= 2, params)

    def upd(p, g, m, v, dec):
        g32 = g.float()
        m = b1 * m + (1 - b1) * g32
        v = b2 * v + (1 - b2) * g32 * g32
        mh = m / bc1
        vh = v / bc2
        delta = mh / (torch.sqrt(vh) + eps)
        if dec:
            delta = delta + weight_decay * p.float()
        return (p.float() - lr * delta).to(p.dtype), m, v

    out = [upd(*leaves) for leaves in zip(
        *(tree_leaves(t) for t in (params, grads, state.m, state.v, decay)))]
    new_p, new_m, new_v = (tree_unflatten(params, [o[i] for o in out])
                           for i in range(3))
    return new_p, AdamWState(step=step, m=new_m, v=new_v)


def cosine_schedule(step: torch.Tensor, *, peak_lr: float, warmup: int,
                    total: int, floor_frac: float = 0.1) -> torch.Tensor:
    t = step.float()
    warm = peak_lr * t / max(warmup, 1)
    frac = torch.clamp((t - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = peak_lr * (floor_frac + (1 - floor_frac)
                     * 0.5 * (1 + torch.cos(math.pi * frac)))
    return torch.where(t < warmup, warm, cos)
