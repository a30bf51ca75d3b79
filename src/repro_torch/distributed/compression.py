"""Int8 gradient compression with error feedback (distributed-optimization
trick for bandwidth-bound data parallelism).

Twin of the reference's ``distributed/compression.py``.  Per-tensor
symmetric int8 quantization with an error-feedback accumulator (Seide et
al. / 1-bit SGD lineage): the quantization residual is carried into the
next step so the compression is unbiased over time.  The quantize ->
dequantize pair models the 8-bit wire format's numerics; on one device
there is no all-reduce between them.  ``q`` and ``scale`` are the
reference's bit for bit on the same float32 input: the scale is
``max(amax, 1e-12) / 127`` in float32 and ``torch.round``, like
``jnp.round``, rounds half to even.

"Per tensor" means per tensor of the reference's *stacked* tree: the L
per-layer pieces of a stacked leaf (``models.common.STACKED``, lists here)
share one scale, the largest magnitude over all of them, as the reference's
``[L, ...]`` tensor has.  Quantizing each piece on its own would give every
layer its own scale and another trajectory.  On a device mesh the scale
is the largest magnitude of the global tensor, whatever its shards.
"""
from __future__ import annotations

from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from repro_torch.distributed.placement import to_plain
from repro_torch.models.common import tree_leaves, tree_map, tree_unflatten

Tree = Any


class CompressionState(NamedTuple):
    error: Tree      # error-feedback accumulators, same structure as grads


def init_state(grads_like: Tree) -> CompressionState:
    """Zero accumulators shaped (and placed) like ``grads_like``."""
    return CompressionState(error=tree_map(
        lambda g: torch.zeros_like(g, dtype=torch.float32,
                                   memory_format=torch.contiguous_format),
        grads_like))


def compress_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8: returns (q int8, scale float32 scalar)."""
    (q,), scale = compress_int8_pieces([x])
    return q, scale


def compress_int8_pieces(xs: Sequence[torch.Tensor]
                         ) -> Tuple[List[torch.Tensor], torch.Tensor]:
    """:func:`compress_int8` of the tensor the pieces ``xs`` stack into
    (one scale for all), without stacking them."""
    amax = torch.stack([to_plain(torch.max(torch.abs(x)))
                        for x in xs]).max().float()
    scale = torch.clamp_min(amax, 1e-12) / 127.0
    return [torch.clamp(torch.round(x.float() / scale), -127, 127).to(
        torch.int8) for x in xs], scale


def decompress_int8(q: torch.Tensor, scale: torch.Tensor,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def _stacked_paths(tree: Tree, path: str = "") -> List[str]:
    """Per leaf (``tree_leaves`` order), its path in the reference's stacked
    tree: the pieces of a per-layer list share one path."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _stacked_paths(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [p for t in tree for p in _stacked_paths(t, path)]
    return [path]


@torch.no_grad()
def compressed_gradients(grads: Tree, state: CompressionState
                         ) -> Tuple[Tree, CompressionState]:
    """Apply error-feedback int8 compression to a gradient tree, one scale
    per tensor of the reference's stacked tree."""
    gs, es = tree_leaves(grads), tree_leaves(state.error)
    groups = {}
    for i, path in enumerate(_stacked_paths(grads)):
        groups.setdefault(path, []).append(i)
    new_g: List = [None] * len(gs)
    new_e: List = [None] * len(gs)
    for idx in groups.values():
        g32 = [gs[i].float() + es[i] for i in idx]
        qs, scale = compress_int8_pieces(g32)
        for i, x, q in zip(idx, g32, qs):
            deq = decompress_int8(q, scale)
            new_g[i], new_e[i] = deq.to(gs[i].dtype), x - deq
    return (tree_unflatten(grads, new_g),
            CompressionState(error=tree_unflatten(grads, new_e)))
