"""Weights and prompts made by the benchmark from the run's seed.

Every weight is drawn in one call on the device, in the served dtype, and
the leaves are views into that buffer, laid out as the program declares its
parameters (``Model.param_defs()``; the subtrees the program stacks,
``common.STACKED``, split into per-layer dicts).  Each leaf is then scaled
in place by what its declaration says of it (``ParamDef.init`` and its
logical axes), so that random weights give a model in the regime of a
trained one:

* ``ones`` (norm gains, ``D_skip``): 1 + 0.1 N(0, 1);
* ``zeros`` (biases): 0.1 N(0, 1);
* an embedding table (first axis ``vocab``): std 1, like the patch
  embeddings beside it;
* every other leaf (``normal`` and ``small_normal``: products, the
  depthwise convolution, routers): std 1 / sqrt(fan-in), the fan-in being
  the dims a product contracts: those before the first head axis where one
  follows the first dim (``wq [D, heads, hd]``: D), else all but the last
  (``wo [heads, hd, D]``: heads * hd; ``conv_x [d_conv, d_inner]``:
  d_conv), a leading ``experts`` axis left out; so attention scores and
  every layer's output are O(1) with no temper;
* Mamba2's ``A_log`` = log U(1, 16) and ``dt_bias`` = softplus⁻¹ of a
  log-uniform dt in [1e-3, 1e-1] (arXiv:2405.21060's initialisation), so
  that states decay over tens to thousands of positions and the scan's
  state passing carries weight in every output.

The same tensors go to the program and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

HEAD_AXES = ("heads", "kv_heads")


def _leaves(defs: Any, path: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    if isinstance(defs, dict):
        out = []
        for k in sorted(defs):
            out += _leaves(defs[k], path + (k,))
        return out
    return [(path, defs)]


def fan_in(shape: Tuple[int, ...], axes: Tuple) -> int:
    """The dims a product with this weight contracts (see the module
    docstring)."""
    if axes and axes[0] == "experts":
        shape, axes = shape[1:], axes[1:]
    out = next((i for i, a in enumerate(axes) if i > 0 and a in HEAD_AXES),
               len(axes) - 1)
    return max(math.prod(shape[:out]), 1)


def _fill(name: str, d, t: torch.Tensor, layered: bool) -> None:
    """Scale the standard normal ``t`` in place into the distribution of
    leaf ``name`` declared as ``d`` (``layered``: ``t`` has a leading layer
    dim that ``d`` declares too)."""
    shape, axes = (d.shape[1:], d.axes[1:]) if layered else (d.shape, d.axes)
    if name in ("A_log", "dt_bias"):
        u = 0.5 * (1.0 + torch.erf(t.float() / math.sqrt(2.0)))
        if name == "A_log":
            v = torch.log1p(15.0 * u)
        else:
            dt = torch.exp(math.log(1e-3) + u * math.log(100.0))
            v = dt + torch.log(-torch.expm1(-dt))
        t.copy_(v.to(t.dtype))
    elif d.init == "ones":
        t.mul_(0.1).add_(1.0)
    elif d.init == "zeros":
        t.mul_(0.1)
    elif d.init in ("normal", "small_normal"):
        if axes[0] != "vocab":
            t.mul_(1.0 / math.sqrt(fan_in(shape, axes)))
    else:
        raise KeyError(f"no distribution for parameter {name!r} declared "
                       f"with init {d.init!r}")


def make_params(defs: Dict, seed: int, dtype: torch.dtype,
                device: torch.device) -> Dict:
    """The parameter tree of ``defs`` (the program's declaration) drawn
    from ``seed`` on ``device`` in ``dtype``, stacked subtrees split into
    lists of per-layer dicts of views."""
    from repro_torch.models.common import STACKED
    leaves = _leaves(defs)
    total = sum(math.prod(d.shape) for _, d in leaves)
    gen = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(total, generator=gen, dtype=dtype, device=device)
    tree: Dict = {}
    off = 0
    for path, d in leaves:
        n = math.prod(d.shape)
        t = flat[off:off + n].view(d.shape)
        off += n
        _fill(path[-1], d, t, path[0] in STACKED)
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = t
    return {k: _split(v) if k in STACKED else v for k, v in tree.items()}


def _split(stacked: Dict) -> List[Dict]:
    depth = next(iter(_leaves(stacked)))[1].shape[0]
    return [_index(stacked, i) for i in range(depth)]


def _index(tree: Any, i: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def make_batch(gen: torch.Generator, rows: int, tokens: int, prefix: int,
               vocab: int, width: int, dtype: torch.dtype,
               device: torch.device) -> Dict[str, torch.Tensor]:
    """One call's prompts: ``tokens`` text tokens a row, uniform over the
    vocabulary, after ``prefix`` patch embeddings (standard normal, the
    vision tower's output in the model's width) where ``prefix`` > 0."""
    batch = {"tokens": torch.randint(0, vocab, (rows, tokens), generator=gen,
                                     device=device)}
    if prefix:
        batch["patch_embeds"] = torch.randn((rows, prefix, width),
                                            generator=gen, dtype=dtype,
                                            device=device)
    return batch
