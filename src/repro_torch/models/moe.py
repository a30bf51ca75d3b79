"""Mixture-of-Experts: top-k router and capacity-based gather / scatter.

Twin of the reference's ``models/moe.py``.  Per batch row, each token's
top-k experts (descending gate, the lower expert index first on ties, as
``jax.lax.top_k`` orders them) are given slots in a per-expert table of
capacity ``C``; slots are assigned k-major (every token's first choice
before any second choice), so which assignments overflow ``C`` and are
dropped is deterministic and the reference's.  The table is filled with one
``index_put_`` (overflow goes to a drop bucket ``C`` that is cut off), the
slotted tokens run through the experts as one grouped einsum
``[B,E,C,D] x [E,D,F]``, and each token combines its experts' outputs with
its renormalised gates.  Shared experts are a plain SwiGLU on every token.
``moe_forward`` also returns the Switch load-balancing loss.  On a device
mesh the routed experts run expert-parallel on each rank's shards
(:func:`_moe_on_shards`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import (ParamDef, batch_extent, layout,
                                       model_extent, placed_on, swiglu)


def moe_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    m = cfg.moe
    D = cfg.d_model
    E, Fe = m.num_experts, m.d_ff_expert
    defs = {
        "router": ParamDef((D, E), ("d_model", "experts"), init="small_normal"),
        "w_gate": ParamDef((E, D, Fe), ("experts", "d_model", "d_ff")),
        "w_up": ParamDef((E, D, Fe), ("experts", "d_model", "d_ff")),
        "w_down": ParamDef((E, Fe, D), ("experts", "d_ff", "d_model")),
    }
    if m.num_shared_experts:
        Fs = (m.d_ff_shared or m.d_ff_expert) * m.num_shared_experts
        defs["shared_gate"] = ParamDef((D, Fs), ("d_model", "d_ff"))
        defs["shared_up"] = ParamDef((D, Fs), ("d_model", "d_ff"))
        defs["shared_down"] = ParamDef((Fs, D), ("d_ff", "d_model"))
    return defs


def capacity_for(m: MoEConfig, seq_len: int) -> int:
    """Slots per expert and batch row: ``ceil(S k / E * factor)``, rounded
    up to a multiple of 8, at least 8."""
    c = int(math.ceil(seq_len * m.top_k / m.num_experts * m.capacity_factor))
    return max(8, -(-c // 8) * 8)


def top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest of the last axis, descending, equal values in
    ascending index order (``jax.lax.top_k``'s order; ``torch.topk`` does
    not promise one for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _router_stats(probs: torch.Tensor, experts: torch.Tensor, E: int):
    """Per expert: the summed router probability and the count of tokens
    whose first choice it is (the load-balancing loss's two means, times
    the token count)."""
    return (probs.sum(dim=(0, 1)),
            F.one_hot(experts[..., 0], E).float().sum(dim=(0, 1)))


def route(p: Dict, x: torch.Tensor, cfg: ArchConfig) -> Dict[str, torch.Tensor]:
    """The router's decisions for ``x [B,S,D]``: ``gates`` (renormalised)
    and ``experts`` ``[B,S,K]``, each assignment's slot ``pos`` and whether
    it fits (``valid``, ``pos < C``), the slot table ``slot_tok [B,E,C]``
    (the token in each slot, 0 where empty) with ``slot_fill`` (1 where
    filled, in x's dtype), and the aux loss."""
    m = cfg.moe
    B, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    C = capacity_for(m, S)
    dev = x.device

    logits = torch.einsum("bsd,de->bse", x, p["router"]).float()
    probs = torch.softmax(logits, dim=-1)
    gates, experts = top_k(probs, K)                        # [B,S,K]
    gates = gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)

    me = probs.mean(dim=(0, 1))                             # [E]
    ce = F.one_hot(experts[..., 0], E).float().mean(dim=(0, 1))
    aux = m.router_aux_coef * E * torch.sum(me * ce)
    stats = _router_stats(probs, experts, E)

    # position in expert, k-major: all first choices, then all second ...
    carry = torch.zeros((B, E), dtype=torch.long, device=dev)
    pos = []
    for k in range(K):
        oh = F.one_hot(experts[:, :, k], E)                 # [B,S,E]
        before = torch.cumsum(oh, dim=1) - oh + carry[:, None, :]
        pos.append((before * oh).sum(-1))                   # [B,S]
        carry = carry + oh.sum(1)
    pos = torch.stack(pos, dim=-1)                          # [B,S,K]
    valid = pos < C

    # token index into its (expert, slot); bucket C takes the drops
    b_idx = torch.arange(B, device=dev)[:, None].expand(B, S * K)
    flat_e = experts.reshape(B, S * K)
    flat_p = torch.where(valid, pos, C).reshape(B, S * K)
    flat_t = torch.arange(S, device=dev)[None, :, None].expand(B, S, K) \
        .reshape(B, S * K)
    slot_tok = torch.zeros((B, E, C + 1), dtype=torch.long, device=dev)
    slot_tok.index_put_((b_idx, flat_e, flat_p), flat_t)
    slot_fill = torch.zeros((B, E, C + 1), dtype=x.dtype, device=dev)
    slot_fill.index_put_((b_idx, flat_e, flat_p),
                         torch.ones((), dtype=x.dtype, device=dev))
    return {"gates": gates, "experts": experts, "pos": pos, "valid": valid,
            "slot_tok": slot_tok[:, :, :C], "slot_fill": slot_fill[:, :, :C],
            "aux": aux, "stats": stats}


def _routed(p: Dict, x: torch.Tensor, cfg: ArchConfig, e0: int = 0,
            e1: Optional[int] = None):
    """The routed experts' output for ``x [B,S,D]`` from the experts
    ``[e0, e1)`` whose weights ``p`` holds (all of them by default; an
    assignment to another expert adds nothing), with ``route``'s dict."""
    B, S, D = x.shape
    K = cfg.moe.top_k
    E = cfg.moe.num_experts
    e1 = E if e1 is None else e1
    r = route(p, x, cfg)
    slot_tok = r["slot_tok"][:, e0:e1]
    slot_fill = r["slot_fill"][:, e0:e1]
    C = slot_tok.shape[2]

    # gather the slotted tokens, run every expert on its slots
    xg = x[torch.arange(B, device=x.device)[:, None, None], slot_tok]
    xg = xg * slot_fill[..., None]                          # [B,E,C,D]
    h_g = torch.einsum("becd,edf->becf", xg, p["w_gate"])
    h_u = torch.einsum("becd,edf->becf", xg, p["w_up"])
    yg = torch.einsum("becf,efd->becd", F.silu(h_g) * h_u, p["w_down"])

    # combine: assignment (b, s, k) reads its slot, weighted by its gate
    local_e = r["experts"] - e0
    flat_e = local_e.clamp(0, e1 - e0 - 1).reshape(B, S * K)
    flat_p = torch.where(r["valid"], r["pos"], C).reshape(B, S * K)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    ye = yg[b_idx, flat_e, flat_p.clamp(0, C - 1)].reshape(B, S, K, D)
    w = r["gates"] * r["valid"].float()
    if (e0, e1) != (0, E):
        w = w * ((local_e >= 0) & (local_e < e1 - e0)).float()
    y = torch.einsum("bskd,bsk->bsd", ye, w.to(x.dtype))
    return y, r


def moe_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux loss, a float32 scalar)."""
    m = cfg.moe
    if isinstance(x, DTensor):
        y, aux = _moe_on_shards(p, x, cfg)
    else:
        y, r = _routed(p, x, cfg)
        aux = r["aux"]
    if m.num_shared_experts:
        y = y + swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y, aux


def _moe_on_shards(p: Dict, x: DTensor, cfg: ArchConfig):
    """The routed experts on a device mesh, as expert parallelism lays them
    out: each rank routes its batch rows (the router gathered whole) and
    runs its own experts (the expert stacks sharded over ``model``,
    gathered over ``(pod, data)``); its output, summed over ``model``, is a
    ``Partial``.  The load-balancing loss is taken from the global batch's
    two means, counted once over ``model``.  With the experts not split
    over ``model``, every rank runs them all.  Left to DTensor, the
    routing's scatter (``index_put_``) has no sharding rule."""
    m = cfg.moe
    E = m.num_experts
    mesh = x.device_mesh
    on_w = placed_on(p["w_gate"], "model")
    split = isinstance(on_w, Shard) and on_w.dim == 0
    n = model_extent(mesh) if split else 1
    e0 = (mesh.get_local_rank("model") if split else 0) * (E // n)
    rows = x.shape[0] % batch_extent(mesh) == 0
    rep, part = Replicate(), Partial()
    b_in = Shard(0) if rows else rep
    b_grad = part if rows else rep
    m_part = part if split else rep
    e_pl = Shard(0) if split else rep

    def local(t, pl, grad):
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)
    xl = local(x, layout(mesh, b_in), layout(mesh, b_in, m_part))
    weights = {"router": local(p["router"], layout(mesh, rep),
                               layout(mesh, b_grad, m_part))}
    for k in ("w_gate", "w_up", "w_down"):
        weights[k] = local(p[k], layout(mesh, rep, e_pl),
                           layout(mesh, b_grad, e_pl))
    y, r = _routed(weights, xl, cfg, e0, e0 + E // n)
    # the loss's sums: rank 0 of "model" alone holds them where the experts
    # are split, so that their sum over "model" counts them once
    tokens = x.shape[0] * x.shape[1]
    me, ce = (DTensor.from_local(t if e0 == 0 else t * 0.0, mesh,
                                 layout(mesh, b_grad, m_part),
                                 run_check=False) / tokens
              for t in r["stats"])
    aux = m.router_aux_coef * E * torch.sum(me * ce)
    return (DTensor.from_local(y, mesh, layout(mesh, b_in, m_part),
                               run_check=False), aux)
