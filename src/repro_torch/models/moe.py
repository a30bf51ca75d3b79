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
``moe_forward`` also returns the Switch load-balancing loss.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig, MoEConfig
from repro_torch.models.common import ParamDef, swiglu


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
            "aux": aux}


def moe_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> (y [B,S,D], aux loss, a float32 scalar)."""
    m = cfg.moe
    B, S, D = x.shape
    K = m.top_k
    r = route(p, x, cfg)
    slot_tok, slot_fill = r["slot_tok"], r["slot_fill"]
    C = slot_tok.shape[2]

    # gather the slotted tokens, run every expert on its slots
    xg = x[torch.arange(B, device=x.device)[:, None, None], slot_tok]
    xg = xg * slot_fill[..., None]                          # [B,E,C,D]
    h_g = torch.einsum("becd,edf->becf", xg, p["w_gate"])
    h_u = torch.einsum("becd,edf->becf", xg, p["w_up"])
    yg = torch.einsum("becf,efd->becd", F.silu(h_g) * h_u, p["w_down"])

    # combine: assignment (b, s, k) reads its slot, weighted by its gate
    flat_e = r["experts"].reshape(B, S * K)
    flat_p = torch.where(r["valid"], r["pos"], C).reshape(B, S * K)
    b_idx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    ye = yg[b_idx, flat_e, flat_p.clamp(0, C - 1)].reshape(B, S, K, D)
    w = (r["gates"] * r["valid"].float()).to(x.dtype)
    y = torch.einsum("bskd,bsk->bsd", ye, w)
    if m.num_shared_experts:
        y = y + swiglu(x, p["shared_gate"], p["shared_up"], p["shared_down"])
    return y, r["aux"]
