"""Decoder-only LM stack: dense GQA, MLA, MoE and VLM-backbone variants.

Twin of the reference's ``models/transformer.py``.  Layer parameters are
lists of per-layer dicts and the stack runs as a Python loop
(``common.scan_layers``).  A MoE config with leading dense layers keeps the
reference's two groups, ``dense_layers`` (SwiGLU) then ``layers`` (MoE), in
parameters and caches alike; caches keep the reference's stacked layout,
``{"layers": {"k", "v": [L, B, S, KV, hd]}}`` for GQA and ``{"c_kv": [L, B,
S, r], "k_rope": [L, B, S, rope]}`` for MLA.  A VLM prepends precomputed
patch embeddings (``batch["patch_embeds"]``) to the token embeddings.

``lm_loss`` is the training objective: next-token cross entropy over the
token positions (a VLM's patch prefix is cut before the logits), plus the
MoE load-balancing loss of every MoE layer, plus, where ``cfg.mtp``
(DeepSeek-V3), the multi-token-prediction head over the ``mtp`` subtree
(one more block predicts token t + 2, weighted 0.3, its aux loss added).
Each layer runs under ``common.checkpointed(..., remat)``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import (ParamDef, checkpointed,
                                       cross_entropy_loss, embed_lookup,
                                       mesh_einsum, mlp_defs, rms_norm,
                                       scan_layers, shard_batch, split_layers,
                                       stack_defs, swiglu)
from repro_torch.obs.spans import span

Tree = Any


# --------------------------------------------------------------------------- #
# parameter definitions
# --------------------------------------------------------------------------- #
def _attn_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    if cfg.mla is not None:
        return attn.mla_defs(cfg)
    return attn.gqa_defs(cfg)


def _layer_defs(cfg: ArchConfig, use_moe: bool, d_ff: int) -> Dict[str, Tree]:
    defs = {
        "ln1": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "attn": _attn_defs(cfg),
    }
    if use_moe:
        defs["moe"] = moe_mod.moe_defs(cfg)
    else:
        defs["mlp"] = mlp_defs(cfg.d_model, d_ff)
    return defs


def _groups(cfg: ArchConfig) -> List[Tuple[str, int, bool]]:
    """The layer groups in order: (name, depth, MoE?)."""
    m = cfg.moe
    if m is not None and m.first_dense_layers > 0:
        return [("dense_layers", m.first_dense_layers, False),
                ("layers", cfg.num_layers - m.first_dense_layers, True)]
    return [("layers", cfg.num_layers, m is not None)]


def lm_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    """The reference's tree; each layer group is stacked ``[L, ...]`` here
    (the model splits it into per-layer dicts once the tensors exist)."""
    V, D = cfg.padded_vocab, cfg.d_model
    defs: Dict[str, Tree] = {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("d_model", "vocab"))
    m = cfg.moe
    for name, depth, use_moe in _groups(cfg):
        d_ff = (m.d_ff_dense or cfg.d_ff) if name == "dense_layers" \
            else cfg.d_ff
        defs[name] = stack_defs(_layer_defs(cfg, use_moe, d_ff), depth)
    if cfg.mtp:
        defs["mtp"] = {
            "proj": ParamDef((2 * D, D), (None, "d_model")),
            "ln_h": ParamDef((D,), ("d_model",), init="ones"),
            "ln_e": ParamDef((D,), ("d_model",), init="ones"),
            "block": _layer_defs(cfg, m is not None, cfg.d_ff),
        }
    return defs


# --------------------------------------------------------------------------- #
# layer bodies
# --------------------------------------------------------------------------- #
def _ffn(h: torch.Tensor, lp: Dict, cfg: ArchConfig, impl: str):
    """``h`` + the layer's MLP or MoE; returns (output, MoE aux loss -- 0.0
    for a dense layer)."""
    x = rms_norm(h, lp["ln2"], cfg.norm_eps, impl)
    if "moe" in lp:
        f, aux = moe_mod.moe_forward(lp["moe"], x, cfg)
    else:
        f = swiglu(x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"])
        aux = 0.0
    return shard_batch(h + f), aux


def _block(h: torch.Tensor, lp: Dict, cfg: ArchConfig, impl: str):
    """One layer; returns (output, the layer's cache contents, aux loss).
    MLA always takes the einsum path, as in the reference."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps, impl)
    if cfg.mla is not None:
        a, kv = attn.mla_forward(lp["attn"], x, cfg, impl=impl)
    else:
        a, kv = attn.gqa_forward(lp["attn"], x, cfg, impl=impl)
    out, aux = _ffn(shard_batch(h + a), lp, cfg, impl)
    return out, kv, aux


def _layer_fwd(h: torch.Tensor, lp: Dict, cfg: ArchConfig,
               impl: str) -> Tuple[torch.Tensor, Dict]:
    """One layer; returns (output, the layer's cache contents)."""
    with span("repro.layer"):
        out, kv, _ = _block(h, lp, cfg, impl)
        return out, kv


def _layer_train(h: torch.Tensor, lp: Dict, cfg: ArchConfig, impl: str):
    """One layer for the loss; returns (output, aux loss)."""
    out, _, aux = _block(h, lp, cfg, impl)
    return out, aux


def _logits(params: Tree, h: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    with span("repro.logits"):
        h = rms_norm(h, params["final_norm"], cfg.norm_eps, impl)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        return mesh_einsum("bsd,dv->bsv", h, w)


def _embed_tokens(params: Tree, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    return embed_lookup(params["embed"], tokens).to(
        getattr(torch, cfg.compute_dtype))


def _embed_inputs(params: Tree, batch: Dict, cfg: ArchConfig) -> torch.Tensor:
    """Token embeddings; a VLM prepends the precomputed patch embeddings
    (the vision tower is a stub, as in the reference)."""
    with span("repro.embed"):
        h = _embed_tokens(params, batch["tokens"], cfg)
        if cfg.vlm is not None and "patch_embeds" in batch:
            h = torch.cat([batch["patch_embeds"].to(h.dtype), h], dim=1)
        return shard_batch(h)


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #
def lm_forward(params: Tree, batch: Dict, cfg: ArchConfig, *,
               impl: str = "xla") -> torch.Tensor:
    """Full-sequence logits ``[B, P + S, V]`` (``P`` patch positions of a
    VLM first)."""
    h = _embed_inputs(params, batch, cfg)
    for name, _, _ in _groups(cfg):
        for lp in params[name]:
            h, _ = _layer_fwd(h, lp, cfg, impl)
    return _logits(params, h, cfg, impl)


def lm_loss(params: Tree, batch: Dict, cfg: ArchConfig, *,
            impl: str = "xla", remat: str = "dots") -> torch.Tensor:
    """Next-token CE (+ MoE aux + the MTP head where configured)."""
    h = _embed_inputs(params, batch, cfg)
    layer = checkpointed(
        lambda c, lp: _layer_train(c, lp, cfg, impl), remat)
    aux = 0.0
    for name, _, _ in _groups(cfg):
        for lp in params[name]:
            h, a = layer(h, lp)
            aux = aux + a
    if cfg.vlm is not None and "patch_embeds" in batch:
        h = h[:, batch["patch_embeds"].shape[1]:]
    tokens = batch["tokens"]
    loss = cross_entropy_loss(_logits(params, h, cfg, impl)[:, :-1],
                              tokens[:, 1:])

    if cfg.mtp:
        # DeepSeek-V3 multi-token prediction: one extra block predicts t+2
        mp = params["mtp"]
        emb_next = _embed_tokens(params, tokens, cfg)
        h_in = torch.cat([rms_norm(h[:, :-1], mp["ln_h"], cfg.norm_eps,
                                   impl),
                          rms_norm(emb_next[:, 1:], mp["ln_e"], cfg.norm_eps,
                                   impl)], dim=-1)
        h_mtp = mesh_einsum("bsd,dk->bsk", h_in, mp["proj"])
        h_mtp, aux_mtp = _layer_train(h_mtp, mp["block"], cfg, impl)
        logits_mtp = _logits(params, h_mtp, cfg, impl)
        loss = loss + 0.3 * cross_entropy_loss(logits_mtp[:, :-1],
                                               tokens[:, 2:])
        aux = aux + aux_mtp
    return loss + aux


def lm_prefill(params: Tree, batch: Dict, cfg: ArchConfig, *,
               impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    """Process the full prompt; return (last-position logits, caches)."""
    h = _embed_inputs(params, batch, cfg)
    caches = {}
    for name, _, _ in _groups(cfg):
        h, caches[name] = scan_layers(
            lambda c, lp: _layer_fwd(c, lp, cfg, impl), h, params[name])
    return _logits(params, h[:, -1:, :], cfg, impl), caches


def _decode_layer(h, lp, cache, pos: int, cfg: ArchConfig, impl: str):
    x = rms_norm(h, lp["ln1"], cfg.norm_eps, impl)
    if cfg.mla is not None:
        a, _ = attn.mla_decode(lp["attn"], x, cache, pos, cfg, impl=impl)
    else:
        a, _ = attn.gqa_decode(lp["attn"], x, cache, pos, cfg)
    return _ffn(h + a, lp, cfg, impl)[0]


def lm_decode_step(params: Tree, cache: Tree, batch: Dict, cfg: ArchConfig,
                   *, impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    """One decode step.  batch: {"tokens": [B,1] int, "pos": int}.  The
    token's cache rows are written into ``cache`` in place; the same cache
    is returned."""
    pos = int(batch["pos"])
    h = _embed_tokens(params, batch["tokens"], cfg)
    for name, _, _ in _groups(cfg):
        for lp, lc in zip(params[name], split_layers(cache[name])):
            h = _decode_layer(h, lp, lc, pos, cfg, impl)
    return _logits(params, h, cfg, impl), cache


def lm_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    """ParamDef tree describing the decode cache (stacked per group)."""
    if cfg.mla is not None:
        c = cfg.mla
        per_layer = {
            "c_kv": ParamDef((batch, seq, c.kv_lora_rank),
                             ("batch", "kv_seq", None), init="zeros"),
            "k_rope": ParamDef((batch, seq, c.qk_rope_head_dim),
                               ("batch", "kv_seq", None), init="zeros"),
        }
    else:
        KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
        per_layer = {
            name: ParamDef((batch, seq, KV, hd),
                           ("batch", "kv_seq", "kv_heads", None), init="zeros")
            for name in ("k", "v")}
    return {name: stack_defs(per_layer, depth)
            for name, depth, _ in _groups(cfg)}
