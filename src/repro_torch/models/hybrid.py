"""Zamba2-style hybrid: a Mamba2 trunk with shared attention blocks.

Twin of the reference's ``models/hybrid.py``.  ``num_layers`` SSD layers
form ``num_layers / attn_every`` groups; after group ``g`` the shared
attention + MLP block ``g % shared_attn_blocks`` is applied (round-robin
over a few blocks whose parameters every application shares: the block is
indexed in the list, never copied).  One ``impl`` string drives both kinds
of layer, as in the reference: ``"flash"`` sends the shared blocks' causal
attention to the ``flash_attention`` kernel (and the SSD layers to the
chunked torch form), ``"pallas"`` sends the SSD scans to the ``ssd_scan``
kernel (and attention to the einsum path) — never both in one run.

``hybrid_loss`` checkpoints a whole group (its SSD layers and its shared
block) under any ``remat`` but ``"none"``, as the reference does (which
turns every other policy into ``"full"``).

Parameters: ``ssm_layers`` (L per-layer dicts) and ``shared`` (one dict per
shared block).  Caches keep the reference's layout, ``{"ssm_layers":
{"ssm": [L,B,H,P,N], "conv": [L,B,K-1,C]}, "attn": {"k", "v":
[G,B,S,KV,hd]}}``, and decode updates them in place.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, checkpointed,
                                       cross_entropy_loss, embed_lookup,
                                       mesh_einsum, mlp_defs, rms_norm,
                                       shard_batch, split_layers, stack_defs,
                                       stack_trees, swiglu)

Tree = Any


def _shared_block_defs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "attn": attn.gqa_defs(cfg),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def hybrid_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    V, D = cfg.padded_vocab, cfg.d_model
    hb = cfg.hybrid
    assert cfg.num_layers % hb.attn_every == 0
    return {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
        "lm_head": ParamDef((D, V), ("d_model", "vocab")),
        "ssm_layers": stack_defs(ssm_mod.ssm_defs(cfg), cfg.num_layers),
        "shared": stack_defs(_shared_block_defs(cfg), hb.shared_attn_blocks,
                             axis_name="shared_blocks"),
    }


def _groups(params: Tree, cfg: ArchConfig):
    """Per group: (its SSD layers' params, its shared block's params)."""
    hb = cfg.hybrid
    E = hb.attn_every
    for g in range(cfg.num_layers // E):
        yield (params["ssm_layers"][g * E:(g + 1) * E],
               params["shared"][g % hb.shared_attn_blocks])


def _embed(params: Tree, tokens: torch.Tensor, cfg: ArchConfig):
    return embed_lookup(params["embed"], tokens).to(
        getattr(torch, cfg.compute_dtype))


def _logits(params: Tree, h: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, impl)
    return mesh_einsum("bsd,dv->bsv", h, params["lm_head"])


def _mlp(sp: Tree, h: torch.Tensor, cfg: ArchConfig,
         impl: str) -> torch.Tensor:
    x = rms_norm(h, sp["ln2"], cfg.norm_eps, impl)
    return shard_batch(h + swiglu(x, sp["mlp"]["gate"], sp["mlp"]["up"],
                                  sp["mlp"]["down"]))


def _shared_fwd(sp: Tree, h: torch.Tensor, cfg: ArchConfig,
                impl: str) -> Tuple[torch.Tensor, Dict]:
    """One application of a shared block; returns (output, its keys and
    values)."""
    x = rms_norm(h, sp["ln1"], cfg.norm_eps, impl)
    a, kv = attn.gqa_forward(sp["attn"], x, cfg, impl=impl)
    return _mlp(sp, h + a, cfg, impl), kv


def hybrid_forward(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla", remat: str = "none") -> torch.Tensor:
    def group(h, layers, sp):
        for lp in layers:
            h = h + ssm_mod.ssm_forward(lp, h, cfg, impl=impl)
        return _shared_fwd(sp, h, cfg, impl)[0]

    group = checkpointed(group, remat)
    h = _embed(params, batch["tokens"], cfg)
    for layers, sp in _groups(params, cfg):
        h = group(h, layers, sp)
    return _logits(params, h, cfg, impl)


def hybrid_loss(params: Tree, batch: Dict, cfg: ArchConfig, *,
                impl: str = "xla", remat: str = "dots") -> torch.Tensor:
    logits = hybrid_forward(params, batch, cfg, impl=impl,
                            remat="full" if remat != "none" else "none")
    return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])


def hybrid_prefill(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    h = _embed(params, batch["tokens"], cfg)
    states, kvs = [], []
    for layers, sp in _groups(params, cfg):
        for lp in layers:
            out, state = ssm_mod.ssm_forward(lp, h, cfg, return_state=True,
                                             impl=impl)
            h = h + out
            states.append(state)
        h, kv = _shared_fwd(sp, h, cfg, impl)
        kvs.append(kv)
    return _logits(params, h[:, -1:, :], cfg, impl), {
        "ssm_layers": stack_trees(states), "attn": stack_trees(kvs)}


def hybrid_decode_step(params: Tree, cache: Tree, batch: Dict,
                       cfg: ArchConfig, *, impl: str = "xla"
                       ) -> Tuple[torch.Tensor, Tree]:
    """One decode step; every cache tensor is updated in place and the same
    cache returned."""
    pos = int(batch["pos"])
    h = _embed(params, batch["tokens"], cfg)
    ssm_caches = split_layers(cache["ssm_layers"])
    attn_caches = split_layers(cache["attn"])
    E = cfg.hybrid.attn_every
    for g, (layers, sp) in enumerate(_groups(params, cfg)):
        for lp, lc in zip(layers, ssm_caches[g * E:(g + 1) * E]):
            out, _ = ssm_mod.ssm_decode(lp, h, lc, cfg, impl=impl)
            h = h + out
        x = rms_norm(h, sp["ln1"], cfg.norm_eps, impl)
        a, _ = attn.gqa_decode(sp["attn"], x, attn_caches[g], pos, cfg)
        h = _mlp(sp, h + a, cfg, impl)
    return _logits(params, h, cfg, impl), cache


def hybrid_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    s = cfg.ssm
    D = cfg.d_model
    H, P, N = s.n_heads(D), s.head_dim, s.d_state
    conv_dim = s.d_inner(D) + 2 * s.n_groups * s.d_state
    n_groups = cfg.num_layers // cfg.hybrid.attn_every
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    ssm_cache = {
        "ssm": ParamDef((batch, H, P, N), ("batch", "ssm_heads", None, None),
                        init="zeros"),
        "conv": ParamDef((batch, s.d_conv - 1, conv_dim),
                         ("batch", None, "d_inner"), init="zeros"),
    }
    attn_cache = {
        name: ParamDef((batch, seq, KV, hd),
                       ("batch", "kv_seq", "kv_heads", None), init="zeros")
        for name in ("k", "v")}
    return {
        "ssm_layers": stack_defs(ssm_cache, cfg.num_layers),
        "attn": stack_defs(attn_cache, n_groups, axis_name="groups"),
    }
