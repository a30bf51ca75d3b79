"""Decoder-only LM stack, dense GQA variant.

Twin of the dense path of the reference's ``models/transformer.py``.  Layer
parameters are a list of per-layer dicts and the stack runs as a Python
loop (``common.scan_layers``); caches keep the reference's stacked layout
``{"layers": {"k", "v": [L, B, S, KV, hd]}}``.

MoE, MLA, multi-token prediction and the VLM backbone are not ported yet
(ROADMAP Queue A, model zoo); every entry point raises ``NotImplementedError``
for a config that needs them rather than running another path.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamDef, mlp_defs, rms_norm,
                                       scan_layers, split_layers, stack_defs,
                                       swiglu)

Tree = Any

NOT_PORTED = "not ported yet (ROADMAP Queue A, model zoo)"


def check_dense(cfg: ArchConfig) -> None:
    """Raise for the parts of the reference's LM stack the port lacks."""
    for field in ("moe", "mla", "vlm"):
        if getattr(cfg, field) is not None:
            raise NotImplementedError(
                f"{cfg.name}: {field.upper()} layers are {NOT_PORTED}")
    if cfg.mtp:
        raise NotImplementedError(
            f"{cfg.name}: multi-token prediction is {NOT_PORTED}")


# --------------------------------------------------------------------------- #
# parameter definitions
# --------------------------------------------------------------------------- #
def _layer_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    return {
        "ln1": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "attn": attn.gqa_defs(cfg),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def lm_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    """The reference's tree: ``layers`` is stacked ``[L, ...]`` here (the
    model splits it into per-layer dicts once the tensors exist)."""
    check_dense(cfg)
    V, D = cfg.padded_vocab, cfg.d_model
    defs: Dict[str, Tree] = {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
        "layers": stack_defs(_layer_defs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("d_model", "vocab"))
    return defs


# --------------------------------------------------------------------------- #
# layer bodies
# --------------------------------------------------------------------------- #
def _layer_fwd(h: torch.Tensor, lp: Dict, cfg: ArchConfig,
               impl: str) -> Tuple[torch.Tensor, Dict]:
    """One layer; returns (output, the layer's kv cache contents)."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, kv = attn.gqa_forward(lp["attn"], x, cfg, impl=impl)
    h = h + a
    x = rms_norm(h, lp["ln2"], cfg.norm_eps)
    f = swiglu(x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"])
    return h + f, kv


def _trunk(params: Tree, h: torch.Tensor, cfg: ArchConfig,
           impl: str) -> torch.Tensor:
    for lp in params["layers"]:
        h, _ = _layer_fwd(h, lp, cfg, impl)
    return h


def _logits(params: Tree, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return torch.einsum("bsd,dv->bsv", h, w)


def _embed_tokens(params: Tree, tokens: torch.Tensor,
                  cfg: ArchConfig) -> torch.Tensor:
    return params["embed"][tokens].to(getattr(torch, cfg.compute_dtype))


# --------------------------------------------------------------------------- #
# public entry points
# --------------------------------------------------------------------------- #
def lm_forward(params: Tree, batch: Dict, cfg: ArchConfig, *,
               impl: str = "xla") -> torch.Tensor:
    """Full-sequence logits ``[B, S, V]``."""
    check_dense(cfg)
    h = _embed_tokens(params, batch["tokens"], cfg)
    return _logits(params, _trunk(params, h, cfg, impl), cfg)


def lm_prefill(params: Tree, batch: Dict, cfg: ArchConfig, *,
               impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    """Process the full prompt; return (last-position logits, kv caches)."""
    check_dense(cfg)
    h = _embed_tokens(params, batch["tokens"], cfg)
    h, kv = scan_layers(lambda c, lp: _layer_fwd(c, lp, cfg, impl), h,
                        params["layers"])
    return _logits(params, h[:, -1:, :], cfg), {"layers": kv}


def _decode_layer(h, lp, cache, pos: int, cfg: ArchConfig):
    x = rms_norm(h, lp["ln1"], cfg.norm_eps)
    a, cache = attn.gqa_decode(lp["attn"], x, cache, pos, cfg)
    h = h + a
    x = rms_norm(h, lp["ln2"], cfg.norm_eps)
    f = swiglu(x, lp["mlp"]["gate"], lp["mlp"]["up"], lp["mlp"]["down"])
    return h + f


def lm_decode_step(params: Tree, cache: Tree, batch: Dict, cfg: ArchConfig
                   ) -> Tuple[torch.Tensor, Tree]:
    """One decode step.  batch: {"tokens": [B,1] int, "pos": int}.  The
    token's keys and values are written into ``cache`` in place; the same
    cache is returned."""
    check_dense(cfg)
    pos = int(batch["pos"])
    h = _embed_tokens(params, batch["tokens"], cfg)
    layer_caches: List[Dict] = split_layers(cache["layers"])
    for lp, lc in zip(params["layers"], layer_caches):
        h = _decode_layer(h, lp, lc, pos, cfg)
    return _logits(params, h, cfg), cache


def lm_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    """ParamDef tree describing the decode cache (stacked over layers)."""
    check_dense(cfg)
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    per_layer = {
        name: ParamDef((batch, seq, KV, hd),
                       ("batch", "kv_seq", "kv_heads", None), init="zeros")
        for name in ("k", "v")}
    return {"layers": stack_defs(per_layer, cfg.num_layers)}
