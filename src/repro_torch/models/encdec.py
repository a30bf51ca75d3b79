"""Whisper-style encoder-decoder backbone (the conv / mel front end is a
stub: inputs are precomputed frame embeddings ``[B, T, d_model]``).

Twin of the reference's ``models/encdec.py``.  The encoder is
bidirectional; the decoder is causal with cross attention to the encoder's
output; positions are sinusoidal and additive (no RoPE); FFNs are SwiGLU.
Only the decoder's causal self-attention reaches ``flash_attention`` under
``impl="flash"``: the encoder's attention is non-causal and cross attention
reads other keys, so both take the einsum path, as in the reference.

``encdec_loss`` checkpoints each decoder layer whole under any ``remat``
but ``"none"`` (the encoder is not checkpointed), as the reference does.

Parameters: ``enc_layers`` and ``dec_layers`` (lists of per-layer dicts).
Caches keep the reference's layout, ``{"self": {"k", "v": [L,B,S,KV,hd]},
"cross": {"k", "v": [L,B,T,KV,hd]}}``; decode writes the self-attention
rows in place and leaves the cross keys and values as they are.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models.common import (ParamDef, checkpointed,
                                       cross_entropy_loss, embed_lookup,
                                       mesh_einsum, mlp_defs, rms_norm,
                                       scan_layers, shard_batch,
                                       sinusoidal_position,
                                       sinusoidal_positions, split_layers,
                                       stack_defs, swiglu)

Tree = Any


def _enc_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "attn": attn.gqa_defs(cfg),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def _dec_layer_defs(cfg: ArchConfig) -> Dict[str, Any]:
    return {
        "ln1": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln_x": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "ln2": ParamDef((cfg.d_model,), ("d_model",), init="ones"),
        "self_attn": attn.gqa_defs(cfg),
        "cross_attn": attn.gqa_defs(cfg),
        "mlp": mlp_defs(cfg.d_model, cfg.d_ff),
    }


def encdec_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    V, D = cfg.padded_vocab, cfg.d_model
    return {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "enc_norm": ParamDef((D,), ("d_model",), init="ones"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
        "lm_head": ParamDef((D, V), ("d_model", "vocab")),
        "enc_layers": stack_defs(_enc_layer_defs(cfg),
                                 cfg.encdec.encoder_layers),
        "dec_layers": stack_defs(_dec_layer_defs(cfg), cfg.num_layers),
    }


def _mlp(lp: Tree, h: torch.Tensor, cfg: ArchConfig,
         impl: str) -> torch.Tensor:
    x = rms_norm(h, lp["ln2"], cfg.norm_eps, impl)
    return shard_batch(h + swiglu(x, lp["mlp"]["gate"], lp["mlp"]["up"],
                                  lp["mlp"]["down"]))


def _encode(params: Tree, frames: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    T = frames.shape[1]
    h = frames.to(getattr(torch, cfg.compute_dtype))
    h = h + sinusoidal_positions(T, cfg.d_model, h.device).to(h.dtype)[None]
    for lp in params["enc_layers"]:
        x = rms_norm(h, lp["ln1"], cfg.norm_eps, impl)
        a, _ = attn.gqa_forward(lp["attn"], x, cfg, causal=False,
                                use_rope=False, impl=impl)
        h = _mlp(lp, shard_batch(h + a), cfg, impl)
    return rms_norm(h, params["enc_norm"], cfg.norm_eps, impl)


def _dec_layer(h, lp, enc_out, cfg: ArchConfig, impl: str):
    """One decoder layer; returns (output, (self kv, cross kv))."""
    x = rms_norm(h, lp["ln1"], cfg.norm_eps, impl)
    a, kv = attn.gqa_forward(lp["self_attn"], x, cfg, causal=True,
                             use_rope=False, impl=impl)
    h = h + a
    x = rms_norm(h, lp["ln_x"], cfg.norm_eps, impl)
    c, cross_kv = attn.gqa_forward(lp["cross_attn"], x, cfg, kv_x=enc_out,
                                   causal=False, use_rope=False, impl=impl)
    return _mlp(lp, h + c, cfg, impl), (kv, cross_kv)


def _embed(params: Tree, tokens: torch.Tensor, cfg: ArchConfig):
    h = embed_lookup(params["embed"], tokens).to(
        getattr(torch, cfg.compute_dtype))
    return h + sinusoidal_positions(tokens.shape[1], cfg.d_model,
                                    h.device).to(h.dtype)[None]


def _logits(params: Tree, h: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, impl)
    return mesh_einsum("bsd,dv->bsv", h, params["lm_head"])


def encdec_forward(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla", remat: str = "none") -> torch.Tensor:
    enc_out = _encode(params, batch["frames"], cfg, impl)
    h = _embed(params, batch["tokens"], cfg)
    layer = checkpointed(
        lambda c, lp: _dec_layer(c, lp, enc_out, cfg, impl)[0],
        "full" if remat != "none" else "none")
    for lp in params["dec_layers"]:
        h = layer(h, lp)
    return _logits(params, h, cfg, impl)


def encdec_loss(params: Tree, batch: Dict, cfg: ArchConfig, *,
                impl: str = "xla", remat: str = "dots") -> torch.Tensor:
    logits = encdec_forward(params, batch, cfg, impl=impl, remat=remat)
    return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])


def encdec_prefill(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    enc_out = _encode(params, batch["frames"], cfg, impl)
    h = _embed(params, batch["tokens"], cfg)
    h, (self_kv, cross_kv) = scan_layers(
        lambda c, lp: _dec_layer(c, lp, enc_out, cfg, impl), h,
        params["dec_layers"])
    return _logits(params, h[:, -1:, :], cfg, impl), {"self": self_kv,
                                                      "cross": cross_kv}


def encdec_decode_step(params: Tree, cache: Tree, batch: Dict,
                       cfg: ArchConfig, *, impl: str = "xla"
                       ) -> Tuple[torch.Tensor, Tree]:
    """One decode step; the self-attention cache is written in place and
    the same cache returned."""
    pos = int(batch["pos"])
    h = embed_lookup(params["embed"], batch["tokens"]).to(
        getattr(torch, cfg.compute_dtype))
    S_table = max(cache["self"]["k"].shape[2], 1)
    h = h + sinusoidal_position(S_table, cfg.d_model, pos,
                                h.device).to(h.dtype)[None]
    for lp, self_c, cross_c in zip(params["dec_layers"],
                                   split_layers(cache["self"]),
                                   split_layers(cache["cross"])):
        x = rms_norm(h, lp["ln1"], cfg.norm_eps, impl)
        a, _ = attn.gqa_decode(lp["self_attn"], x, self_c, pos, cfg,
                               use_rope=False)
        h = h + a
        x = rms_norm(h, lp["ln_x"], cfg.norm_eps, impl)
        h = _mlp(lp, h + attn.gqa_cross_decode(lp["cross_attn"], x, cross_c,
                                               cfg), cfg, impl)
    return _logits(params, h, cfg, impl), cache


def encdec_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    KV, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    T = cfg.encdec.encoder_frames
    self_cache = {
        name: ParamDef((batch, seq, KV, hd),
                       ("batch", "kv_seq", "kv_heads", None), init="zeros")
        for name in ("k", "v")}
    cross_cache = {
        name: ParamDef((batch, T, KV, hd), ("batch", None, "kv_heads", None),
                       init="zeros")
        for name in ("k", "v")}
    return {"self": stack_defs(self_cache, cfg.num_layers),
            "cross": stack_defs(cross_cache, cfg.num_layers)}
