"""Attention: GQA (grouped-query) and MLA (multi-head latent, DeepSeek).

Twin of the reference's ``models/attention.py``.  Lowerings:

  * full sequence (prefill / forward) — ``impl="xla"``: grouped einsum with
    an optional q-chunked block-causal loop for long sequences (exact-causal
    at block granularity); ``impl="flash"``: the hand-written
    ``flash_attention`` kernel, for causal self-attention only (non-causal
    and cross attention take the einsum path, as in the reference);
  * decode — one query position against a cache; cross attention against
    the encoder's fixed keys and values;
  * MLA — full sequence by expanding the latent keys and values per head
    (always the einsum path, whatever ``impl``: the reference never sends
    MLA to its kernel; its q / kv norms follow ``impl``, as every norm does,
    ``common.rms_norm``); decode by matrix absorption over the compressed
    cache ``{"c_kv": [B,S,r], "k_rope": [B,S,rope]}``, never expanded.

Decode writes the new cache rows into the cache tensors in place and
returns them, where the reference returns updated copies: the port saves
copying the whole cache on every generated token.  On a device mesh
(``DTensor`` inputs) attention runs on whole heads, sharded over ``model``
where the KV heads divide it (:func:`mesh_heads`).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import (ParamDef, apply_rope, mesh_einsum,
                                       model_extent, rms_norm, shard_as)
from repro_torch.obs.spans import span

NEG_INF = -1e30


# --------------------------------------------------------------------------- #
# core scaled-dot-product attention (grouped, no kv repeat materialization)
# --------------------------------------------------------------------------- #
def mesh_heads(q, k, v):
    """On a device mesh, q [B,Sq,H,*] and k, v [B,Sk,KV,*] batch-sharded
    and head-sharded over ``model`` where the KV heads divide it, so that
    no query group straddles two shards; else heads replicated.  Plain
    tensors pass through."""
    if not isinstance(q, DTensor):
        return q, k, v
    heads = 2 if k.shape[2] % model_extent(q.device_mesh) == 0 else None
    return (shard_as(q, 0, heads), shard_as(k, 0, heads),
            shard_as(v, 0, heads))


def on_head_shards(fn, q, k, v, **kw):
    """``fn(q, k, v, **kw)`` of attention inputs placed by
    :func:`mesh_heads`, run on each rank's whole heads and batch rows (the
    result is that rank's shard of the output, placed as ``q``).  Plain
    tensors go to ``fn`` as they are."""
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    q, k, v = mesh_heads(q, k, v)
    out = fn(q.to_local(), k.to_local(), v.to_local(), **kw)
    return DTensor.from_local(out, q.device_mesh, q.placements,
                              run_check=False)


def _sdpa_block(q, k, v, *, scale, causal, q_pos, k_pos):
    """q [B,Sq,KV,G,hd]; k/v [B,Sk,KV,hd]; positions for masking."""
    scores = torch.einsum("bqkgd,bskd->bkgqs", q, k).float() * scale
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]                 # [Sq, Sk]
        scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
         causal: bool = True, q_offset: int = 0,
         chunk_q: Optional[int] = None,
         scale: Optional[float] = None) -> torch.Tensor:
    """q [B,Sq,H,hd], k/v [B,Sk,KV,hd] -> [B,Sq,H,hd]; the scores scaled by
    ``scale`` (``1 / sqrt(hd)`` unless given).

    When ``chunk_q`` is set and the sequence is causal and aligned, runs a
    loop over query blocks where block i only reads keys
    ``[0 : (i+1)*chunk_q]`` — block-exact causal FLOPs.
    """
    if isinstance(q, DTensor):
        return on_head_shards(sdpa, q, k, v, causal=causal,
                              q_offset=q_offset, chunk_q=chunk_q,
                              scale=scale)
    B, Sq, H, hd = q.shape
    _, Sk, KV, _ = k.shape
    hd_v = v.shape[-1]
    assert H % KV == 0, (H, KV)
    G = H // KV
    scale = scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, Sq, KV, G, hd)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Sk, device=q.device)

    use_chunks = (chunk_q is not None and causal and q_offset == 0
                  and Sq == Sk and Sq % chunk_q == 0 and Sq // chunk_q > 1)
    if not use_chunks:
        out = _sdpa_block(qg, k, v, scale=scale, causal=causal,
                          q_pos=q_pos, k_pos=k_pos)
        return out.reshape(B, Sq, H, hd_v)

    outs = []
    for i in range(Sq // chunk_q):
        lo, hi = i * chunk_q, (i + 1) * chunk_q
        outs.append(_sdpa_block(
            qg[:, lo:hi], k[:, :hi], v[:, :hi], scale=scale, causal=True,
            q_pos=q_pos[lo:hi], k_pos=k_pos[:hi]))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd_v)


def sdpa_decode(q, k_cache, v_cache, *, pos: int, scale=None):
    """q [B,1,H,hd]; caches [B,S,KV,hd]; pos: last valid index."""
    if isinstance(q, DTensor):
        return on_head_shards(sdpa_decode, q, k_cache, v_cache, pos=pos,
                              scale=scale)
    B, _, H, hd = q.shape
    _, S, KV, _ = k_cache.shape
    scale = scale or 1.0 / math.sqrt(hd)
    qg = q.reshape(B, 1, KV, H // KV, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k_cache).float() * scale
    valid = torch.arange(S, device=q.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs, v_cache)
    return out.reshape(B, 1, H, hd)


# --------------------------------------------------------------------------- #
# GQA block
# --------------------------------------------------------------------------- #
def gqa_defs(cfg: ArchConfig, num_heads=None, num_kv=None,
             d_in=None) -> Dict[str, ParamDef]:
    """Projections keep the head dim explicit ([D, H, hd]), as the
    reference does.  ``d_in``: the width q, k and v are projected from,
    where it is not ``d_model`` (the output product still ends there)."""
    D = cfg.d_model
    Din = d_in or D
    H = num_heads or cfg.num_heads
    KV = num_kv or cfg.num_kv_heads
    hd = cfg.resolved_head_dim
    defs = {
        "wq": ParamDef((Din, H, hd), ("d_model", "heads", None)),
        "wk": ParamDef((Din, KV, hd), ("d_model", "kv_heads", None)),
        "wv": ParamDef((Din, KV, hd), ("d_model", "kv_heads", None)),
        "wo": ParamDef((H, hd, D), ("heads", None, "d_model")),
    }
    if cfg.qkv_bias:
        defs["bq"] = ParamDef((H, hd), ("heads", None), init="zeros")
        defs["bk"] = ParamDef((KV, hd), ("kv_heads", None), init="zeros")
        defs["bv"] = ParamDef((KV, hd), ("kv_heads", None), init="zeros")
    return defs


def _project_qkv(p, x, kv_x, cfg):
    with span("repro.attn.qkv"):
        q = mesh_einsum("bsd,dhe->bshe", x, p["wq"])
        k = mesh_einsum("bsd,dhe->bshe", kv_x, p["wk"])
        v = mesh_einsum("bsd,dhe->bshe", kv_x, p["wv"])
        if cfg.qkv_bias:
            q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
        return q, k, v


def gqa_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: Optional[torch.Tensor] = None,
                kv_x: Optional[torch.Tensor] = None,
                causal: bool = True,
                use_rope: bool = True,
                impl: str = "xla",
                scale: Optional[float] = None) -> Tuple[torch.Tensor, Dict]:
    """Full-sequence attention, the scores scaled by ``scale`` (``1 /
    sqrt(head_dim)`` unless given).  Returns (output, kv cache
    contents)."""
    q, k, v = _project_qkv(p, x, x if kv_x is None else kv_x, cfg)
    if use_rope:
        if positions is None:
            positions = torch.arange(x.shape[1], device=x.device)[None, :]
        q = apply_rope(q, positions, cfg.rope_theta)
        if kv_x is None:
            k = apply_rope(k, positions, cfg.rope_theta)
    S = x.shape[1]
    chunk = cfg.attn_chunk_q if (S >= cfg.attn_chunk_threshold
                                 and causal) else None
    with span("repro.attn.core"):
        if impl == "flash" and causal and kv_x is None:
            out = kops.flash_attention(*mesh_heads(q, k, v), causal=True,
                                       scale=scale)
        else:
            out = sdpa(q, k, v, causal=causal, chunk_q=chunk, scale=scale)
    with span("repro.attn.out"):
        y = mesh_einsum("bshe,hed->bsd", out, p["wo"])
    return y, {"k": k, "v": v}


def gqa_decode(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
               cfg: ArchConfig, *, use_rope: bool = True,
               scale: Optional[float] = None) -> Tuple[torch.Tensor, Dict]:
    """One-token decode.  x [B,1,D]; cache {"k","v"} [B,S,KV,hd], written at
    row ``pos`` in place."""
    q, k, v = _project_qkv(p, x, x, cfg)
    if use_rope:
        posb = torch.full((x.shape[0], 1), pos, device=x.device)
        q = apply_rope(q, posb, cfg.rope_theta)
        k = apply_rope(k, posb, cfg.rope_theta)
    cache["k"][:, pos] = k[:, 0].to(cache["k"].dtype)
    cache["v"][:, pos] = v[:, 0].to(cache["v"].dtype)
    out = sdpa_decode(q, cache["k"], cache["v"], pos=pos, scale=scale)
    y = mesh_einsum("bshe,hed->bsd", out, p["wo"])
    return y, cache


def gqa_cross_decode(p: Dict, x: torch.Tensor, cache: Dict,
                     cfg: ArchConfig) -> torch.Tensor:
    """Cross attention during decode against the precomputed (fixed) encoder
    keys and values ``cache {"k", "v"} [B,T,KV,hd]``."""
    q = mesh_einsum("bsd,dhe->bshe", x, p["wq"])
    out = sdpa(q, cache["k"], cache["v"], causal=False)
    return mesh_einsum("bshe,hed->bsd", out, p["wo"])


# --------------------------------------------------------------------------- #
# MLA (DeepSeek V2/V3)
# --------------------------------------------------------------------------- #
def mla_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    c = cfg.mla
    D, H = cfg.d_model, cfg.num_heads
    qk_hd = c.qk_nope_head_dim + c.qk_rope_head_dim
    defs: Dict[str, ParamDef] = {}
    if c.q_lora_rank:
        defs["wq_a"] = ParamDef((D, c.q_lora_rank), ("d_model", None))
        defs["q_norm"] = ParamDef((c.q_lora_rank,), (None,), init="ones")
        defs["wq_b"] = ParamDef((c.q_lora_rank, H, qk_hd),
                                (None, "heads", None))
    else:
        defs["wq"] = ParamDef((D, H, qk_hd), ("d_model", "heads", None))
    defs["wkv_a"] = ParamDef((D, c.kv_lora_rank + c.qk_rope_head_dim),
                             ("d_model", None))
    defs["kv_norm"] = ParamDef((c.kv_lora_rank,), (None,), init="ones")
    defs["wkv_b"] = ParamDef(
        (c.kv_lora_rank, H, c.qk_nope_head_dim + c.v_head_dim),
        (None, "heads", None))
    defs["wo"] = ParamDef((H, c.v_head_dim, D), ("heads", None, "d_model"))
    return defs


def _mla_q(p, x, cfg, impl):
    """(q_nope, q_rope), each ``[B,S,H,*]``."""
    c = cfg.mla
    if c.q_lora_rank:
        q = mesh_einsum("bsd,dr->bsr", x, p["wq_a"])
        q = rms_norm(q, p["q_norm"], cfg.norm_eps, impl)
        q = mesh_einsum("bsr,rhe->bshe", q, p["wq_b"])
    else:
        q = mesh_einsum("bsd,dhe->bshe", x, p["wq"])
    return torch.split(q, [c.qk_nope_head_dim, c.qk_rope_head_dim], dim=-1)


def _mla_latent(p, x, positions, cfg, impl):
    """The compressed cache rows of ``x``: normed ``c_kv [B,S,r]`` and the
    roped ``k_rope [B,S,rope]``."""
    c = cfg.mla
    kv = mesh_einsum("bsd,dr->bsr", x, p["wkv_a"])
    c_kv, k_rope = torch.split(kv, [c.kv_lora_rank, c.qk_rope_head_dim],
                               dim=-1)
    c_kv = rms_norm(c_kv, p["kv_norm"], cfg.norm_eps, impl)
    k_rope = apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)
    return c_kv, k_rope[:, :, 0, :]


def mla_forward(p: Dict, x: torch.Tensor, cfg: ArchConfig, *,
                positions: Optional[torch.Tensor] = None,
                impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """Full-sequence MLA (prefill / forward) by expanding the latent keys
    and values per head; q / k head dim ``nope + rope``, v head dim
    ``v_head_dim``.  Returns (output, the compressed cache rows)."""
    c = cfg.mla
    B, S, _ = x.shape
    H = cfg.num_heads
    if positions is None:
        positions = torch.arange(S, device=x.device)[None, :]
    q_nope, q_rope = _mla_q(p, x, cfg, impl)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c_kv, k_rope = _mla_latent(p, x, positions, cfg, impl)

    kv_up = mesh_einsum("bsr,rhe->bshe", c_kv, p["wkv_b"])
    k_nope, v = torch.split(kv_up, [c.qk_nope_head_dim, c.v_head_dim],
                            dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        B, S, H, c.qk_rope_head_dim)], dim=-1)
    q = torch.cat([q_nope, q_rope], dim=-1)
    chunk = cfg.attn_chunk_q if S >= cfg.attn_chunk_threshold else None
    # sdpa scales by 1 / sqrt(q.shape[-1]) = 1 / sqrt(nope + rope)
    out = sdpa(q, k, v, causal=True, chunk_q=chunk)
    y = mesh_einsum("bshe,hed->bsd", out, p["wo"])
    return y, {"c_kv": c_kv, "k_rope": k_rope}


def mla_decode(p: Dict, x: torch.Tensor, cache: Dict, pos: int,
               cfg: ArchConfig, *, impl: str = "xla"
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token MLA decode by matrix absorption: ``wkv_b``'s key part is
    folded into the query and its value part applied after the softmax, so
    attention runs over the compressed cache ``{"c_kv": [B,S,r], "k_rope":
    [B,S,rope]}`` (row ``pos`` written in place), never expanded per
    head."""
    c = cfg.mla
    B = x.shape[0]
    q_nope, q_rope = _mla_q(p, x, cfg, impl)               # [B,1,H,*]
    posb = torch.full((B, 1), pos, device=x.device)
    q_rope = apply_rope(q_rope, posb, cfg.rope_theta)
    c_kv_new, k_rope_new = _mla_latent(p, x, posb, cfg, impl)
    cache["c_kv"][:, pos] = c_kv_new[:, 0].to(cache["c_kv"].dtype)
    cache["k_rope"][:, pos] = k_rope_new[:, 0].to(cache["k_rope"].dtype)
    c_kv, k_rope = cache["c_kv"], cache["k_rope"]

    w_k, w_v = torch.split(p["wkv_b"], [c.qk_nope_head_dim, c.v_head_dim],
                           dim=-1)                          # [r,H,dk], [r,H,dv]
    q_lat = mesh_einsum("bqhd,rhd->bqhr", q_nope, w_k)    # [B,1,H,r]
    scale = 1.0 / math.sqrt(c.qk_nope_head_dim + c.qk_rope_head_dim)
    scores = (torch.einsum("bqhr,bsr->bhqs", q_lat, c_kv)
              + torch.einsum("bqhr,bsr->bhqs", q_rope, k_rope))
    scores = scores.float() * scale
    valid = torch.arange(c_kv.shape[1], device=x.device) <= pos
    scores = torch.where(valid, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(c_kv.dtype)
    o_lat = torch.einsum("bhqs,bsr->bqhr", probs, c_kv)    # [B,1,H,r]
    out = mesh_einsum("bqhr,rhd->bqhd", o_lat, w_v)       # [B,1,H,dv]
    y = mesh_einsum("bshe,hed->bsd", out, p["wo"])
    return y, cache
