"""Zamba2-style hybrid: a Mamba2 trunk with shared attention blocks.

Twin of the reference's ``models/hybrid.py``, in two forms (``HybridConfig``):

* the reference's: ``num_layers`` SSD layers form ``num_layers /
  attn_every`` groups; after group ``g`` the shared attention + SwiGLU block
  ``g % shared_attn_blocks`` is applied, over ``d_model`` with a residual
  around each half;
* the published Zamba2 (``layer_ids`` given): before each listed layer,
  application ``j`` of block ``j % shared_attn_blocks`` computes, with ``e``
  the embedding output,

      x = rms_norm(concat(h, e))                      (2 d_model wide)
      a = attn(x)      causal, RoPE over the whole head, scale (hd / 2)^-0.5
      m = rms_norm(a)
      g, u = m W_gu + (m A_j) B_j                     (LoRA of rank r)
      h = h + L_j((gelu(g) * u) W_down)

  with ``A_j``, ``B_j`` and the linear ``L_j`` of that application alone
  (``params["apps"]``).

The shared blocks are indexed in the list, never copied.  Every layer then
adds its Mamba2 mixer, ``h = h + ssm(rms_norm(h))``.  ``impl`` lowers both
kinds of layer at once: under a kernel lowering (``"flash"`` or
``"pallas"``) the scans go to the ``ssd_scan`` kernel and the blocks'
causal attention to ``flash_attention`` (as every norm goes to
``rmsnorm``), and ``"xla"`` keeps both on the composite path.  (The
reference sends only the attention to its kernel under ``"flash"`` and only
the scans under ``"pallas"``.)

``hybrid_loss`` checkpoints a whole group (its SSD layers and the
application that follows them) under any ``remat`` but ``"none"``, as the
reference does (which turns every other policy into ``"full"``).

Parameters: ``ssm_layers`` (L per-layer dicts), ``shared`` (one dict per
shared block) and, in the published form, ``apps`` (one dict per
application).  Caches keep the reference's layout, ``{"ssm_layers":
{"ssm": [L,B,H,P,N], "conv": [L,B,K-1,C]}, "attn": {"k", "v":
[G,B,S,KV,hd]}}`` with G the applications, and decode updates them in
place.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.models import attention as attn
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.common import (ParamDef, checkpointed,
                                       cross_entropy_loss, embed_lookup,
                                       mesh_einsum, mlp_defs, rms_norm,
                                       shard_batch, split_layers, stack_defs,
                                       stack_trees, swiglu)
from repro_torch.obs.spans import span

Tree = Any


def _lowerings(impl: str) -> Tuple[str, str]:
    """(the Mamba2 layers' impl, the shared blocks' impl): a kernel lowering
    sends the scans to ``ssd_scan`` and the attention to
    ``flash_attention``."""
    return ("xla", "xla") if impl == "xla" else ("pallas", "flash")


def _shared_block_defs(cfg: ArchConfig) -> Dict[str, Any]:
    D = cfg.d_model
    if not cfg.hybrid.published:
        return {
            "ln1": ParamDef((D,), ("d_model",), init="ones"),
            "ln2": ParamDef((D,), ("d_model",), init="ones"),
            "attn": attn.gqa_defs(cfg),
            "mlp": mlp_defs(D, cfg.d_ff),
        }
    return {
        "ln1": ParamDef((2 * D,), ("d_model",), init="ones"),
        "ln2": ParamDef((D,), ("d_model",), init="ones"),
        "attn": attn.gqa_defs(cfg, d_in=2 * D),
        "mlp": {
            "gate_up": ParamDef((D, 2 * cfg.d_ff), ("d_model", "d_ff")),
            "down": ParamDef((cfg.d_ff, D), ("d_ff", "d_model")),
        },
    }


def _app_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    """One application's own weights (published form)."""
    D, r = cfg.d_model, cfg.hybrid.adapter_rank
    return {
        "lora_a": ParamDef((D, r), ("d_model", None)),
        "lora_b": ParamDef((r, 2 * cfg.d_ff), (None, "d_ff")),
        "linear": ParamDef((D, D), ("d_model", None)),
    }


def hybrid_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    V, D = cfg.padded_vocab, cfg.d_model
    hb = cfg.hybrid
    assert hb.published or cfg.num_layers % hb.attn_every == 0
    defs = {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
        "ssm_layers": stack_defs(ssm_mod.ssm_defs(cfg), cfg.num_layers),
        "shared": stack_defs(_shared_block_defs(cfg), hb.shared_attn_blocks,
                             axis_name="shared_blocks"),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("d_model", "vocab"))
    if hb.published:
        defs["apps"] = stack_defs(_app_defs(cfg), len(hb.layer_ids),
                                  axis_name="apps")
    return defs


def _groups(params: Tree, cfg: ArchConfig):
    """Per group: (its first layer, its SSD layers' params, the application
    that follows them or None)."""
    lo = 0
    for j, i in enumerate(cfg.hybrid.app_ids(cfg.num_layers)):
        yield lo, params["ssm_layers"][lo:i], j
        lo = i
    if lo < cfg.num_layers:
        yield lo, params["ssm_layers"][lo:], None


def _embed(params: Tree, tokens: torch.Tensor, cfg: ArchConfig):
    return embed_lookup(params["embed"], tokens).to(
        getattr(torch, cfg.compute_dtype))


def _logits(params: Tree, h: torch.Tensor, cfg: ArchConfig,
            impl: str) -> torch.Tensor:
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, impl)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mesh_einsum("bsd,dv->bsv", h, w)


def _mlp(sp: Tree, h: torch.Tensor, cfg: ArchConfig,
         impl: str) -> torch.Tensor:
    x = rms_norm(h, sp["ln2"], cfg.norm_eps, impl)
    return shard_batch(h + swiglu(x, sp["mlp"]["gate"], sp["mlp"]["up"],
                                  sp["mlp"]["down"]))


def _scale(cfg: ArchConfig) -> Optional[float]:
    """The published blocks' softmax scale, (head_dim / 2) ** -0.5 (Zamba2's
    attention over the concatenated input); the reference form's default."""
    if cfg.hybrid.published:
        return (cfg.resolved_head_dim / 2) ** -0.5
    return None


def _with_adapter(m: torch.Tensor, w: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """``m w + (m a) b``: on plain tensors the adapter's product is added in
    the epilogue of the large one (one cuBLAS call)."""
    low = mesh_einsum("bsd,dr->bsr", m, a)
    if isinstance(m, DTensor):
        return mesh_einsum("bsd,df->bsf", m, w) \
            + mesh_einsum("bsr,rf->bsf", low, b)
    lead = m.shape[:-1]
    out = torch.addmm(low.reshape(-1, low.shape[-1]) @ b,
                      m.reshape(-1, m.shape[-1]), w)
    return out.reshape(*lead, w.shape[-1])


def _zamba2_tail(sp: Tree, ap: Tree, a: torch.Tensor, cfg: ArchConfig,
                 impl: str) -> torch.Tensor:
    """What a published application adds to the hidden state, from its
    attention output ``a``: norm, the gated-GELU MLP with this
    application's adapter, and its linear."""
    m = rms_norm(a, sp["ln2"], cfg.norm_eps, impl)
    with span("repro.mlp"):
        with span("repro.shared.adapter"):
            gu = _with_adapter(m, sp["mlp"]["gate_up"], ap["lora_a"],
                               ap["lora_b"])
        with span("repro.mlp.gate"):
            g, u = torch.chunk(gu, 2, dim=-1)
            t = F.gelu(g) * u
        t = mesh_einsum("...f,fd->...d", t, sp["mlp"]["down"])
    with span("repro.shared.linear"):
        return mesh_einsum("bsd,de->bse", t, ap["linear"])


def _zamba2_input(sp: Tree, h: torch.Tensor, e: torch.Tensor,
                  cfg: ArchConfig, impl: str) -> torch.Tensor:
    with span("repro.shared.norm"):
        return rms_norm(torch.cat([h, e], dim=-1), sp["ln1"], cfg.norm_eps,
                        impl)


def _apply(params: Tree, j: int, h: torch.Tensor, e: torch.Tensor,
           cfg: ArchConfig, impl: str) -> Tuple[torch.Tensor, Dict]:
    """Application ``j`` of a shared block to ``h``; returns (the new hidden
    state, its keys and values)."""
    hb = cfg.hybrid
    sp = params["shared"][j % hb.shared_attn_blocks]
    with span("repro.shared"):
        if not hb.published:
            x = rms_norm(h, sp["ln1"], cfg.norm_eps, impl)
            a, kv = attn.gqa_forward(sp["attn"], x, cfg, impl=impl)
            return _mlp(sp, h + a, cfg, impl), kv
        x = _zamba2_input(sp, h, e, cfg, impl)
        a, kv = attn.gqa_forward(sp["attn"], x, cfg, impl=impl,
                                 scale=_scale(cfg))
        t = _zamba2_tail(sp, params["apps"][j], a, cfg, impl)
        return shard_batch(h + t), kv


def hybrid_forward(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla", remat: str = "none") -> torch.Tensor:
    ssm_impl, attn_impl = _lowerings(impl)

    def group(h, e, layers, j):
        for lp in layers:
            h = h + ssm_mod.ssm_forward(lp, h, cfg, impl=ssm_impl)
        return h if j is None else _apply(params, j, h, e, cfg, attn_impl)[0]

    group = checkpointed(group, remat)
    h = e = _embed(params, batch["tokens"], cfg)
    for _, layers, j in _groups(params, cfg):
        h = group(h, e, layers, j)
    return _logits(params, h, cfg, impl)


def hybrid_loss(params: Tree, batch: Dict, cfg: ArchConfig, *,
                impl: str = "xla", remat: str = "dots") -> torch.Tensor:
    logits = hybrid_forward(params, batch, cfg, impl=impl,
                            remat="full" if remat != "none" else "none")
    return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])


def hybrid_prefill(params: Tree, batch: Dict, cfg: ArchConfig, *,
                   impl: str = "xla") -> Tuple[torch.Tensor, Tree]:
    ssm_impl, attn_impl = _lowerings(impl)
    h = e = _embed(params, batch["tokens"], cfg)
    states, kvs = [], []
    for _, layers, j in _groups(params, cfg):
        for lp in layers:
            out, state = ssm_mod.ssm_forward(lp, h, cfg, return_state=True,
                                             impl=ssm_impl)
            h = h + out
            states.append(state)
        if j is not None:
            h, kv = _apply(params, j, h, e, cfg, attn_impl)
            kvs.append(kv)
    with span("repro.cache.stack"):
        cache = {"ssm_layers": stack_trees(states), "attn": stack_trees(kvs)}
    return _logits(params, h[:, -1:, :], cfg, impl), cache


def hybrid_decode_step(params: Tree, cache: Tree, batch: Dict,
                       cfg: ArchConfig, *, impl: str = "xla"
                       ) -> Tuple[torch.Tensor, Tree]:
    """One decode step; every cache tensor is updated in place and the same
    cache returned."""
    ssm_impl, attn_impl = _lowerings(impl)
    hb = cfg.hybrid
    pos = int(batch["pos"])
    h = e = _embed(params, batch["tokens"], cfg)
    ssm_caches = split_layers(cache["ssm_layers"])
    attn_caches = split_layers(cache["attn"])
    for lo, layers, j in _groups(params, cfg):
        for i, lp in enumerate(layers, lo):
            out, _ = ssm_mod.ssm_decode(lp, h, ssm_caches[i], cfg,
                                        impl=ssm_impl)
            h = h + out
        if j is None:
            continue
        sp = params["shared"][j % hb.shared_attn_blocks]
        if not hb.published:
            x = rms_norm(h, sp["ln1"], cfg.norm_eps, attn_impl)
            a, _ = attn.gqa_decode(sp["attn"], x, attn_caches[j], pos, cfg)
            h = _mlp(sp, h + a, cfg, attn_impl)
            continue
        x = _zamba2_input(sp, h, e, cfg, attn_impl)
        a, _ = attn.gqa_decode(sp["attn"], x, attn_caches[j], pos, cfg,
                               scale=_scale(cfg))
        h = h + _zamba2_tail(sp, params["apps"][j], a, cfg, attn_impl)
    return _logits(params, h, cfg, impl), cache


def hybrid_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    s = cfg.ssm
    D = cfg.d_model
    H, P, N = s.n_heads(D), s.head_dim, s.d_state
    conv_dim = s.d_inner(D) + 2 * s.n_groups * s.d_state
    n_apps = len(cfg.hybrid.app_ids(cfg.num_layers))
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
        "attn": stack_defs(attn_cache, n_apps, axis_name="groups"),
    }
