"""Unified model API over every family of the zoo.

Twin of the reference's ``models/api.py``.  ``Model`` exposes:

  param_defs() / param_count() / init(gen)    — declarative params
  param_specs() / param_axes() / decay_mask() — shapes, logical axes, and
                                                which leaves AdamW decays
  loss(params, batch)                         — the training objective
  forward(params, batch)                      — full-sequence logits
  prefill(params, batch)                      — prompt -> (logits, cache)
  decode_step(params, cache, batch)           — one token -> (logits, cache)
  cache_defs(batch, seq) / cache_specs / cache_axes / init_cache /
  pad_cache
  input_specs(cell) / make_inputs(cell, gen)  — a shape cell's inputs

The serving path is ``build_model -> init -> prefill -> pad_cache ->
decode_step`` for the families ``dense``, ``ssm``, ``hybrid``, ``moe``
(with MLA), ``audio`` (encoder-decoder: ``batch["frames"]``) and ``vlm``
(``batch["patch_embeds"]`` before the tokens).  ``impl`` keeps the
reference's strings: ``"xla"`` is the eager torch composite path,
``"flash"`` sends causal self-attention to the hand-written
``flash_attention`` kernel and ``"pallas"`` sends the SSD scan to the
hand-written ``ssd_scan`` kernel; a hybrid sends both under either kernel
lowering; both kernel lowerings send every RMSNorm (of prefill, forward
and decode) to the hand-written ``rmsnorm`` kernel.
MLA attention takes the composite path under every ``impl``, as in the
reference.  ``loss`` is differentiable only under
``impl="xla"``: the kernels have no backward pass, so their wrappers refuse
tensors that require grad (the reference cannot differentiate through its
Pallas kernels either and trains on ``"xla"``).  ``remat`` is the activation
checkpointing of ``loss`` (``"none" | "dots" | "full"``, default
``"dots"``, ``common.checkpointed``); it changes memory, never values.

Entry points run on the GPU unless the caller asks for the CPU:
``build_model(..., device=None)`` means ``"cuda"`` and raises
``RuntimeError`` when no CUDA device is present.  Parameters are a dict in
which each stacked subtree of the reference (``common.STACKED``) is a list
of per-layer dicts; caches keep the reference's stacked layout (``[L, B, S,
...]`` KV tables, SSM / conv states ``[L, B, ...]``).  ``decode_step``
updates the cache in place.  Parameters, batches and caches placed on a
device mesh (``distributed.placement``, ``DTensor`` leaves) run through the
same entry points, as the reference's run under ``jit`` with
``in_shardings``.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ShapeCell, get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.models import encdec, hybrid, ssm, transformer
from repro_torch.models.common import (REMATS, STACKED, ParamDef,
                                       checkpointed, cross_entropy_loss,
                                       embed_lookup, init_params, mesh_einsum,
                                       mesh_scope, param_axes,
                                       param_count_tree, param_specs,
                                       rms_norm, scan_layers, split_layers,
                                       split_stacked, stack_defs, tree_map)
from repro_torch.obs.spans import span

Tree = Any

FAMILIES = ("dense", "ssm", "hybrid", "moe", "audio", "vlm")
IMPLS = ("xla", "flash", "pallas")


# --------------------------------------------------------------------------- #
# pure-SSM LM (mamba2)
# --------------------------------------------------------------------------- #
def _ssm_lm_defs(cfg: ArchConfig) -> Dict[str, Tree]:
    V, D = cfg.padded_vocab, cfg.d_model
    defs = {
        "embed": ParamDef((V, D), ("vocab", "d_model"), init="small_normal"),
        "final_norm": ParamDef((D,), ("d_model",), init="ones"),
        "layers": stack_defs(ssm.ssm_defs(cfg), cfg.num_layers),
    }
    if not cfg.tie_embeddings:
        defs["lm_head"] = ParamDef((D, V), ("d_model", "vocab"))
    return defs


def _ssm_lm_logits(params, h, cfg, impl):
    h = rms_norm(h, params["final_norm"], cfg.norm_eps, impl)
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return mesh_einsum("bsd,dv->bsv", h, w)


def _ssm_embed(params, tokens, cfg):
    return embed_lookup(params["embed"], tokens).to(
        getattr(torch, cfg.compute_dtype))


def _ssm_lm_forward(params, batch, cfg, impl="xla"):
    h = _ssm_embed(params, batch["tokens"], cfg)
    for lp in params["layers"]:
        h = h + ssm.ssm_forward(lp, h, cfg, impl=impl)
    return _ssm_lm_logits(params, h, cfg, impl)


def _ssm_lm_loss(params, batch, cfg, impl="xla", remat="dots"):
    """Every Mamba2 layer checkpointed whole under any ``remat`` but
    ``"none"``, as in the reference."""
    layer = checkpointed(
        lambda c, lp: c + ssm.ssm_forward(lp, c, cfg, impl=impl),
        "full" if remat != "none" else "none")
    h = _ssm_embed(params, batch["tokens"], cfg)
    for lp in params["layers"]:
        h = layer(h, lp)
    logits = _ssm_lm_logits(params, h, cfg, impl)
    return cross_entropy_loss(logits[:, :-1], batch["tokens"][:, 1:])


def _ssm_lm_prefill(params, batch, cfg, impl="xla"):
    h = _ssm_embed(params, batch["tokens"], cfg)

    def body(carry, lp):
        out, state = ssm.ssm_forward(lp, carry, cfg, return_state=True,
                                     impl=impl)
        return carry + out, state
    h, states = scan_layers(body, h, params["layers"])
    return _ssm_lm_logits(params, h[:, -1:, :], cfg, impl), {
        "layers": states}


def _ssm_lm_decode(params, cache, batch, cfg, impl="xla"):
    h = _ssm_embed(params, batch["tokens"], cfg)
    for lp, lc in zip(params["layers"], split_layers(cache["layers"])):
        out, _ = ssm.ssm_decode(lp, h, lc, cfg, impl=impl)
        h = h + out
    return _ssm_lm_logits(params, h, cfg, impl), cache


def _ssm_cache_defs(cfg: ArchConfig, batch: int, seq: int) -> Tree:
    s = cfg.ssm
    D = cfg.d_model
    H, P, N = s.n_heads(D), s.head_dim, s.d_state
    conv_dim = s.d_inner(D) + 2 * s.n_groups * s.d_state
    per_layer = {
        "ssm": ParamDef((batch, H, P, N), ("batch", "ssm_heads", None, None),
                        init="zeros"),
        "conv": ParamDef((batch, s.d_conv - 1, conv_dim),
                         ("batch", None, "d_inner"), init="zeros"),
    }
    return {"layers": stack_defs(per_layer, cfg.num_layers)}


# --------------------------------------------------------------------------- #
# unified wrapper
# --------------------------------------------------------------------------- #
def _mesh_aware(fn):
    """A compute entry point under ``common.mesh_scope``."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        with mesh_scope():
            return fn(*args, **kwargs)
    return run


def resolve_device(device) -> torch.device:
    """``None`` means CUDA; a CUDA device that is not there raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch models run on CUDA by default and no CUDA device is "
            "available; pass device='cpu' to run the plain torch path")
    return dev


@dataclasses.dataclass
class Model:
    cfg: ArchConfig
    impl: str = "xla"      # attention / SSD lowering: "xla" | "flash" | "pallas"
    device: Optional[Union[str, torch.device]] = None
    remat: str = "dots"    # activation checkpointing of loss()

    def __post_init__(self):
        if self.cfg.family not in FAMILIES:
            raise ValueError(f"{self.cfg.name}: unknown family "
                             f"{self.cfg.family!r}; families: {FAMILIES}")
        if self.impl not in IMPLS:
            raise ValueError(f"impl must be one of {IMPLS}, got {self.impl!r}")
        if self.remat not in REMATS:
            raise ValueError(f"remat must be one of {REMATS}, got "
                             f"{self.remat!r}")
        self.device = resolve_device(self.device)

    # ---- params ---- #
    def param_defs(self) -> Tree:
        f = self.cfg.family
        if f == "ssm":
            return _ssm_lm_defs(self.cfg)
        if f == "hybrid":
            return hybrid.hybrid_defs(self.cfg)
        if f == "audio":
            return encdec.encdec_defs(self.cfg)
        return transformer.lm_defs(self.cfg)

    def param_specs(self) -> Tree:
        """The reference's stacked tree of :class:`common.TensorSpec`."""
        return param_specs(self.param_defs(),
                           getattr(torch, self.cfg.param_dtype))

    def param_axes(self) -> Tree:
        """The reference's stacked tree of logical-axis tuples."""
        return param_axes(self.param_defs())

    def decay_mask(self) -> Tree:
        """Per leaf of :meth:`init`'s tree, whether AdamW decays it: as in
        the reference, a leaf of rank >= 2 *in the stacked layout*, so the
        per-layer norms ``[L, D]`` and Mamba2's ``A_log`` / ``D_skip`` /
        ``dt_bias`` ``[L, H]`` are decayed although each layer's piece here
        is 1-D."""
        defs = self.param_defs()
        out = {}
        for k, d in defs.items():
            mask = tree_map(lambda pd: len(pd.shape) >= 2, d)
            out[k] = ([mask] * _stacked_depth(d) if k in STACKED else mask)
        return out

    def init(self, gen: Union[torch.Generator, int]) -> Tree:
        """Parameters on the model's device from ``gen`` (a generator on that
        device, or an int seed for one); stacked subtrees split per layer."""
        if isinstance(gen, int):
            gen = torch.Generator(device=self.device).manual_seed(gen)
        return split_stacked(init_params(
            self.param_defs(), gen, getattr(torch, self.cfg.param_dtype),
            self.device))

    def param_count(self) -> int:
        return param_count_tree(self.param_defs())

    # ---- compute ---- #
    @_mesh_aware
    def loss(self, params: Tree, batch: Dict) -> torch.Tensor:
        """The training objective (a float32 scalar): next-token cross
        entropy, plus the MoE aux and MTP losses where configured."""
        f = self.cfg.family
        if f == "ssm":
            return _ssm_lm_loss(params, batch, self.cfg, self.impl,
                                self.remat)
        if f == "hybrid":
            return hybrid.hybrid_loss(params, batch, self.cfg,
                                      impl=self.impl, remat=self.remat)
        if f == "audio":
            return encdec.encdec_loss(params, batch, self.cfg,
                                      impl=self.impl, remat=self.remat)
        return transformer.lm_loss(params, batch, self.cfg, impl=self.impl,
                                   remat=self.remat)

    @_mesh_aware
    def forward(self, params: Tree, batch: Dict) -> torch.Tensor:
        f = self.cfg.family
        if f == "ssm":
            return _ssm_lm_forward(params, batch, self.cfg, self.impl)
        if f == "hybrid":
            return hybrid.hybrid_forward(params, batch, self.cfg,
                                         impl=self.impl)
        if f == "audio":
            return encdec.encdec_forward(params, batch, self.cfg,
                                         impl=self.impl)
        return transformer.lm_forward(params, batch, self.cfg,
                                      impl=self.impl)

    @_mesh_aware
    def prefill(self, params: Tree, batch: Dict) -> Tuple[torch.Tensor, Tree]:
        f = self.cfg.family
        with span("repro.prefill"):
            if f == "ssm":
                return _ssm_lm_prefill(params, batch, self.cfg, self.impl)
            if f == "hybrid":
                return hybrid.hybrid_prefill(params, batch, self.cfg,
                                             impl=self.impl)
            if f == "audio":
                return encdec.encdec_prefill(params, batch, self.cfg,
                                             impl=self.impl)
            return transformer.lm_prefill(params, batch, self.cfg,
                                          impl=self.impl)

    @_mesh_aware
    def decode_step(self, params: Tree, cache: Tree, batch: Dict
                    ) -> Tuple[torch.Tensor, Tree]:
        f = self.cfg.family
        if f == "ssm":
            return _ssm_lm_decode(params, cache, batch, self.cfg, self.impl)
        if f == "hybrid":
            return hybrid.hybrid_decode_step(params, cache, batch, self.cfg,
                                             impl=self.impl)
        if f == "audio":
            return encdec.encdec_decode_step(params, cache, batch, self.cfg,
                                             impl=self.impl)
        return transformer.lm_decode_step(params, cache, batch, self.cfg,
                                          impl=self.impl)

    # ---- caches ---- #
    def cache_defs(self, batch: int, seq: int) -> Tree:
        f = self.cfg.family
        if f == "ssm":
            return _ssm_cache_defs(self.cfg, batch, seq)
        if f == "hybrid":
            return hybrid.hybrid_cache_defs(self.cfg, batch, seq)
        if f == "audio":
            return encdec.encdec_cache_defs(self.cfg, batch, seq)
        return transformer.lm_cache_defs(self.cfg, batch, seq)

    def cache_specs(self, batch: int, seq: int) -> Tree:
        return param_specs(self.cache_defs(batch, seq),
                           getattr(torch, self.cfg.compute_dtype))

    def cache_axes(self, batch: int, seq: int) -> Tree:
        return param_axes(self.cache_defs(batch, seq))

    def init_cache(self, batch: int, seq: int) -> Tree:
        return tree_map(
            lambda d: torch.zeros(d.shape, device=self.device,
                                  dtype=getattr(torch, self.cfg.compute_dtype)),
            self.cache_defs(batch, seq))

    def pad_cache(self, cache: Tree, max_len: int) -> Tree:
        """Pad prefill KV tables along the sequence axis (axis 2 of the
        stacked ``[L, B, S, ...]`` layout) to ``max_len``.  Recurrent (SSM /
        conv) states and the encoder's cross keys and values are fixed-size
        and pass through untouched."""
        def pad_seq(tree):
            def one(x):
                if max_len <= x.shape[2]:
                    return x
                out = x.new_zeros(x.shape[:2] + (max_len,) + x.shape[3:])
                out[:, :, :x.shape[2]] = x
                return out
            return tree_map(one, tree)

        f = self.cfg.family
        if f == "ssm":
            return cache
        if f == "hybrid":
            return {"ssm_layers": cache["ssm_layers"],
                    "attn": pad_seq(cache["attn"])}
        if f == "audio":
            return {"self": pad_seq(cache["self"]), "cross": cache["cross"]}
        return pad_seq(cache)

    # ---- inputs ---- #
    def input_specs(self, cell: ShapeCell) -> Dict[str, Tuple]:
        """``{name: (shape, dtype)}`` of every model input of this cell: a
        decode step's ``tokens [B, 1]`` and ``pos``; else ``tokens [B, S]``,
        with ``frames [B, T, D]`` (audio) or, for a VLM, ``patch_embeds [B,
        P, D]`` and ``S - P`` tokens."""
        cfg = self.cfg
        B, S = cell.global_batch, cell.seq_len
        cd = getattr(torch, cfg.compute_dtype)
        if cell.kind == "decode":
            return {"tokens": ((B, 1), torch.long), "pos": ((), torch.long)}
        if cfg.family == "audio":
            return {"frames": ((B, cfg.encdec.encoder_frames, cfg.d_model),
                               cd),
                    "tokens": ((B, S), torch.long)}
        if cfg.family == "vlm":
            P = cfg.vlm.num_patches
            return {"patch_embeds": ((B, P, cfg.d_model), cd),
                    "tokens": ((B, S - P), torch.long)}
        return {"tokens": ((B, S), torch.long)}

    def make_inputs(self, cell: ShapeCell, gen: torch.Generator
                    ) -> Dict[str, torch.Tensor]:
        """Random inputs of :meth:`input_specs`' shapes on the model's
        device, drawn from ``gen`` (a generator on that device) in the specs'
        order: tokens uniform in the vocabulary, embeddings standard normal,
        ``pos`` 0."""
        out = {}
        for k, (shape, dtype) in self.input_specs(cell).items():
            if dtype == torch.long and shape:
                out[k] = torch.randint(0, self.cfg.vocab_size, shape,
                                       generator=gen, device=self.device)
            elif dtype == torch.long:
                out[k] = torch.zeros((), dtype=dtype, device=self.device)
            else:
                out[k] = torch.randn(shape, generator=gen, device=self.device
                                     ).to(dtype)
        return out


def _stacked_depth(stacked_defs: Tree) -> int:
    """The leading (stacked) dimension of a stacked ParamDef subtree."""
    leaf = stacked_defs
    while isinstance(leaf, dict):
        leaf = next(iter(leaf.values()))
    return leaf.shape[0]


def build_model(name_or_cfg, impl: str = "xla", device=None,
                remat: str = "dots") -> Model:
    cfg = name_or_cfg if isinstance(name_or_cfg, ArchConfig) else \
        get_config(name_or_cfg)
    return Model(cfg, impl=impl, device=device, remat=remat)
