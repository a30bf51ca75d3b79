"""Architecture configuration dataclasses.

Every assigned architecture is described by one frozen ``ArchConfig``.  The
model zoo (``repro_torch.models``) builds the network purely from this description;
the HAF scheduler (``repro_torch.core``) derives service-class metadata (weight
bytes, FLOPs/token) from the same object, so the simulator and the dry-run
agree on what a "service" costs.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

VOCAB_PAD_MULTIPLE = 256  # MaxText-style padding so vocab always TP-shards.


def pad_vocab(v: int, multiple: int = VOCAB_PAD_MULTIPLE) -> int:
    return ((v + multiple - 1) // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0          # per shared expert
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    first_dense_layers: int = 0   # leading dense layers (DeepSeek style)
    d_ff_dense: int = 0           # d_ff of those dense layers


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek V2/V3)."""
    q_lora_rank: int        # 0 => direct q projection (V2-Lite)
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD block parameters."""
    d_state: int
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk_size: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class HybridConfig:
    """Zamba2-style hybrid: SSM trunk + shared attention block every N layers."""
    attn_every: int = 6       # apply the shared attention block every N ssm layers
    shared_attn_blocks: int = 1  # number of distinct shared blocks (round-robin)


@dataclasses.dataclass(frozen=True)
class EncDecConfig:
    """Whisper-style encoder-decoder backbone."""
    encoder_layers: int
    encoder_frames: int = 1500   # post-conv frame count (frontend is a stub)


@dataclasses.dataclass(frozen=True)
class VLMConfig:
    """LLaVA-NeXT-style VLM backbone; vision tower is a stub."""
    num_patches: int = 576       # anyres base-res patch count (24x24)
    patch_embed_dim: int = 0     # 0 => already projected to d_model


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | ssm | hybrid | moe | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 => d_model // num_heads
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    hybrid: Optional[HybridConfig] = None
    encdec: Optional[EncDecConfig] = None
    vlm: Optional[VLMConfig] = None
    mtp: bool = False            # DeepSeek-V3 multi-token prediction head
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    # attention lowering: q-chunked block-causal attention above this seq len
    attn_chunk_threshold: int = 8192
    attn_chunk_q: int = 2048
    # scan-over-layers unroll factor (1 = one layer body looped over depth,
    # num_layers = fully unrolled); kept so configs stay field-for-field
    # interchangeable with the reference package.
    scan_unroll: int = 1
    source: str = ""             # provenance note [source; verified-tier]

    # ------------------------------------------------------------------ #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def padded_vocab(self) -> int:
        return pad_vocab(self.vocab_size)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for the long_500k cell (SSM / hybrid families)."""
        return self.family in ("ssm", "hybrid")

    # ---- analytic size/cost model (feeds HAF service classes + roofline) ---- #
    def param_count(self) -> int:
        """Analytic parameter count (exact for our construction)."""
        D, V = self.d_model, self.padded_vocab
        n = V * D                      # embedding
        if not self.tie_embeddings:
            n += V * D                 # lm head
        n += D                         # final norm
        if self.family == "ssm":
            n += self.num_layers * self._ssm_layer_params(D)
        elif self.family == "hybrid":
            n += self.num_layers * self._ssm_layer_params(D)
            n_shared = self._attn_params(D) + self._mlp_params(D, self.d_ff) + 2 * D
            n += (self.hybrid.shared_attn_blocks if self.hybrid else 1) * n_shared
        elif self.encdec is not None:
            enc = self.encdec.encoder_layers * (
                self._attn_params(D) + self._mlp_params(D, self.d_ff) + 2 * D)
            dec = self.num_layers * (
                self._attn_params(D) * 2 + self._mlp_params(D, self.d_ff) + 3 * D)
            n += enc + dec + D  # + final enc norm
        else:
            for layer in range(self.num_layers):
                n += self._attn_params(D) + 2 * D
                n += self._ffn_params_layer(layer, D)
        if self.mtp:
            n += self._attn_params(D) + self._ffn_params_layer(self.num_layers, D) \
                + 2 * D + 2 * D * D   # mtp combiner
        return int(n)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        D = self.d_model
        total = self.param_count()
        n_moe_layers = self.num_layers - m.first_dense_layers
        all_routed = n_moe_layers * m.num_experts * 3 * D * m.d_ff_expert
        active_routed = n_moe_layers * m.top_k * 3 * D * m.d_ff_expert
        return int(total - all_routed + active_routed)

    def _attn_params(self, D: int) -> int:
        hd = self.resolved_head_dim
        if self.mla is not None:
            c = self.mla
            qk_hd = c.qk_nope_head_dim + c.qk_rope_head_dim
            n = 0
            if c.q_lora_rank:
                n += D * c.q_lora_rank + c.q_lora_rank * self.num_heads * qk_hd
                n += c.q_lora_rank  # q_norm
            else:
                n += D * self.num_heads * qk_hd
            n += D * (c.kv_lora_rank + c.qk_rope_head_dim)
            n += c.kv_lora_rank  # kv_norm
            n += c.kv_lora_rank * self.num_heads * (c.qk_nope_head_dim + c.v_head_dim)
            n += self.num_heads * c.v_head_dim * D
            return n
        n = D * self.num_heads * hd + 2 * D * self.num_kv_heads * hd \
            + self.num_heads * hd * D
        if self.qkv_bias:
            n += (self.num_heads + 2 * self.num_kv_heads) * hd
        return n

    def _mlp_params(self, D: int, d_ff: int) -> int:
        return 3 * D * d_ff  # SwiGLU: gate, up, down

    def _ffn_params_layer(self, layer: int, D: int) -> int:
        if self.moe is None:
            return self._mlp_params(D, self.d_ff)
        m = self.moe
        if layer < m.first_dense_layers:
            return self._mlp_params(D, m.d_ff_dense or self.d_ff)
        n = m.num_experts * self._mlp_params(D, m.d_ff_expert)
        n += m.num_shared_experts * self._mlp_params(D, m.d_ff_shared or m.d_ff_expert)
        n += D * m.num_experts  # router
        return n

    def _ssm_layer_params(self, D: int) -> int:
        s = self.ssm
        d_in = s.d_inner(D)
        H = s.n_heads(D)
        GN = s.n_groups * s.d_state
        d_proj = 2 * d_in + 2 * GN + H
        n = D * d_proj                       # in_proj
        n += s.d_conv * (d_in + 2 * GN)      # depthwise conv
        n += H * 3                           # A_log, dt_bias, D skip
        n += d_in                            # gated norm
        n += d_in * D                        # out_proj
        n += 2 * D                           # pre-norm (+ spare)
        return n

    def flops_per_token(self, context_len: int = 0) -> float:
        """Forward FLOPs per token: 2*N_active + attention term."""
        base = 2.0 * self.active_param_count()
        if self.family == "ssm":
            s = self.ssm
            base += 2.0 * s.n_heads(self.d_model) * s.head_dim * s.d_state * 4
            return base
        hd = self.resolved_head_dim
        if self.mla is not None:
            hd = self.mla.qk_nope_head_dim + self.mla.qk_rope_head_dim
        n_attn_layers = self.num_layers
        if self.family == "hybrid":
            n_attn_layers = self.num_layers // (self.hybrid.attn_every if self.hybrid else 6)
        base += 4.0 * n_attn_layers * self.num_heads * hd * max(context_len, 1)
        return base

    def weight_bytes(self, bytes_per_param: int = 2) -> int:
        return self.param_count() * bytes_per_param

    def validate(self) -> None:
        assert self.d_model > 0 and self.num_layers > 0
        if self.family in ("ssm", "hybrid"):
            assert self.ssm is not None
            assert self.ssm.d_inner(self.d_model) % self.ssm.head_dim == 0
        if self.family == "moe":
            assert self.moe is not None
        if self.family == "audio":
            assert self.encdec is not None
        if self.mla is None and self.family not in ("ssm",):
            assert self.num_heads % self.num_kv_heads == 0
