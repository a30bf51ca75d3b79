"""Plain float32 building blocks of the references.

Written from the model equations, in eager PyTorch, with no kernel, cache or
batching of the program: RMSNorm with float32 statistics, rotary embeddings
over the two halves of a head, SwiGLU, and grouped-query causal attention in
blocks of query rows.  Weights are read in the layout the benchmark made
them in (``[d_in, d_out]`` products, ``[D, heads, head_dim]`` attention
projections) and taken to float32 one matrix at a time, so that a reference
of a 7B model fits beside the served weights.

``quant``, where given, is applied to both operands of every weight product
(the activation along its rows, the weight along its input dim): the control
that computes the reference one precision below the configuration's.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F

Quant = Optional[Callable[[torch.Tensor, int], torch.Tensor]]

# rows of a position-wise product computed at once: bounds the float32
# transients of a 32k-position MLP (4096 rows x d_ff 14336 x 4 B = 235 MB)
ROW_BLOCK = 4096
# query rows of one attention block: [heads, 512, S] float32 scores, 2.1 GB
# at 32 heads and S = 32768
QUERY_BLOCK = 512
FP8_MAX = 448.0


@contextlib.contextmanager
def exact_float32():
    """Float32 products computed in float32: TF32 off for cuBLAS and cuDNN
    (PyTorch may round float32 products to TF32 on an H100)."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])


def fp8_e4m3(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to float8 e4m3 with one scale per slice along ``dim``
    (the amax of the slice maps to 448), returned in float32."""
    amax = t.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def linear(x: torch.Tensor, w: torch.Tensor, quant: Quant = None
           ) -> torch.Tensor:
    """``x [..., d_in] @ w [d_in, d_out]`` in float32, rows in blocks."""
    w = w.float()
    if quant is not None:
        w = quant(w, 0)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = torch.empty((x2.shape[0], w.shape[1]), dtype=torch.float32,
                      device=x.device)
    for lo in range(0, x2.shape[0], ROW_BLOCK):
        xb = x2[lo:lo + ROW_BLOCK]
        if quant is not None:
            xb = quant(xb, -1)
        out[lo:lo + ROW_BLOCK] = xb @ w
    return out.reshape(*lead, w.shape[1])


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) \
        * w.float()


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x [B, S, heads, hd]`` at positions 0..S-1:
    the first and second halves of each head rotate as a pair."""
    hd = x.shape[-1]
    inv = 1.0 / theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                       device=x.device) / hd)
    ang = torch.arange(x.shape[1], dtype=torch.float32,
                       device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                     ) -> torch.Tensor:
    """softmax(q kᵀ / sqrt(hd), causal) v for q ``[B, S, H, hd]`` and k, v
    ``[B, S, KV, hd]``; query head ``h`` reads key head ``h // (H / KV)``."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, hd)
    out = torch.empty_like(q)
    scale = 1.0 / math.sqrt(hd)
    pos = torch.arange(S, device=q.device)
    for lo in range(0, S, QUERY_BLOCK):
        hi = min(S, lo + QUERY_BLOCK)
        s = torch.einsum("bqkgd,bskd->bkgqs", qg[:, lo:hi], k[:, :hi])
        s.mul_(scale)
        s.masked_fill_(pos[lo:hi, None] < pos[None, :hi], -math.inf)
        p = torch.softmax(s, dim=-1)
        out[:, lo:hi] = torch.einsum("bkgqs,bskd->bqkgd", p, v[:, :hi]
                                     ).reshape(B, hi - lo, H, hd)
    return out


def swiglu(x: torch.Tensor, mlp: dict, quant: Quant = None) -> torch.Tensor:
    """down(silu(x gate) * (x up)), rows in blocks."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    out = torch.empty_like(x2)
    for lo in range(0, x2.shape[0], ROW_BLOCK):
        xb = x2[lo:lo + ROW_BLOCK]
        hb = F.silu(linear(xb, mlp["gate"], quant)) * linear(xb, mlp["up"],
                                                              quant)
        out[lo:lo + ROW_BLOCK] = linear(hb, mlp["down"], quant)
    return out.reshape(*lead, x.shape[-1])


def gqa(p: dict, x: torch.Tensor, heads: int, kv_heads: int, head_dim: int,
        theta: float, quant: Quant = None):
    """Causal self-attention of ``x [B, S, D]`` with rotary positions;
    returns (output [B, S, D], k, v [B, S, KV, hd] as a cache holds them)."""
    B, S, D = x.shape
    q = linear(x, p["wq"].reshape(D, heads * head_dim), quant)
    k = linear(x, p["wk"].reshape(D, kv_heads * head_dim), quant)
    v = linear(x, p["wv"].reshape(D, kv_heads * head_dim), quant)
    q = rope(q.reshape(B, S, heads, head_dim), theta)
    k = rope(k.reshape(B, S, kv_heads, head_dim), theta)
    v = v.reshape(B, S, kv_heads, head_dim)
    o = causal_attention(q, k, v).reshape(B, S, heads * head_dim)
    return linear(o, p["wo"].reshape(heads * head_dim, D), quant), k, v
