"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Twin of the reference's ``models/ssm.py``: chunked SSD for forward / prefill
(intra-chunk quadratic form + inter-chunk linear recurrence), O(1)-state
single-token decode, the depthwise causal conv as static shifts, and the
reference's split z / x / B / C / dt projections.  ``impl="pallas"`` routes
the scan to the hand-written ``ssd_scan`` kernel, anything else to the
chunked torch form :func:`ssd_scan_ref`.

Decode writes the new SSM and conv states into the cache tensors in place
and returns them (the reference returns copies).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.models.common import ParamDef, rms_norm


def ssm_defs(cfg: ArchConfig) -> Dict[str, ParamDef]:
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.d_inner(D)
    H = s.n_heads(D)
    GN = s.n_groups * s.d_state
    return {
        "norm": ParamDef((D,), ("d_model",), init="ones"),
        "in_z": ParamDef((D, d_in), ("d_model", "d_inner")),
        "in_x": ParamDef((D, d_in), ("d_model", "d_inner")),
        "in_B": ParamDef((D, GN), ("d_model", None)),
        "in_C": ParamDef((D, GN), ("d_model", None)),
        "in_dt": ParamDef((D, H), ("d_model", "ssm_heads")),
        "conv_x": ParamDef((s.d_conv, d_in), (None, "d_inner"),
                           init="small_normal"),
        "conv_B": ParamDef((s.d_conv, GN), (None, None), init="small_normal"),
        "conv_C": ParamDef((s.d_conv, GN), (None, None), init="small_normal"),
        "conv_bias_x": ParamDef((d_in,), ("d_inner",), init="zeros"),
        "conv_bias_B": ParamDef((GN,), (None,), init="zeros"),
        "conv_bias_C": ParamDef((GN,), (None,), init="zeros"),
        "A_log": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "dt_bias": ParamDef((H,), ("ssm_heads",), init="zeros"),
        "D_skip": ParamDef((H,), ("ssm_heads",), init="ones"),
        "gate_norm": ParamDef((d_in,), ("d_inner",), init="ones"),
        "out_proj": ParamDef((d_in, D), ("d_inner", "d_model")),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as static shifts.  x [B,S,C]; w [K,C]."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(K - 1):
        shift = K - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out + b


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """dA [..., L] -> [..., L, L] lower-triangular cumulative sums (t>=s),
    -inf above the diagonal."""
    cs = torch.cumsum(dA, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]            # sum_{j=s+1..t}
    L = dA.shape[-1]
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=dA.device))
    return torch.where(mask, diff, -torch.inf)


def ssd_scan_ref(x, dt, A, B, C, chunk: int,
                 initial_state: Optional[torch.Tensor] = None,
                 impl: str = "xla"):
    """Chunked SSD.  x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n].

    Returns (y [b,s,h,p], final_state [b,h,p,n]).
    """
    if impl == "pallas":
        return kops.ssd_scan(x, dt, A, B, C, chunk, initial_state)
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc, l = s // chunk, chunk
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2)                  # [b,s,h,n]
    Ch = C.repeat_interleave(rep, dim=2)

    xc = x.reshape(b, nc, l, h, p)
    dtc = dt.reshape(b, nc, l, h)
    Bc = Bh.reshape(b, nc, l, h, n)
    Cc = Ch.reshape(b, nc, l, h, n)

    dA = dtc * A[None, None, None, :]                     # [b,nc,l,h]
    dA_cs = torch.cumsum(dA, dim=2)

    # 1) intra-chunk (diagonal blocks)
    Lmat = torch.exp(_segsum(torch.movedim(dA, -1, 2)))   # [b,nc,h,l,l]
    xdt = xc * dtc[..., None]
    Y_diag = torch.einsum("bclhn,bcshn,bchls,bcshp->bclhp", Cc, Bc, Lmat, xdt)

    # 2) per-chunk input states
    decay_states = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [b,nc,l,h]
    states = torch.einsum("bclhn,bclh,bclhp->bchpn", Bc, decay_states * dtc,
                          xc)

    # 3) inter-chunk recurrence over nc
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])           # [b,nc,h]
    carry = (torch.zeros((b, h, p, n), dtype=x.dtype, device=x.device)
             if initial_state is None else initial_state.to(x.dtype))
    prev = []
    for c in range(nc):                                   # state entering c
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)                # [b,nc,h,p,n]

    # 4) contribution of the carried state
    state_decay = torch.exp(dA_cs)                        # [b,nc,l,h]
    Y_off = torch.einsum("bclhn,bchpn,bclh->bclhp", Cc, prev_states,
                         state_decay)

    y = (Y_diag + Y_off).reshape(b, s, h, p)
    return y, carry


def _projections(p: Dict, h: torch.Tensor):
    return (torch.einsum("bsd,de->bse", h, p["in_x"]),
            torch.einsum("bsd,de->bse", h, p["in_B"]),
            torch.einsum("bsd,de->bse", h, p["in_C"]))


def ssm_forward(p: Dict, x_in: torch.Tensor, cfg: ArchConfig, *,
                return_state: bool = False, impl: str = "xla"):
    """Full Mamba2 block (pre-norm + SSD + gated out).  x_in [B,S,D]."""
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.d_inner(D)
    H = s.n_heads(D)
    P = s.head_dim

    h = rms_norm(x_in, p["norm"], cfg.norm_eps)
    z = torch.einsum("bsd,de->bse", h, p["in_z"])
    xp_pre, Bp_pre, Cp_pre = _projections(p, h)
    dt = torch.einsum("bsd,de->bse", h, p["in_dt"])

    xp = F.silu(_causal_conv(xp_pre, p["conv_x"], p["conv_bias_x"]))
    Bp = F.silu(_causal_conv(Bp_pre, p["conv_B"], p["conv_bias_B"]))
    Cp = F.silu(_causal_conv(Cp_pre, p["conv_C"], p["conv_bias_C"]))

    B, S, _ = x_in.shape
    xh = xp.reshape(B, S, H, P)
    Bm = Bp.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cp.reshape(B, S, s.n_groups, s.d_state)
    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())

    chunk = min(s.chunk_size, S)
    if S % chunk:
        chunk = S  # fall back to one chunk for odd lengths
    # dt and A are rounded to the activations' dtype before the scan
    y, state = ssd_scan_ref(xh, dt.to(xh.dtype), A.to(xh.dtype), Bm, Cm,
                            chunk, impl=impl)
    y = y + xh * p["D_skip"].to(xh.dtype)[None, None, :, None]
    y = y.reshape(B, S, d_in)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("bse,ed->bsd", y, p["out_proj"])
    if return_state:
        # the conv state keeps the *pre-activation* projection tail so decode
        # can replay the causal window exactly
        pre = torch.cat([xp_pre, Bp_pre, Cp_pre], dim=-1)
        return out, {"ssm": state, "conv": pre[:, -(s.d_conv - 1):, :]}
    return out


def ssm_decode(p: Dict, x_in: torch.Tensor, cache: Dict, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """Single-token decode.  x_in [B,1,D]; cache {"ssm": [B,H,P,N], "conv":
    [B,K-1,C]}, both overwritten in place with the new states."""
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.d_inner(D)
    H = s.n_heads(D)
    P = s.head_dim
    GN = s.n_groups * s.d_state

    h = rms_norm(x_in, p["norm"], cfg.norm_eps)
    z = torch.einsum("bsd,de->bse", h, p["in_z"])[:, 0]
    pre = torch.cat(_projections(p, h), dim=-1)[:, 0]          # [B, d_in+2GN]
    dt = torch.einsum("bsd,de->bse", h, p["in_dt"])[:, 0]      # [B,H]

    window = torch.cat([cache["conv"], pre[:, None, :]], dim=1)  # [B,K,C]
    w_full = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    b_full = torch.cat([p["conv_bias_x"], p["conv_bias_B"],
                        p["conv_bias_C"]], dim=-1)
    conv_out = F.silu(torch.einsum("bkc,kc->bc", window, w_full) + b_full)
    xp, Bp, Cp = torch.split(conv_out, [d_in, GN, GN], dim=-1)

    xh = xp.reshape(-1, H, P)
    rep = H // s.n_groups
    Bh = Bp.reshape(-1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Ch = Cp.reshape(-1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])                               # [B,H]

    st = cache["ssm"].float()
    st = st * dA[:, :, None, None] + torch.einsum(
        "bh,bhp,bhn->bhpn", dt, xh.float(), Bh.float())
    y = torch.einsum("bhpn,bhn->bhp", st, Ch.float())
    y = y + xh.float() * p["D_skip"].float()[None, :, None]
    y = y.reshape(-1, d_in).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps)
    out = torch.einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    cache["ssm"].copy_(st)
    cache["conv"].copy_(window[:, 1:, :])
    return out, cache
