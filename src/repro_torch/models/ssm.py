"""Mamba2 / SSD (state-space duality) block — arXiv:2405.21060.

Twin of the reference's ``models/ssm.py``: chunked SSD for forward / prefill
(intra-chunk quadratic form + inter-chunk linear recurrence), O(1)-state
single-token decode, the depthwise causal conv with its SiLU, and the
reference's split z / x / B / C / dt projections.  ``impl="pallas"`` routes
the scan to the hand-written ``ssd_scan`` kernel, anything else to the
chunked torch form :func:`ssd_scan_ref`.  A prefill's convolutions follow
the kernel lowerings as the norms do: ``impl="xla"`` runs the reference's
static shifts (``kref.causal_conv_ref``) and the SiLU as eager ops,
``"flash"`` / ``"pallas"`` the hand-written ``causal_conv_silu`` kernel,
one launch for each of x, B and C.  The gated norm normalises each
of the ``n_groups`` parts of d_inner on its own (Mamba2's
``RMSNormGated``; one part, the reference's whole-width norm, at
``n_groups`` 1).

A prefill's mixer runs under the span ``repro.ssm``, with
``repro.ssm.in_proj``, ``.conv``, ``.scan``, ``.gate_norm`` and
``.out_proj`` inside it; a scan that takes the one-chunk fallback (a
length the chunk does not divide) runs under ``repro.ssm.scan.whole`` in
place of ``repro.ssm.scan``, so a trace counts them.

Decode writes the new SSM and conv states into the cache tensors in place
and returns them (the reference returns copies).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.common import (ParamDef, batch_extent, layout,
                                       mesh_einsum, model_extent, placed_on,
                                       rms_norm, shard_as, shard_batch)
from repro_torch.obs.spans import span


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
    """Depthwise causal conv as static shifts.  x [B,S,C]; w [K,C].  On a
    device mesh each rank convolves its own rows and channels (DTensor's
    ``pad`` has no plan for every layout in every release)."""
    if isinstance(x, DTensor):
        return _conv_on_shards(x, w, b, _causal_conv)
    return kref.causal_conv_ref(x, w, b)


def _conv_silu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               impl: str) -> torch.Tensor:
    """``silu`` of the causal conv: the composite under ``impl="xla"``, one
    ``causal_conv_silu`` launch under a kernel lowering (each rank's on its
    own rows and channels on a device mesh)."""
    if impl == "xla":
        return F.silu(_causal_conv(x, w, b))
    if isinstance(x, DTensor):
        return _conv_on_shards(x, w, b, kops.causal_conv_silu)
    return kops.causal_conv_silu(x, w, b)


def _conv_on_shards(x: DTensor, w: DTensor, b: DTensor, conv) -> DTensor:
    """``conv`` of each rank's rows and channels of ``x``."""
    x = shard_as(x, 0, 2)
    mesh = x.device_mesh
    rows = placed_on(x, "data") or Replicate()
    chans = isinstance(placed_on(x, "model"), Shard)
    grad = Partial() if isinstance(rows, Shard) else Replicate()

    def local(t, dim):
        on = Shard(dim) if chans else Replicate()
        return t.redistribute(mesh, layout(mesh, Replicate(), on)).to_local(
            grad_placements=layout(mesh, grad, on))
    return DTensor.from_local(
        conv(x.to_local(), local(w, 1), local(b, 0)), mesh,
        x.placements, run_check=False)


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
    if isinstance(x, DTensor):
        return _ssd_on_shards(x, dt, A, B, C, chunk, initial_state, impl)
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


def _ssd_on_shards(x, dt, A, B, C, chunk, initial_state, impl):
    """:func:`ssd_scan_ref` on a device mesh: the scan is independent per
    batch row and head, so each rank scans its own rows and heads (heads
    over ``model`` where they, and the B / C groups, divide it; B / C
    replicated there for one group) and the results are its shards.
    Left to DTensor's propagation the scan's batched products plan
    redistributions for minutes on a three-dim mesh."""
    mesh = x.device_mesh
    n = model_extent(mesh)
    g = B.shape[2]
    heads = x.shape[2] % n == 0 and (g == 1 or g % n == 0)
    rows = x.shape[0] % batch_extent(mesh) == 0
    rep = Replicate()
    b_pl = Shard(0) if rows else rep

    def on(dim):
        return Shard(dim) if heads and dim is not None else rep

    def local(t, pl, grad):
        return t.redistribute(mesh, pl).to_local(grad_placements=grad)
    bc = 2 if g > 1 else None
    xl, dtl = (local(t, layout(mesh, b_pl, on(2)), layout(mesh, b_pl, on(2)))
               for t in (x, dt))
    Al = local(A, layout(mesh, rep, on(0)),
               layout(mesh, Partial() if rows else rep, on(0)))
    Bl, Cl = (local(t, layout(mesh, b_pl, on(bc)),
                    layout(mesh, b_pl, on(bc) if bc or not heads
                           else Partial()))
              for t in (B, C))
    y, state = ssd_scan_ref(xl, dtl, Al, Bl, Cl, chunk, initial_state, impl)
    return (DTensor.from_local(y, mesh, layout(mesh, b_pl, on(2)),
                               run_check=False),
            DTensor.from_local(state, mesh, layout(mesh, b_pl, on(1)),
                               run_check=False))


def _state_step(st, dA, dt, xh, Bh, Ch):
    """One token's recurrence, per batch row and head: st [B,H,P,N] decayed
    by dA [B,H] plus dt [B,H] × xh [B,H,P] ⊗ Bh [B,H,N]; returns (the new
    state, its read-out by Ch [B,H,N]).  On a device mesh each rank steps
    its own rows and heads (heads over ``model`` where they divide it)."""
    if isinstance(st, DTensor):
        mesh = st.device_mesh
        head = 1 if st.shape[1] % model_extent(mesh) == 0 else None
        args = [shard_as(t, 0, head) for t in (st, dA, dt, xh, Bh, Ch)]
        pl = args[0].placements
        new, y = _state_step(*(t.to_local() for t in args))
        return (DTensor.from_local(new, mesh, pl, run_check=False),
                DTensor.from_local(y, mesh, pl, run_check=False))
    st = st * dA[:, :, None, None] + torch.einsum("bh,bhp,bhn->bhpn", dt, xh,
                                                  Bh)
    return st, torch.einsum("bhpn,bhn->bhp", st, Ch)


def _heads_ready(t: torch.Tensor, heads: int) -> torch.Tensor:
    """On a device mesh, ``t [..., heads * head_dim]`` sharded over
    ``model`` on its last dim only where the heads divide it, so that the
    view to ``[..., heads, head_dim]`` never splits a head; batch-sharded.
    Plain tensors pass through."""
    if not isinstance(t, DTensor):
        return t
    return shard_as(t, 0, t.dim() - 1 if heads % model_extent(t.device_mesh)
                    == 0 else None)


def _projections(p: Dict, h: torch.Tensor):
    return (mesh_einsum("bsd,de->bse", h, p["in_x"]),
            mesh_einsum("bsd,de->bse", h, p["in_B"]),
            mesh_einsum("bsd,de->bse", h, p["in_C"]))


def ssm_forward(p: Dict, x_in: torch.Tensor, cfg: ArchConfig, *,
                return_state: bool = False, impl: str = "xla"):
    """Full Mamba2 block (pre-norm + SSD + gated out).  x_in [B,S,D]."""
    with span("repro.ssm"):
        return _ssm_forward(p, x_in, cfg, return_state, impl)


def _ssm_forward(p, x_in, cfg, return_state, impl):
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.d_inner(D)
    H = s.n_heads(D)
    P = s.head_dim

    h = rms_norm(x_in, p["norm"], cfg.norm_eps, impl)
    with span("repro.ssm.in_proj"):
        z = mesh_einsum("bsd,de->bse", h, p["in_z"])
        xp_pre, Bp_pre, Cp_pre = _projections(p, h)
        dt = mesh_einsum("bsd,de->bse", h, p["in_dt"])

    with span("repro.ssm.conv"):
        xp = _conv_silu(xp_pre, p["conv_x"], p["conv_bias_x"], impl)
        Bp = _conv_silu(Bp_pre, p["conv_B"], p["conv_bias_B"], impl)
        Cp = _conv_silu(Cp_pre, p["conv_C"], p["conv_bias_C"], impl)

    B, S, _ = x_in.shape
    xh = _heads_ready(xp, H).reshape(B, S, H, P)
    Bm = Bp.reshape(B, S, s.n_groups, s.d_state)
    Cm = Cp.reshape(B, S, s.n_groups, s.d_state)
    chunk = min(s.chunk_size, S)
    whole = S % chunk != 0
    if whole:
        chunk = S  # fall back to one chunk for odd lengths
    with span("repro.ssm.scan.whole" if whole else "repro.ssm.scan"):
        dt = F.softplus(dt.float() + p["dt_bias"].float())
        A = -torch.exp(p["A_log"].float())
        # dt and A are rounded to the activations' dtype before the scan
        y, state = ssd_scan_ref(xh, dt.to(xh.dtype), A.to(xh.dtype), Bm, Cm,
                                chunk, impl=impl)
        y = y + xh * p["D_skip"].to(xh.dtype)[None, None, :, None]
    # on a mesh, d_inner over "model" as z is: the gradient then comes back
    # whole to the heads view (torch 2.11 will not split a sharded dim there)
    y = shard_as(y.reshape(B, S, d_in), 0, 2)
    with span("repro.ssm.gate_norm"):
        y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, impl,
                     s.n_groups)
    with span("repro.ssm.out_proj"):
        out = shard_batch(mesh_einsum("bse,ed->bsd", y, p["out_proj"]))
    if return_state:
        # the conv state keeps the *pre-activation* projection tail so decode
        # can replay the causal window exactly; the tails are copied alone
        # (a view of the whole projections would hold them as long as the
        # cache: 81 layers x 243 MB at zamba2-7b's 4 x 4096)
        tail = -(s.d_conv - 1)
        pre = torch.cat([xp_pre[:, tail:], Bp_pre[:, tail:], Cp_pre[:, tail:]],
                        dim=-1)
        return out, {"ssm": state, "conv": pre}
    return out


def ssm_decode(p: Dict, x_in: torch.Tensor, cache: Dict, cfg: ArchConfig,
               *, impl: str = "xla") -> Tuple[torch.Tensor, Dict]:
    """Single-token decode.  x_in [B,1,D]; cache {"ssm": [B,H,P,N], "conv":
    [B,K-1,C]}, both overwritten in place with the new states."""
    s = cfg.ssm
    D = cfg.d_model
    d_in = s.d_inner(D)
    H = s.n_heads(D)
    P = s.head_dim
    GN = s.n_groups * s.d_state

    h = rms_norm(x_in, p["norm"], cfg.norm_eps, impl)
    z = mesh_einsum("bsd,de->bse", h, p["in_z"])[:, 0]
    pre = torch.cat(_projections(p, h), dim=-1)[:, 0]          # [B, d_in+2GN]
    dt = mesh_einsum("bsd,de->bse", h, p["in_dt"])[:, 0]      # [B,H]

    window = torch.cat([cache["conv"], pre[:, None, :]], dim=1)  # [B,K,C]
    w_full = torch.cat([p["conv_x"], p["conv_B"], p["conv_C"]], dim=-1)
    b_full = torch.cat([p["conv_bias_x"], p["conv_bias_B"],
                        p["conv_bias_C"]], dim=-1)
    conv_out = F.silu(mesh_einsum("bkc,kc->bc", window, w_full) + b_full)
    xp, Bp, Cp = torch.split(conv_out, [d_in, GN, GN], dim=-1)

    xh = _heads_ready(xp, H).reshape(-1, H, P)
    rep = H // s.n_groups
    Bh = Bp.reshape(-1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)
    Ch = Cp.reshape(-1, s.n_groups, s.d_state).repeat_interleave(rep, dim=1)

    dt = F.softplus(dt.float() + p["dt_bias"].float())
    A = -torch.exp(p["A_log"].float())
    dA = torch.exp(dt * A[None, :])                               # [B,H]

    st, y = _state_step(cache["ssm"].float(), dA, dt, xh.float(),
                        Bh.float(), Ch.float())
    y = y + xh.float() * p["D_skip"].float()[None, :, None]
    y = y.reshape(-1, d_in).to(x_in.dtype)
    y = rms_norm(y * F.silu(z), p["gate_norm"], cfg.norm_eps, impl,
                 s.n_groups)
    out = mesh_einsum("be,ed->bd", y, p["out_proj"])[:, None, :]
    cache["ssm"].copy_(st)
    cache["conv"].copy_(window[:, 1:, :])
    return out, cache
