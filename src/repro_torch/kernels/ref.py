"""Plain torch versions of the hand-written kernels (and of the solo pair).

These are the expressions of the reference's ``kernels/event_core.py``
(``next_completion``, ``advance``, ``event_step``), of
``core/allocator.solve_resource`` vectorised over rows, and of the
reference's model-kernel oracles in ``kernels/ref.py`` (``attention_ref``,
``ssd_scan_sequential_ref``, ``rmsnorm_ref``), written as eager tensor code,
and of Mamba2's causal convolution as the reference's ``models/ssm.py``
writes it (``causal_conv_ref``, ``causal_conv_silu_ref``).
They run on whatever device their inputs lie on; the CPU tests and the eager
``"torch"`` engine use them, and the CUDA kernels are held against them on
the card.

The event functions are float64 by contract: the event schedule is a chain
of IEEE-754 double divisions, and float32 desyncs the engines within a
handful of events.  Every product is rounded before it is subtracted
(eager torch does not contract multiply-adds), so on float64 inputs
:func:`event_step_ref` reproduces the numpy batched core bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

EPS = 1e-9


def _stage_time(rem: torch.Tensor, rate: torch.Tensor) -> torch.Tensor:
    """``rem / rate`` where a stage is pending, else 0.  A pending stage
    with zero rate divides to +inf (never NaN: 0/0 lanes are replaced by 0
    before anything reads them) and can never win the completion min."""
    return torch.where(rem > 0.0, rem / rate, torch.zeros_like(rem))


# Row minima are ``torch.amin``, not ``torch.min(dim=...)``: on the CPU the
# latter enters an OpenMP region even for a [B, S] block of a few dozen
# lanes, whose spinning threads slow a busy host's every tick ~1000-fold.


def first_index_of(cand: torch.Tensor, value: torch.Tensor) -> torch.Tensor:
    """First index along the last axis where ``cand == value`` —
    ``np.argmin``'s tie-break, which ``torch.argmin`` does not promise."""
    S = cand.shape[-1]
    lane = torch.arange(S, device=cand.device)
    hit = torch.where(cand == value.unsqueeze(-1), lane, S)
    return torch.amin(hit, dim=-1)


def next_completion_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                        alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                        avail: torch.Tensor, t: float
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Earliest head completion under GPU-then-CPU stage ordering over
    ``[S]`` vectors.  Returns ``(t_next, sid)``; ``t_next`` is +inf when
    nothing can complete (``sid`` is then 0, the first index)."""
    cand = t + (_stage_time(rem_g, alloc_g) + _stage_time(rem_c, alloc_c))
    cand = torch.where(avail, cand, torch.full_like(cand, torch.inf))
    t_next = torch.amin(cand, dim=0)
    sid = first_index_of(cand, t_next)
    return t_next, sid


def advance_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                act: torch.Tensor, dt
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Progress served heads by ``dt`` without crossing the GPU->CPU stage
    boundary; a stalled GPU stage freezes its head.  ``dt`` is a float or a
    tensor that broadcasts against the residuals.  Returns
    ``(rem_g', rem_c', started)``."""
    zero = torch.zeros_like(rem_g)
    dt = torch.as_tensor(dt, dtype=rem_g.dtype, device=rem_g.device)
    gpu_need = rem_g > 0.0
    run_g = act & gpu_need & (alloc_g > 0.0) & (dt > 0.0)
    stalled = act & gpu_need & (alloc_g <= 0.0)
    tg = torch.where(run_g, torch.minimum(dt, rem_g / alloc_g), zero)
    rg_new = rem_g - torch.where(run_g, alloc_g * tg, zero)
    rem_dt = torch.where(run_g, dt - tg, dt + zero)
    cpu_ok = (act & ~stalled & (rg_new <= 0.0) & (rem_dt > 0.0)
              & (rem_c > 0.0) & (alloc_c > 0.0))
    tc = torch.where(cpu_ok, torch.minimum(rem_dt, rem_c / alloc_c), zero)
    rc_new = rem_c - torch.where(cpu_ok, alloc_c * tc, zero)
    return rg_new, rc_new, run_g | cpu_ok


def event_step_ref(rem_g: torch.Tensor, rem_c: torch.Tensor,
                   alloc_g: torch.Tensor, alloc_c: torch.Tensor,
                   avail: torch.Tensor, t: torch.Tensor, t_ev: torch.Tensor,
                   live: torch.Tensor):
    """Fused batched step over ``[B, S]`` blocks: per-row completion scan +
    advance-to-next-event with per-replica clocks ``t[b]`` and heap heads
    ``t_ev[b]``; rows with ``live[b]`` down advance by ``dt = 0``.

    Returns ``(rem_g', rem_c', started [B,S] bool, t_comp [B], sid [B]
    int32)`` — the contract of the ``event_step`` kernel.
    """
    t_col = t[:, None]
    cand = t_col + (_stage_time(rem_g, alloc_g) + _stage_time(rem_c, alloc_c))
    cand = torch.where(avail, cand, torch.full_like(cand, torch.inf))
    t_comp = torch.amin(cand, dim=1)
    sid = first_index_of(cand, t_comp).to(torch.int32)

    t_next = torch.minimum(t_comp, t_ev)
    dt = torch.where(live & torch.isfinite(t_next), t_next - t,
                     torch.zeros_like(t))
    rg_new, rc_new, started = advance_ref(rem_g, rem_c, alloc_g, alloc_c,
                                          avail, dt[:, None])
    return rg_new, rc_new, started, t_comp, sid


def _active_set(psi, omega, floors, capacity, mask):
    """The Eq. 17-19 fixed point; returns ``(alloc, feasible, pinned,
    rounds [N])`` where ``rounds[n]`` counts the rounds row ``n`` needed:
    those that pinned something new in it, plus the one that found it
    settled."""
    S = psi.shape[-1]
    zero = torch.zeros_like(psi)
    mask = mask.to(torch.bool)
    cap = capacity.to(psi.dtype)[:, None]
    psi = torch.where(mask, psi.clamp_min(0.0), zero)
    omega = torch.where(mask, omega.to(psi.dtype).clamp_min(0.0), zero)
    floors = torch.where(mask, floors.to(psi.dtype).clamp_min(0.0), zero)

    w = torch.sqrt(omega * psi)                                   # Eq. 17
    floor_sum = floors.sum(dim=1, keepdim=True)
    feasible = floor_sum <= cap + 1e-6
    # infeasible floors degrade gracefully: scaled down to fit the node
    scale = torch.where(feasible, torch.ones_like(cap),
                        cap / floor_sum.clamp_min(EPS))
    floors_eff = floors * scale

    def shares(pinned):
        rem = cap - torch.where(pinned, floors_eff, zero).sum(1, keepdim=True)
        denom = torch.where(pinned, zero, w).sum(1, keepdim=True)
        return w * rem.clamp_min(0.0) / denom.clamp_min(EPS)      # Eq. 18-19

    pinned = w <= 0.0        # zero weight can never exceed its floor
    rounds = torch.ones(psi.shape[0], dtype=torch.int64, device=psi.device)
    for _ in range(S):
        grown = pinned | (shares(pinned) < floors_eff)
        grew = (grown != pinned).any(dim=1)
        if not bool(grew.any()):
            break
        rounds += grew
        pinned = grown
    alloc = torch.where(pinned, floors_eff, shares(pinned))
    alloc = torch.where(mask, alloc, zero)
    return alloc, feasible[:, 0], pinned & mask, rounds


def alloc_active_set_ref(psi: torch.Tensor, omega: torch.Tensor,
                         floors: torch.Tensor, capacity: torch.Tensor,
                         mask: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``[N, S]`` closed-form active-set allocation (Eq. 17-19), one
    (node, resource) problem per row; ``capacity`` is ``[N]``.  The dtype
    follows ``psi``.  Returns ``(alloc [N,S], feasible [N] bool, pinned
    [N,S] bool)``.

    The pinned set only grows, so iterating until a round pins nothing new
    gives what the reference's fixed S rounds give.
    """
    return _active_set(psi, omega, floors, capacity, mask)[:3]


def alloc_active_set_rounds(psi: torch.Tensor, omega: torch.Tensor,
                            floors: torch.Tensor, capacity: torch.Tensor,
                            mask: torch.Tensor) -> torch.Tensor:
    """Fixed-point rounds each row of this data needs (``[N]`` int64) —
    the data-dependent part of the solve's operation count."""
    return _active_set(psi, omega, floors, capacity, mask)[3]


# --------------------------------------------------------------------------- #
# model kernels: the reference's oracles (src/repro/kernels/ref.py)
# --------------------------------------------------------------------------- #
def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale=None) -> torch.Tensor:
    """q [B,S,H,d]; k,v [B,S,KV,d] -> [B,S,H,d].  fp32 softmax of the
    scores times ``scale`` (``1 / sqrt(d)`` unless given); grouped heads by
    reshape, never by repeating k / v."""
    B, S, H, d = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, d)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k).float()
    scores = scores / math.sqrt(d) if scale is None else scores * scale
    if causal:
        pos = torch.arange(S, device=q.device)
        mask = pos[:, None] >= pos[None, :]
        scores = scores.masked_fill(~mask, -torch.inf)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd", probs.to(v.dtype), v)
    return out.reshape(B, S, H, d)


def ssd_scan_sequential_ref(x: torch.Tensor, dt: torch.Tensor,
                            A: torch.Tensor, B: torch.Tensor, C: torch.Tensor,
                            initial_state: Optional[torch.Tensor] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n] -> (y, final_state).

    h_t = h_{t-1} * exp(dt_t A) + dt_t * x_t (x) B_t ;  y_t = h_t . C_t —
    sequential over s, in float32; ``y`` and the state come back in ``x``'s
    dtype.  The oracle for the chunked forms (a different algorithm).
    """
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    Bh = B.repeat_interleave(rep, dim=2).float()            # [b,s,h,n]
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()
    # repro: allow(float-dtype): the SSD oracle carries its state in f32,
    # as the kernel does; it is on no f64 event-schedule path
    state = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
             if initial_state is None else initial_state.float())
    ys = []
    for t in range(s):
        decay = torch.exp(dtf[:, t] * Af[None, :])            # [b,h]
        state = state * decay[:, :, None, None] + torch.einsum(
            "bh,bhp,bhn->bhpn", dtf[:, t], xf[:, t], Bh[:, t])
        ys.append(torch.einsum("bhpn,bhn->bhp", state, Ch[:, t]))
    y = torch.stack(ys, dim=1).to(x.dtype)
    return y, state.to(x.dtype)


def ssd_scan_chunked_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                         B: torch.Tensor, C: torch.Tensor, chunk: int,
                         bf16_points: bool = False, bf16_pairs: bool = True
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [b,s,h,p]; dt [b,s,h]; A [h]; B,C [b,s,g,n] -> (y, final_state),
    by the SSD state-passing decomposition (arXiv:2405.21060 §6) in float32,
    chunk by chunk (the last chunk may be shorter):

    (i)   csum = cumsum(dt A) over the chunk, total = its last value, and the
          chunk's own state ``delta = sum_t w_t (x) B_t`` with
          ``w_t = exp(total - csum_t) dt_t x_t``;
    (ii)  state passing: ``in_{c+1} = exp(total_c) in_c + delta_c``;
    (iii) ``y = ((C B^T) * L)(dt x) + exp(csum) (C in_c^T)`` with
          ``L = exp(csum_t - csum_s)`` on and below the diagonal, 0 above
          it (never evaluated there).

    ``bf16_points=True`` rounds where the bf16 tensor-core kernel
    (``csrc/ssd_scan.cu``) rounds: it multiplies ``w``, the masked scores
    with ``dt`` folded in, ``M' = ((C B^T) * L) dt_s``, and ``in_c`` as
    pairs of bfloat16 (``hi = bf16(v)``, ``lo = bf16(v - hi)``) with ``B``,
    ``C`` and ``x`` as given; the algebra is the same as the default's.
    ``bf16_pairs=False`` keeps only ``hi`` at those points: one bf16
    rounding each, the cheaper design that misses the 2e-2 bar and that
    ``chip_smoke.py`` measures beside the kernel's.
    ``y`` and the state come back in ``x``'s dtype.  The plain form of the
    kernel's algorithm, for tests and for checks on the card; the model
    path never calls it.
    """
    b, s, h, p = x.shape
    rep = h // B.shape[2]
    Bh = B.repeat_interleave(rep, dim=2).float()            # [b,s,h,n]
    Ch = C.repeat_interleave(rep, dim=2).float()
    xf, dtf, Af = x.float(), dt.float(), A.float()

    def pair(t: torch.Tensor) -> torch.Tensor:
        if not bf16_points:
            return t
        hi = t.bfloat16().float()
        return hi + (t - hi).bfloat16().float() if bf16_pairs else hi

    # repro: allow(float-dtype): the chunked SSD oracle's f32 state
    state = torch.zeros((b, h, p, Bh.shape[-1]), dtype=torch.float32,
                        device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, min(c0 + chunk, s))
        xs, dts, Bs, Cs = xf[:, sl], dtf[:, sl], Bh[:, sl], Ch[:, sl]
        cs = torch.cumsum(dts * Af, dim=1)                  # [b,l,h]
        total = cs[:, -1]                                   # [b,h]
        # (i) the chunk's own state
        w = pair(xs * (torch.exp(total[:, None] - cs) * dts)[..., None])
        delta = torch.einsum("blhp,blhn->bhpn", w, Bs)
        # (iii) outputs: intra-chunk, then the carried state
        csh = cs.permute(0, 2, 1)                           # [b,h,l]
        tri = torch.ones(csh.shape[-1], csh.shape[-1], dtype=torch.bool,
                         device=x.device).tril()
        decay = torch.exp(torch.where(
            tri, csh[..., :, None] - csh[..., None, :],
            torch.zeros(())))  # repro: allow(float-dtype): f32 SSD oracle
        scores = torch.einsum("bthn,bshn->bhts", Cs, Bs)
        M = pair(torch.where(tri, scores * decay * dts.permute(0, 2, 1)[
            :, :, None, :],
            torch.zeros(())))  # repro: allow(float-dtype): f32 SSD oracle
        y_in = torch.einsum("bhts,bshp->bthp", M, xs)
        y_off = torch.einsum("bthn,bhpn->bthp", Cs, pair(state))
        ys.append(y_in + y_off * torch.exp(cs)[..., None])
        # (ii) state passing
        state = state * torch.exp(total)[..., None, None] + delta
    return torch.cat(ys, dim=1).to(x.dtype), state.to(x.dtype)


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """x [..., d]; weight [d] — fp32 statistics, cast back to x.dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


def causal_conv_ref(x: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv as static shifts.  x [B,S,C]; w [K,C]; b [C]:
    ``b + Σ_k w[k] · x[t − (K−1) + k]``, x zero before t = 0, each product
    and sum in the inputs' promoted dtype."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(K - 1):
        shift = K - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out + b


def causal_conv_silu_ref(x: torch.Tensor, w: torch.Tensor,
                         b: torch.Tensor) -> torch.Tensor:
    """``silu`` of :func:`causal_conv_ref`, in x's dtype: the plain version of
    the ``causal_conv_silu`` kernel (which accumulates in float32 and rounds
    once)."""
    return F.silu(causal_conv_ref(x, w, b)).to(x.dtype)
