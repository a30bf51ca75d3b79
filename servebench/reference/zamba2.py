"""Plain float32 reference of the published Zamba2 hybrid (Zamba2-7B).

From the model's equations (arXiv:2411.15242; Zyphra's config), with e the
embedding output and h = e at the start.  For each layer i: where i is a
hybrid layer, its application j (0, 1, ...) of shared block j mod blocks
adds

    x = rms_norm(concat(h, e))                          2 d_model wide
    a = o(attn(rope(q x), rope(k x), v x))              causal
    m = rms_norm(a)
    [g, u] = m W_gu + (m A_j) B_j                        A_j, B_j its own
    h = h + L_j(down(gelu(g) * u))                       L_j its own

then every layer adds its Mamba2 mixer, h = h + mamba(rms_norm(h)):
z, x, B, C and dt from the normed input; a causal depthwise convolution
with bias, then SiLU, over x, B and C; dt = softplus(dt + dt_bias), A =
-exp(A_log); the SSD computed by its definition over chunks of the
configuration's chunk length (the last one ragged), in float32 with the
state carried from chunk to chunk; y + D x; y * silu(z) normalised in each
of n_groups parts of d_inner with its own statistics; the out product.
Head h of the SSD reads B / C group h // (heads / groups).  The logits of
the last position come from the final norm and the embedding (the head is
tied).

Attention scores are scaled by (head_dim / 2) ** -0.5, Zamba2's scale for
a head that reads the doubled input: ``plain.causal_attention`` scales by
1 / sqrt(head_dim), so q enters it times sqrt(2).  A prompt is computed one
row at a time.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from servebench.core.counting import causal_attention_flops, ssd_bound
from servebench.reference import plain


def _grouped_norm(x: torch.Tensor, w: torch.Tensor, groups: int,
                  eps: float) -> torch.Tensor:
    d = x.shape[-1]
    xg = x.reshape(*x.shape[:-1], groups, d // groups)
    return plain.rms_norm(xg, w.reshape(groups, d // groups), eps
                          ).reshape(x.shape)


def _conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Causal depthwise convolution of x [S, C] with w [K, C]: out[t] =
    sum_i w[i] x[t - K + 1 + i] + b."""
    K = w.shape[0]
    w, b = w.float(), b.float()
    xp = F.pad(x, (0, 0, K - 1, 0))
    out = b.expand_as(x).clone()
    for i in range(K):
        out += w[i] * xp[i:i + x.shape[0]]
    return out


def ssd(x, dt, A, B, C, chunk: int):
    """The SSD of one row by its definition.  x [S, h, p], dt [S, h], A [h],
    B, C [S, g, n]; returns (y [S, h, p], the final state [h, p, n])."""
    S, h, p = x.shape
    g, n = B.shape[1], B.shape[2]
    group = torch.arange(h, device=x.device) // (h // g)
    state = x.new_zeros((h, p, n))
    y = torch.empty_like(x)
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(S, c0 + chunk))
        xc, dtc = x[sl], dt[sl]
        Bc, Cc = B[sl][:, group], C[sl][:, group]      # [l, h, n]
        cs = torch.cumsum(dtc * A, dim=0)               # [l, h]
        l = xc.shape[0]
        # intra-chunk: y_t = sum_{s<=t} (C_t . B_s) exp(cs_t - cs_s) dt_s x_s
        diff = cs[:, None, :] - cs[None, :, :]           # [t, s, h]
        causal = torch.ones(l, l, dtype=torch.bool,
                            device=x.device).tril()[:, :, None]
        decay = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                            0.0)
        scores = torch.einsum("thn,shn->tsh", Cc, Bc) * decay * dtc[None]
        y[sl] = torch.einsum("tsh,shp->thp", scores, xc)
        # the state carried into the chunk, decayed to each position
        y[sl] += torch.einsum("thn,hpn->thp", Cc, state) \
            * torch.exp(cs)[:, :, None]
        # the state leaving the chunk
        w = torch.exp(cs[-1][None] - cs) * dtc           # [l, h]
        state = state * torch.exp(cs[-1])[:, None, None] \
            + torch.einsum("th,thp,thn->hpn", w, xc, Bc)
    return y, state


def mamba(lp: dict, h: torch.Tensor, cfg: dict, quant: plain.Quant = None):
    """The Mamba2 mixer of one row, h [S, D] (its pre-norm included);
    returns (its output [S, D], the final SSM state [H, P, N])."""
    S = h.shape[0]
    P, G, N = cfg["ssm_head_dim"], cfg["n_groups"], cfg["d_state"]
    d_in = cfg["expand"] * cfg["d_model"]
    H = d_in // P
    x = plain.rms_norm(h, lp["norm"], cfg["norm_eps"])
    z = plain.linear(x, lp["in_z"], quant)
    xs = F.silu(_conv(plain.linear(x, lp["in_x"], quant), lp["conv_x"],
                      lp["conv_bias_x"]))
    Bs = F.silu(_conv(plain.linear(x, lp["in_B"], quant), lp["conv_B"],
                      lp["conv_bias_B"]))
    Cs = F.silu(_conv(plain.linear(x, lp["in_C"], quant), lp["conv_C"],
                      lp["conv_bias_C"]))
    dt = F.softplus(plain.linear(x, lp["in_dt"], quant)
                    + lp["dt_bias"].float())
    A = -torch.exp(lp["A_log"].float())
    xh = xs.reshape(S, H, P)
    y, state = ssd(xh, dt, A, Bs.reshape(S, G, N), Cs.reshape(S, G, N),
                   cfg["chunk_size"])
    y = y + xh * lp["D_skip"].float()[None, :, None]
    y = _grouped_norm(y.reshape(S, d_in) * F.silu(z), lp["gate_norm"], G,
                      cfg["norm_eps"])
    return plain.linear(y, lp["out_proj"], quant), state


def shared_block(sp: dict, ap: dict, h: torch.Tensor, e: torch.Tensor,
                 cfg: dict, quant: plain.Quant = None):
    """What one application adds to h [1, S, D] from the embeddings e;
    returns (it, k, v [1, S, KV, hd] as a cache holds them)."""
    eps = cfg["norm_eps"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    x = plain.rms_norm(torch.cat([h, e], dim=-1), sp["ln1"], eps)
    B, S, Din = x.shape
    at = sp["attn"]
    q = plain.linear(x, at["wq"].reshape(Din, H * hd), quant)
    k = plain.linear(x, at["wk"].reshape(Din, KV * hd), quant)
    v = plain.linear(x, at["wv"].reshape(Din, KV * hd), quant)
    q = plain.rope(q.reshape(B, S, H, hd), cfg["rope_theta"])
    k = plain.rope(k.reshape(B, S, KV, hd), cfg["rope_theta"])
    v = v.reshape(B, S, KV, hd)
    # scores at (hd / 2) ** -0.5 = sqrt(2) / sqrt(hd)
    o = plain.causal_attention(q * math.sqrt(2.0), k, v)
    a = plain.linear(o.reshape(B, S, H * hd),
                     at["wo"].reshape(H * hd, cfg["d_model"]), quant)
    m = plain.rms_norm(a, sp["ln2"], eps)
    gu = plain.linear(m, sp["mlp"]["gate_up"], quant) + plain.linear(
        plain.linear(m, ap["lora_a"], quant), ap["lora_b"], quant)
    g, u = gu.chunk(2, dim=-1)
    t = plain.linear(F.gelu(g) * u, sp["mlp"]["down"], quant)
    return plain.linear(t, ap["linear"], quant), k, v


def prefill(params: dict, batch: dict, cfg: dict, *, on_cache=None,
            quant: plain.Quant = None) -> torch.Tensor:
    """Last-position logits ``[B, V]`` (float32) of ``batch`` (``tokens [B,
    T]``).  ``on_cache(kind, index, rows, t)`` receives the keys and values
    of application ``index`` (``kind`` ``"k"`` / ``"v"``, ``t [rows, S, KV,
    hd]``) and the final SSM state of layer ``index`` (``"ssm"``, ``[rows,
    H, P, N]``), as a cache holds them."""
    eps = cfg["norm_eps"]
    ids = list(cfg["layer_ids"])
    blocks = cfg["shared_attn_blocks"]
    out = []
    for r in range(batch["tokens"].shape[0]):
        rows = slice(r, r + 1)
        e = params["embed"][batch["tokens"][rows]].float()
        h = e
        for i, lp in enumerate(params["ssm_layers"]):
            if i in ids:
                j = ids.index(i)
                t, k, v = shared_block(params["shared"][j % blocks],
                                       params["apps"][j], h, e, cfg, quant)
                if on_cache is not None:
                    on_cache("k", j, rows, k)
                    on_cache("v", j, rows, v)
                del k, v
                h = h + t
            y, state = mamba(lp, h[0], cfg, quant)
            if on_cache is not None:
                on_cache("ssm", i, rows, state[None])
            h = h + y[None]
        last = plain.rms_norm(h[:, -1], params["final_norm"], eps)
        out.append(plain.linear(last, params["embed"].T, quant))
    return torch.cat(out)


def work(cfg: dict, rows: int, positions: int) -> dict:
    """The operations a prefill of ``rows`` prompts of ``positions`` must
    do, from the configuration's shapes: ``linear_flops`` (every weight
    product: the mixers' input and output products, each application's
    attention, MLP, adapter and linear products; the tied unembedding at the
    last position only), ``model_flops`` (those, causal attention at
    S(S+1)/2 and the SSD at the configuration's chunk, ``ssd_bound``), and
    the kernel calls as ``attention`` [(B, S, H, KV, hd, calls)] and
    ``ssd`` [(b, s, h, g, p, n, chunk, calls)]."""
    D, F_, r = cfg["d_model"], cfg["d_ff"], cfg["adapter_rank"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    P, G, N = cfg["ssm_head_dim"], cfg["n_groups"], cfg["d_state"]
    L, apps = cfg["num_layers"], len(cfg["layer_ids"])
    d_in = cfg["expand"] * D
    Hs = d_in // P
    mixer = 2 * D * (2 * d_in + 2 * G * N + Hs) + 2 * d_in * D
    app = (2 * 2 * D * (H + 2 * KV) * hd + 2 * H * hd * D
           + 2 * D * 2 * F_ + 2 * r * (D + 2 * F_) + 2 * F_ * D + 2 * D * D)
    linear = rows * positions * (L * mixer + apps * app) \
        + 2 * rows * D * cfg["vocab_size"]
    attention = apps * causal_attention_flops(rows, positions, H, hd)
    ssd_call = (rows, positions, Hs, G, P, N, cfg["chunk_size"])
    scan = L * ssd_bound(*ssd_call, 2)[1]
    return {"linear_flops": linear,
            "model_flops": linear + attention + scan,
            "attention": [(rows, positions, H, KV, hd, apps)],
            "ssd": [ssd_call + (L,)]}
