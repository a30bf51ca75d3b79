"""Workload generation: Azure-LLM-trace-like AI requests + 3GPP RAN load.

AI service requests (Q^e) follow the published characteristics of the Azure
LLM inference trace (DynamoLLM / BurstGPT): Poisson arrivals with lognormal
prompt/response lengths and a heavy tail.  Per-request GPU work Φ^g is
derived from the *actual architecture configs* (``cfg.flops_per_token``),
so the simulator and the dry-run/roofline agree on what a request costs.
RAN-only requests (Q^r) are synthetic URLLC/eMBB per 3GPP TR 38.913 with
1 ms / 4 ms hard deadlines.

The load knob ρ = λ·W̄ / G follows the paper: G is the effective AI-serving
GPU capacity the operator provisions for peak periods (the GPU-heavy nodes,
after the RAN floor reservation), so ρ = 1.0 means AI demand ≈ provisioned
AI capacity.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.types import GB, Request, RequestClass

# Azure-trace-like length statistics (lognormal, tokens).  Large-AI serves
# long-context requests (paper §IV: "large-AI services for long-context LLM
# inference").  Fulfillment in the no-admission-drop regime is governed by
# queue *stability*: a consolidated placement pushes per-replica utilization
# above 1 (unbounded FIFO wait ⇒ ~0% on-time), while the split placement
# keeps it below 1 — exactly the Table-III separation.
LARGE_PROMPT = (7.7, 0.55, 256, 16384)   # mu, sigma, lo, hi  (median ~2.2k)
LARGE_OUTPUT = (5.3, 0.7, 16, 1024)
SMALL_PROMPT = (5.5, 0.6, 16, 2048)
SMALL_OUTPUT = (2.0, 0.8, 1, 64)

# 3GPP TR 38.913 deadline classes
URLLC_DEADLINE = 1e-3
EMBB_DEADLINE = 4e-3


@dataclasses.dataclass(frozen=True)
class ServiceWorkModel:
    """Per-request work derivation for one AI service (from its arch cfg)."""
    arch: str
    flops_per_token: float          # 2 * N_active (+ small attention term)
    cpu_secs_per_req: float         # tokenization / pre-post processing
    kv_bytes_per_req: Tuple[float, float]   # γ_q range (uniform)

    def work(self, rng: np.random.Generator, prompt: int, output: int
             ) -> Tuple[float, float, float]:
        flops = self.flops_per_token * (prompt + output)
        kv = rng.uniform(*self.kv_bytes_per_req)
        return flops, self.cpu_secs_per_req, kv


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    rho: float = 1.0                 # AI demand / effective AI capacity
    n_ai_requests: int = 20_000
    large_fraction: float = 0.5      # count fraction of Q^e that is large-AI
    ran_per_ai: float = 1.0          # |Q^r| / |Q^e|
    urllc_fraction: float = 0.3
    ran_burst_prob: float = 0.12     # P(arrival is a 2–3 request burst)
    seed: int = 0
    n_cells: int = 6
    # AI request-length law: "lognormal" (Azure-trace default) or "pareto"
    # (heavy-tailed lengths sampled directly: mean-matched to the lognormal
    # spec so ρ keeps its meaning, capped at ai_length_cap × the lognormal
    # hi clip so the tail genuinely extends past it)
    ai_length_kind: str = "lognormal"
    ai_length_alpha: float = 1.2     # Pareto tail index (α > 1)
    ai_length_cap: float = 8.0       # cap multiplier on the hi clip
    # deadlines (paper: "100 ms – a few seconds" for Q^e)
    large_deadline: Tuple[float, float] = (1.0, 4.0)
    small_deadline: Tuple[float, float] = (0.1, 0.3)
    # effective AI capacity G for the ρ definition [FLOP/s]: the operator
    # provisions the two GPU-heavy nodes (≈ 2 × 200 TF minus the RAN floor
    # reservation) for AI serving; ρ=1.0 saturates that provision.
    ai_capacity: float = 320.0e12
    # RAN per-request work (FLOPs on DU, core-s on CU-UP)
    urllc_du_flops: Tuple[float, float] = (1.5e10, 3.0e10)
    embb_du_flops: Tuple[float, float] = (4.0e10, 8.0e10)
    urllc_cuup_secs: Tuple[float, float] = (0.8e-4, 1.6e-4)
    embb_cuup_secs: Tuple[float, float] = (3.0e-4, 6.0e-4)


def _lognormal_len(rng, mu, sigma, lo, hi, size):
    x = rng.lognormal(mu, sigma, size)
    return np.clip(x, lo, hi).astype(np.int64)


def _pareto_scale(spec, alpha: float) -> float:
    """Pareto scale x_m = mean·(α−1)/α — the single source of the
    mean-matching rule that keeps λ and ρ calibrated when the length law
    swaps from lognormal to Pareto."""
    if alpha <= 1.0:
        raise ValueError(
            f"ai_length_alpha must be > 1 (got {alpha}): at α <= 1 the "
            "Pareto mean diverges and the λ/ρ calibration is undefined")
    return mean_tokens(spec) * (alpha - 1.0) / alpha


def _pareto_len(rng, spec, alpha, cap, size):
    """Lengths drawn from a capped Pareto(α) matched to the spec mean.

    The mean-matched scale makes the uncapped mean equal the (clipped)
    lognormal mean; the cap extends ``cap×`` past the lognormal hi clip —
    the tail the post-hoc work-multiplier used to fake.
    """
    _mu, _sigma, lo, hi = spec
    xm = _pareto_scale(spec, alpha)
    x = xm * (1.0 + rng.pareto(alpha, size))
    return np.clip(x, lo, hi * cap).astype(np.int64)


def mean_tokens(spec) -> float:
    mu, sigma, lo, hi = spec
    return float(np.clip(math.exp(mu + sigma ** 2 / 2), lo, hi))


def mean_tokens_cfg(spec, cfg: WorkloadConfig) -> float:
    """Mean length under the configured law (capped-Pareto closed form)."""
    if cfg.ai_length_kind != "pareto":
        return mean_tokens(spec)
    _mu, _sigma, _lo, hi = spec
    alpha = cfg.ai_length_alpha
    xm = _pareto_scale(spec, alpha)
    c = hi * cfg.ai_length_cap
    # E[min(X, c)] for X ~ Pareto(α, x_m)
    return xm * (alpha - (xm / c) ** (alpha - 1.0)) / (alpha - 1.0)


def mean_request_work(models: Dict[str, List[ServiceWorkModel]],
                      cfg: WorkloadConfig) -> float:
    """Mix-weighted mean Φ^g (W̄ in the ρ definition)."""
    large = np.mean([m.flops_per_token for m in models["large"]])
    small = np.mean([m.flops_per_token for m in models["small"]])
    w_l = large * (mean_tokens_cfg(LARGE_PROMPT, cfg)
                   + mean_tokens_cfg(LARGE_OUTPUT, cfg))
    w_s = small * (mean_tokens_cfg(SMALL_PROMPT, cfg)
                   + mean_tokens_cfg(SMALL_OUTPUT, cfg))
    return cfg.large_fraction * w_l + (1 - cfg.large_fraction) * w_s


# --------------------------------------------------------------------------- #
# chunked generation (streaming core)
# --------------------------------------------------------------------------- #
# Internal generation chunk: a fixed constant, deliberately independent of
# any user-facing window, so the realization is a pure function of (cfg,
# models) — re-chunking a stream can never change what it emits.
GEN_CHUNK = 4096

# rng stream tags: AI (Q^e) and RAN (Q^r) substreams draw from separate
# seeded generators so each can be produced chunk-by-chunk in arrival
# order without consuming the other's draws
_AI_STREAM = 0x514545      # "QEE"
_RAN_STREAM = 0x515252     # "QRR"


def _ai_requests(cfg: WorkloadConfig,
                 models: Dict[str, List[ServiceWorkModel]],
                 lam: float):
    """Q^e substream: chunked Poisson arrivals with Azure-like lengths.

    Per chunk the draw phases mirror the classic generator (bulk arrays
    first, then the per-request loop), all from one seeded substream."""
    rng = np.random.default_rng([cfg.seed, _AI_STREAM])
    pareto = cfg.ai_length_kind == "pareto"
    if pareto:
        mean_l = mean_tokens(LARGE_PROMPT) + mean_tokens(LARGE_OUTPUT)
        mean_s = mean_tokens(SMALL_PROMPT) + mean_tokens(SMALL_OUTPUT)
    t = 0.0
    rid = 0
    remaining = cfg.n_ai_requests
    while remaining > 0:
        c = min(GEN_CHUNK, remaining)
        arrivals = t + np.cumsum(rng.exponential(1.0 / lam, c))
        t = float(arrivals[-1])
        is_large = rng.random(c) < cfg.large_fraction
        cells = rng.integers(0, cfg.n_cells, c)
        if pareto:
            a, cap = cfg.ai_length_alpha, cfg.ai_length_cap
            lp = _pareto_len(rng, LARGE_PROMPT, a, cap, c)
            lo = _pareto_len(rng, LARGE_OUTPUT, a, cap, c)
            sp = _pareto_len(rng, SMALL_PROMPT, a, cap, c)
            so = _pareto_len(rng, SMALL_OUTPUT, a, cap, c)
        else:
            lp = _lognormal_len(rng, *LARGE_PROMPT, c)
            lo = _lognormal_len(rng, *LARGE_OUTPUT, c)
            sp = _lognormal_len(rng, *SMALL_PROMPT, c)
            so = _lognormal_len(rng, *SMALL_OUTPUT, c)
        for i in range(c):
            if is_large[i]:
                model = models["large"][rng.integers(len(models["large"]))]
                flops, cpu, kv = model.work(rng, int(lp[i]), int(lo[i]))
                deadline = rng.uniform(*cfg.large_deadline)
                cls = RequestClass.LARGE_AI
                if pareto:    # KV grows sublinearly with context length
                    kv *= min((int(lp[i]) + int(lo[i])) / mean_l, 4.0)
            else:
                model = models["small"][rng.integers(len(models["small"]))]
                flops, cpu, kv = model.work(rng, int(sp[i]), int(so[i]))
                deadline = rng.uniform(*cfg.small_deadline)
                cls = RequestClass.SMALL_AI
                if pareto:
                    kv *= min((int(sp[i]) + int(so[i])) / mean_s, 4.0)
            yield Request(
                rid=rid, cls=cls, arrival=float(arrivals[i]),
                deadline=deadline, cell=int(cells[i]), ai_work_g=flops,
                ai_work_c=cpu, kv_bytes=kv, service=model.arch)
            rid += 1
        remaining -= c


def _ran_requests(cfg: WorkloadConfig, horizon: float, n_ran: int,
                  rid0: int):
    """Q^r substream: chunked URLLC/eMBB arrivals with TTI-aligned bursts.

    With prob ran_burst_prob an arrival event carries 2–4 same-cell
    requests (scheduling bursts) at ``+ b * 1e-5`` offsets, briefly
    exceeding a weak node's DU floor feasibility — the realistic source
    of RAN misses.  Burst offsets can leapfrog a following event when
    inter-event gaps are tiny, so each chunk is sorted and a small tail
    (requests past the chunk's final event) is carried into the next
    chunk — emission stays globally sorted by arrival.
    """
    if n_ran <= 0:
        return
    rng = np.random.default_rng([cfg.seed, _RAN_STREAM])
    mean_burst = 1 + cfg.ran_burst_prob * 1.5
    n_events_r = max(int(n_ran / mean_burst), 1)
    lam_r_ev = n_events_r / horizon
    t = 0.0
    rid = rid0
    emitted = 0
    events_left = n_events_r
    carry: List[Request] = []
    while events_left > 0 and emitted < n_ran:
        ce = min(GEN_CHUNK, events_left)
        base = t + np.cumsum(rng.exponential(1.0 / lam_r_ev, ce))
        t = float(base[-1])
        events_left -= ce
        out = carry
        carry = []
        last_base = 0.0
        for i in range(ce):
            if emitted >= n_ran:
                break
            burst = int(rng.integers(2, 4)) \
                if rng.random() < cfg.ran_burst_prob else 1
            burst = min(burst, n_ran - emitted)
            cell = int(rng.integers(0, cfg.n_cells))
            last_base = float(base[i])
            for b in range(burst):
                if rng.random() < cfg.urllc_fraction:
                    du = rng.uniform(*cfg.urllc_du_flops)
                    cu = rng.uniform(*cfg.urllc_cuup_secs)
                    deadline = URLLC_DEADLINE
                else:
                    du = rng.uniform(*cfg.embb_du_flops)
                    cu = rng.uniform(*cfg.embb_cuup_secs)
                    deadline = EMBB_DEADLINE
                out.append(Request(
                    rid=rid, cls=RequestClass.RAN,
                    arrival=last_base + b * 1e-5,
                    deadline=deadline, cell=cell,
                    du_work_g=du, du_work_c=0.0,   # DU is GPU-bound (§II)
                    cuup_work_c=cu))
                rid += 1
                emitted += 1
        out.sort(key=lambda r: r.arrival)
        if events_left > 0 and emitted < n_ran:
            cut = len(out)
            while cut > 0 and out[cut - 1].arrival > last_base:
                cut -= 1
            carry = out[cut:]
            out = out[:cut]
        yield from out
    yield from carry


def _merge_sorted(a, b, chunk: int = GEN_CHUNK):
    """Merge two arrival-sorted request iterators into sorted chunks.

    Ties emit ``a`` first (AI before RAN — the order the classic global
    stable sort produced from its [AI block, RAN block] list)."""
    ra = next(a, None)
    rb = next(b, None)
    out: List[Request] = []
    while ra is not None or rb is not None:
        if rb is None or (ra is not None and ra.arrival <= rb.arrival):
            out.append(ra)
            ra = next(a, None)
        else:
            out.append(rb)
            rb = next(b, None)
        if len(out) >= chunk:
            yield out
            out = []
    if out:
        yield out


def workload_stream(cfg: WorkloadConfig,
                    models: Dict[str, List[ServiceWorkModel]]):
    """The chunked-stream form of the workload (O(GEN_CHUNK) memory).

    Returns an :class:`repro_torch.sim.stream.ArrivalStream` whose metadata
    carries the analytic horizon (n/λ) and nominal request count, so the
    engine never needs a full-list ``max(r.arrival)`` scan.  The stream
    is restartable: every ``chunks()`` pass regenerates the identical
    realization from the seeded substreams.
    """
    from repro_torch.sim.stream import ArrivalStream

    w_bar = mean_request_work(models, cfg)
    lam = cfg.rho * cfg.ai_capacity / w_bar              # ρ = λ W̄ / G
    horizon = cfg.n_ai_requests / lam
    n_ran = int(cfg.n_ai_requests * cfg.ran_per_ai)
    info = {"lambda_ai": lam, "lambda_ran": n_ran / horizon,
            "horizon": horizon, "mean_work": w_bar,
            "large_demand_flops":
                lam * cfg.large_fraction
                * np.mean([m.flops_per_token for m in models["large"]])
                * (mean_tokens(LARGE_PROMPT) + mean_tokens(LARGE_OUTPUT))}

    def factory():
        return _merge_sorted(
            _ai_requests(cfg, models, lam),
            _ran_requests(cfg, horizon, n_ran, cfg.n_ai_requests))
    return ArrivalStream(factory, horizon=horizon,
                         n_requests=cfg.n_ai_requests + n_ran, info=info)


def generate_workload(cfg: WorkloadConfig,
                      models: Dict[str, List[ServiceWorkModel]]
                      ) -> Tuple[List[Request], Dict[str, float]]:
    """Returns (requests sorted by arrival, info dict with λ, horizon, W̄).

    The materialized view of :func:`workload_stream` — byte-identical to
    consuming the stream chunk-by-chunk (the stream IS the generator).
    """
    stream = workload_stream(cfg, models)
    return stream.to_list(), dict(stream.info)
