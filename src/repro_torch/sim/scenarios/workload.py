"""Workload realization for registry scenarios.

A scenario carries a plain-dict ``workload`` recipe; :func:`workload_stream_for`
turns it into the chunked :class:`~repro_torch.sim.stream.ArrivalStream` the
``Simulator`` consumes (:func:`workload_for` is the materialized compat
view).  On top of the base Poisson/lognormal generator
(:mod:`repro_torch.sim.workload`) this module adds the time/size structure the
non-stationary families need:

  * ``arrival`` profiles reshape arrival times by the time-rescaling
    theorem: homogeneous arrivals a_i are mapped through Λ⁻¹ (the inverse
    cumulative intensity), yielding an inhomogeneous Poisson process with
    intensity λ·m(t) — ``diurnal`` (sinusoidal m) and ``flash-crowd``
    (piecewise-constant spike windows).  The map is built once from the
    stream's analytic horizon and applied per chunk; it is monotone, so
    chunk order (and hence the stream sort contract) is preserved.
  * heavy-tailed sizes come straight from the base generator: the recipe
    sets ``ai_length_kind="pareto"`` and the request *lengths* are drawn
    from a mean-matched capped Pareto (heavy-tailed Φ^g / γ_q) — the
    legacy ``heavy_tail`` post-hoc work-multiplier recipe is still
    honored as a per-chunk transform (seeded rng consumed in stream
    order, so any chunking yields the same multipliers).
  * ``trace`` recipes short-circuit to :mod:`repro_torch.sim.tracefile` and
    replay a CSV/JSONL cluster trace with bounded-memory parsing.

Everything is deterministic in (scenario, seed): the recipe is data, the
randomness comes only from seeded generators, and the realization is
independent of the requested ``window`` (chunk size is a memory knob).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.stream import ArrivalStream
from repro_torch.sim.types import Request
from repro_torch.sim.workload import (WorkloadConfig, mean_request_work,
                                workload_stream)

# WorkloadConfig fields a scenario recipe may set
_CFG_KEYS = ("rho", "n_ai_requests", "large_fraction", "ran_per_ai",
             "urllc_fraction", "ran_burst_prob", "n_cells", "ai_capacity",
             "large_deadline", "small_deadline",
             "ai_length_kind", "ai_length_alpha", "ai_length_cap")
_TUPLE_KEYS = ("large_deadline", "small_deadline")

_HEAVY_TAIL_STREAM = 0x48545F      # rng stream tag ("HT_")


def workload_config(scenario: Dict, seed: int = 0,
                    n_ai_requests: Optional[int] = None,
                    rho: Optional[float] = None) -> WorkloadConfig:
    """The base (stationary) WorkloadConfig encoded by the scenario."""
    spec = dict(scenario.get("workload") or {})
    kw = {k: spec[k] for k in _CFG_KEYS if k in spec}
    for k in _TUPLE_KEYS:
        if k in kw:
            kw[k] = tuple(kw[k])
    if n_ai_requests is not None:
        kw["n_ai_requests"] = int(n_ai_requests)
    if rho is not None:
        kw["rho"] = float(rho)
    return WorkloadConfig(seed=seed, **kw)


def estimated_horizon(scenario: Dict, n_ai_requests: Optional[int] = None,
                      rho: Optional[float] = None) -> float:
    """Expected trace length [s] implied by the recipe (horizon = n/λ)."""
    cfg = workload_config(scenario, 0, n_ai_requests, rho)
    w_bar = mean_request_work(scenario["work_models"], cfg)
    lam = cfg.rho * cfg.ai_capacity / w_bar
    return cfg.n_ai_requests / lam


def workload_stream_for(scenario: Dict, seed: int = 0,
                        n_ai_requests: Optional[int] = None,
                        rho: Optional[float] = None,
                        window: Optional[int] = None) -> ArrivalStream:
    """Realize the scenario's workload recipe as a chunked stream.

    ``window`` re-buffers the stream into chunks of that many requests
    (the engine's refill granularity); it never changes what the stream
    emits.
    """
    spec = dict(scenario.get("workload") or {})

    if spec.get("kind") == "trace":
        from repro_torch.sim import tracefile
        limit = n_ai_requests if n_ai_requests is not None \
            else (spec.get("n_ai_requests") or None)
        stream = tracefile.trace_stream(
            spec, scenario["work_models"], seed=seed, n_requests=limit)
        if window is None:
            window = int(spec.get("window") or 0) or None
    else:
        cfg = workload_config(scenario, seed, n_ai_requests, rho)
        stream = workload_stream(cfg, scenario["work_models"])

        arrival = spec.get("arrival") or {"kind": "poisson"}
        if arrival.get("kind", "poisson") != "poisson":
            stream = _warped(stream, arrival)

        heavy = spec.get("heavy_tail")
        if heavy:
            stream = _heavy_tailed(stream, heavy, seed)

    if window:
        stream = stream.rechunked(window)
    return stream


def workload_for(scenario: Dict, seed: int = 0,
                 n_ai_requests: Optional[int] = None,
                 rho: Optional[float] = None
                 ) -> Tuple[List[Request], Dict[str, float]]:
    """Materialized view of the scenario workload: (requests, info)."""
    stream = workload_stream_for(scenario, seed, n_ai_requests, rho)
    return stream.to_list(), dict(stream.info)


# --------------------------------------------------------------------------- #
# arrival-time reshaping (inhomogeneous Poisson via time rescaling)
# --------------------------------------------------------------------------- #
def _intensity_profile(arrival: Dict, ts: np.ndarray,
                       horizon: float) -> np.ndarray:
    kind = arrival["kind"]
    if kind == "diurnal":
        period = float(arrival.get("period_s", 240.0))
        depth = float(arrival.get("depth", 0.6))
        phase = float(arrival.get("phase", 0.0))
        m = 1.0 + depth * np.sin(2 * np.pi * ts / period + phase)
    elif kind == "flash-crowd":
        # windows: [start_frac, len_frac, magnitude] of the horizon
        m = np.ones_like(ts)
        for start, length, mag in arrival["windows"]:
            lo, hi = start * horizon, (start + length) * horizon
            m[(ts >= lo) & (ts < hi)] = float(mag)
    elif kind == "composed":
        # multiplicative composition: spikes ride ON the slow profile
        # (a flash crowd during the diurnal peak is worse than one in the
        # trough) — each part keeps its own parameters
        m = np.ones_like(ts)
        for part in arrival["parts"]:
            m = m * _intensity_profile(part, ts, horizon)
    else:
        raise ValueError(f"unknown arrival profile {kind!r}")
    return np.maximum(m, 0.05)          # intensity stays strictly positive


def _warped(stream: ArrivalStream, arrival: Dict) -> ArrivalStream:
    """Map arrivals through Λ⁻¹ so the empirical intensity follows m(t).

    Λ is normalized to Λ(H) = H over the stream's analytic horizon, so
    the trace keeps its duration and mean rate — the profile
    redistributes load over time, it does not add load (ρ keeps its
    meaning as the time-averaged operating point).  The map is a fixed
    monotone function of arrival time, so it applies chunk-by-chunk
    without ever seeing the whole trace; arrivals past H (the Poisson
    tail beyond the analytic horizon) shift by the identity.
    """
    horizon = stream.horizon
    ts = np.linspace(0.0, horizon, 4097)
    m = _intensity_profile(arrival, ts, horizon)
    dt = np.diff(ts)
    lam_cum = np.concatenate(
        [[0.0], np.cumsum(0.5 * (m[1:] + m[:-1]) * dt)])
    lam_cum *= horizon / lam_cum[-1]
    lam_end = float(lam_cum[-1])

    def fn_factory():
        def warp(chunk: List[Request]) -> List[Request]:
            a = np.array([r.arrival for r in chunk])
            # t' = Λ⁻¹(a): thin out where m is small, bunch where large
            w = np.interp(a, lam_cum, ts)
            tail = a >= lam_end
            if tail.any():
                w[tail] = horizon + (a[tail] - lam_end)
            for r, t in zip(chunk, w):
                r.arrival = float(t)
            return chunk
        return warp
    return stream.transformed(fn_factory)


# --------------------------------------------------------------------------- #
# heavy-tailed request sizes
# --------------------------------------------------------------------------- #
def _heavy_tailed(stream: ArrivalStream, heavy: Dict,
                  seed: int) -> ArrivalStream:
    """Scale a seeded fraction of AI requests by a Pareto work multiplier.

    The rng is consumed in stream (arrival) order with one decision draw
    per AI request, so the multipliers are a function of the request
    sequence alone — independent of chunking.
    """
    fraction = float(heavy.get("fraction", 0.2))
    alpha = float(heavy.get("alpha", 1.3))
    cap = float(heavy.get("cap", 30.0))

    def fn_factory():
        rng = np.random.default_rng([seed, _HEAVY_TAIL_STREAM])

        def scale(chunk: List[Request]) -> List[Request]:
            for r in chunk:
                if not r.cls.is_ai:
                    continue
                if rng.random() >= fraction:
                    continue
                mult = min(1.0 + rng.pareto(alpha), cap)
                r.ai_work_g *= mult
                # KV grows sublinearly with work (longer context, same arch)
                r.kv_bytes *= min(mult, 4.0)
            return chunk
        return scale
    return stream.transformed(fn_factory)


def _apply_heavy_tail(requests: List[Request], heavy: Dict,
                      seed: int) -> None:
    """Legacy in-place form (hand-built request lists)."""
    fraction = float(heavy.get("fraction", 0.2))
    alpha = float(heavy.get("alpha", 1.3))
    cap = float(heavy.get("cap", 30.0))
    rng = np.random.default_rng([seed, _HEAVY_TAIL_STREAM])
    for r in requests:
        if not r.cls.is_ai:
            continue
        if rng.random() >= fraction:
            continue
        mult = min(1.0 + rng.pareto(alpha), cap)
        r.ai_work_g *= mult
        r.kv_bytes *= min(mult, 4.0)
