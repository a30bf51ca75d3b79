"""The scenario families (registry entries).

  paper          Table I re-expressed: the 6-node / 6-cell reference
  dense-urban    scaled topology: N nodes, C cells, consolidated AI racks
  diurnal        paper topology under a sinusoidal day/night load profile
  flash-crowd    paper topology with bursty arrival spikes (rate × k windows)
  diurnal-flash  composed profile: flash spikes riding the diurnal swing
  heavy-tail     paper topology with Pareto-tailed request sizes
  node-outage    paper topology with node availability windows (fault inject)
  spot-churn     preemption churn: departures + rejoins with advance notices
  skewed-hetero  one GPU-rich node + many weak nodes (placement stress)

Every family is deterministic in (seed, params) and returns the scenario
dict the ``Simulator`` consumes; extra keys (``meta``, ``workload``,
``outages``) drive the :mod:`repro_torch.eval` harness and the engine's fault
injection.  Load profiles redistribute a fixed total load (ρ keeps its
time-averaged meaning); sizes/outages change what the load is made of.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.sim.scenario import paper_scenario
from repro_torch.sim.scenarios.builder import (DEFAULT_SMALL_ARCHS, build_scenario,
                                         effective_ai_capacity, make_node)
from repro_torch.sim.scenarios.registry import register
from repro_torch.sim.scenarios.workload import estimated_horizon
from repro_torch.sim.types import GB, TFLOPS, InstanceCategory, NodeSpec


def _finish(sc: Dict, family: str, seed: int, params: Dict, rho: float,
            n_ai_requests: int, arrival: Optional[Dict] = None,
            heavy_tail: Optional[Dict] = None,
            outages: Optional[List[List[float]]] = None) -> Dict:
    """Attach the workload recipe + provenance metadata to a topology."""
    n_cells = sum(1 for s in sc["instances"]
                  if s.category == InstanceCategory.DU)
    wl: Dict = {
        "rho": float(rho),
        "n_ai_requests": int(n_ai_requests),
        "n_cells": n_cells,
        "ai_capacity": effective_ai_capacity(sc["nodes"]),
    }
    if arrival is not None:
        wl["arrival"] = arrival
    if heavy_tail is not None:
        wl["heavy_tail"] = heavy_tail
    sc["workload"] = wl
    if outages is not None:
        sc["outages"] = [[int(n), float(t0), float(t1)]
                         for n, t0, t1 in outages]
    sc["meta"] = {"family": family, "seed": int(seed), "params": dict(params)}
    return sc


# --------------------------------------------------------------------------- #
@register("paper")
def paper(seed: int = 0, rho: float = 1.0,
          n_ai_requests: int = 5000) -> Dict:
    """The paper's Table-I scenario (topology independent of ``seed``)."""
    sc = paper_scenario()
    return _finish(sc, "paper", seed, {"rho": rho}, rho, n_ai_requests)


# --------------------------------------------------------------------------- #
@register("dense-urban")
def dense_urban(seed: int = 0, n_nodes: int = 18, rho: float = 1.0,
                n_ai_requests: int = 12000, jitter: float = 0.1) -> Dict:
    """Scaled metro edge: N nodes (1/3 each tier, ±jitter capacity), one
    cell per node, large-AI consolidated two-per-rack on the first half of
    the GPU tier, one small-AI replica per remaining node."""
    assert n_nodes >= 3, "dense-urban needs at least one node per tier"
    rng = np.random.default_rng(seed)
    n_gpu = max(n_nodes // 3, 1)
    n_cpu = max(n_nodes // 3, 1)
    n_bal = n_nodes - n_gpu - n_cpu

    nodes: List[NodeSpec] = []
    for kind, count in (("gpu-heavy", n_gpu), ("cpu-heavy", n_cpu),
                        ("balanced", n_bal)):
        for _ in range(count):
            i = len(nodes)
            scale = float(rng.uniform(1.0 - jitter, 1.0 + jitter))
            nodes.append(make_node(f"n{i}-{kind.split('-')[0]}", kind, scale))

    # AI racks: two large replicas per rack on the first ⌈n_gpu/2⌉ GPU nodes
    n_racks = max((n_gpu + 1) // 2, 1)
    large_nodes = [r for r in range(n_racks) for _ in range(2)]
    # one small replica on every non-GPU node, alternating archs
    small_plan = [(DEFAULT_SMALL_ARCHS[i % len(DEFAULT_SMALL_ARCHS)],
                   n_gpu + i) for i in range(n_cpu + n_bal)]

    sc = build_scenario(nodes, n_cells=n_nodes, large_nodes=large_nodes,
                        small_plan=small_plan)
    return _finish(sc, "dense-urban", seed,
                   {"n_nodes": n_nodes, "rho": rho, "jitter": jitter},
                   rho, n_ai_requests)


# --------------------------------------------------------------------------- #
@register("diurnal")
def diurnal(seed: int = 0, period_s: float = 240.0, depth: float = 0.6,
            rho: float = 0.9, n_ai_requests: int = 5000) -> Dict:
    """Sinusoidal day/night load on the paper topology: the intensity
    swings (1±depth)× around the mean with a seeded phase."""
    rng = np.random.default_rng(seed)
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    sc = paper_scenario()
    return _finish(sc, "diurnal", seed,
                   {"period_s": period_s, "depth": depth, "rho": rho},
                   rho, n_ai_requests,
                   arrival={"kind": "diurnal", "period_s": float(period_s),
                            "depth": float(depth), "phase": phase})


# --------------------------------------------------------------------------- #
@register("flash-crowd")
def flash_crowd(seed: int = 0, n_spikes: int = 3, magnitude: float = 4.0,
                width_frac: float = 0.04, rho: float = 0.8,
                n_ai_requests: int = 5000) -> Dict:
    """Bursty arrivals: ``n_spikes`` seeded windows where the arrival rate
    jumps to ``magnitude``× (viral events / reconnect storms)."""
    rng = np.random.default_rng(seed)
    starts = np.sort(rng.uniform(0.05, 0.85, n_spikes))
    windows = [[float(s), float(width_frac), float(magnitude)]
               for s in starts]
    sc = paper_scenario()
    return _finish(sc, "flash-crowd", seed,
                   {"n_spikes": n_spikes, "magnitude": magnitude,
                    "width_frac": width_frac, "rho": rho},
                   rho, n_ai_requests,
                   arrival={"kind": "flash-crowd", "windows": windows})


# --------------------------------------------------------------------------- #
@register("diurnal-flash")
def diurnal_flash(seed: int = 0, period_s: float = 240.0, depth: float = 0.6,
                  n_spikes: int = 3, magnitude: float = 4.0,
                  width_frac: float = 0.04, rho: float = 0.8,
                  n_ai_requests: int = 5000) -> Dict:
    """Composed arrival profile: flash-crowd spikes riding a diurnal swing
    (multiplicative — a spike at the daily peak compounds, one in the
    trough barely registers).  Both parts draw from the same seeded stream,
    so the family stays deterministic in (seed, params)."""
    rng = np.random.default_rng(seed)
    phase = float(rng.uniform(0.0, 2.0 * math.pi))
    starts = np.sort(rng.uniform(0.05, 0.85, n_spikes))
    windows = [[float(s), float(width_frac), float(magnitude)]
               for s in starts]
    sc = paper_scenario()
    return _finish(sc, "diurnal-flash", seed,
                   {"period_s": period_s, "depth": depth,
                    "n_spikes": n_spikes, "magnitude": magnitude,
                    "width_frac": width_frac, "rho": rho},
                   rho, n_ai_requests,
                   arrival={"kind": "composed", "parts": [
                       {"kind": "diurnal", "period_s": float(period_s),
                        "depth": float(depth), "phase": phase},
                       {"kind": "flash-crowd", "windows": windows},
                   ]})


# --------------------------------------------------------------------------- #
@register("heavy-tail")
def heavy_tail(seed: int = 0, alpha: float = 1.2, cap: float = 8.0,
               rho: float = 0.9, n_ai_requests: int = 5000) -> Dict:
    """Heavy-tailed request sizes: AI request lengths are sampled from a
    capped Pareto(α) directly (mean-matched to the default lognormal law
    so ρ keeps its meaning, with the cap extending ``cap×`` past the
    lognormal clip) — a few requests dominate the backlog, stressing the
    urgency-weighted allocator."""
    sc = paper_scenario()
    sc = _finish(sc, "heavy-tail", seed,
                 {"alpha": alpha, "cap": cap, "rho": rho},
                 rho, n_ai_requests)
    sc["workload"].update(ai_length_kind="pareto",
                          ai_length_alpha=float(alpha),
                          ai_length_cap=float(cap))
    return sc


# --------------------------------------------------------------------------- #
@register("trace")
def trace(seed: int = 0, file: str = "", window: int = 5000,
          speedup: float = 1.0, class_map: str = "",
          n_ai_requests: int = 0) -> Dict:
    """Cluster-trace replay on the paper topology: arrivals, classes, and
    token lengths come from a CSV/JSONL trace file (see
    :mod:`repro_torch.sim.tracefile` for the schema) instead of the synthetic
    Poisson generator.  ``window`` is the streaming refill granularity
    (memory knob — never affects results), ``speedup`` divides arrival
    times, ``class_map`` maps trace labels to large/small
    (``"chat=small,batch=large"``), and ``n_ai_requests > 0`` caps replay
    to a prefix of the trace.  ``file=""`` replays the built-in synthetic
    diurnal trace (deterministic in ``seed``) — the zero-setup default
    and the cross-engine equivalence fixture.  No RAN requests are
    synthesized — the RAN summary row is NaN, the AI rows carry the
    result."""
    sc = paper_scenario()
    sc = _finish(sc, "trace", seed,
                 {"file": str(file), "window": int(window),
                  "speedup": float(speedup), "class_map": str(class_map),
                  "n_ai_requests": int(n_ai_requests)},
                 rho=1.0, n_ai_requests=n_ai_requests)
    sc["workload"].update(kind="trace", file=str(file), window=int(window),
                          speedup=float(speedup), class_map=str(class_map))
    if n_ai_requests <= 0:
        # 0 = replay the whole trace; the harness's n_ai_requests override
        # still applies as a row cap when set
        sc["workload"]["n_ai_requests"] = 0
    return sc


# --------------------------------------------------------------------------- #
@register("node-outage")
def node_outage(seed: int = 0, n_outages: int = 2, outage_s: float = 25.0,
                rho: float = 0.8, n_ai_requests: int = 5000) -> Dict:
    """Fault injection on the paper topology: seeded nodes go dark for
    ``outage_s`` seconds mid-trace (availability windows the engine
    schedules); recovery needs the placement layer to migrate around the
    hole and back."""
    sc = paper_scenario()
    sc = _finish(sc, "node-outage", seed,
                 {"n_outages": n_outages, "outage_s": outage_s, "rho": rho},
                 rho, n_ai_requests)
    rng = np.random.default_rng(seed)
    horizon = estimated_horizon(sc)
    n_nodes = len(sc["nodes"])
    outages = []
    for _ in range(n_outages):
        node = int(rng.integers(0, n_nodes))
        t0 = float(rng.uniform(0.15, 0.75) * horizon)
        outages.append([node, t0, t0 + float(outage_s)])
    sc["outages"] = outages
    sc["meta"]["params"]["outages"] = [list(o) for o in outages]
    return sc


# --------------------------------------------------------------------------- #
@register("spot-churn")
def spot_churn(seed: int = 0, n_preemptions: int = 3, down_s: float = 30.0,
               notice_s: float = 5.0, scale: float = 0.0, flaps: int = 0,
               flap_scale: float = 0.5, flap_s: float = 15.0,
               forced_factor: float = 0.5, autoscale: bool = False,
               boost: float = 1.25, lag_s: float = 8.0, drain_s: float = 5.0,
               rho: float = 0.8, n_ai_requests: int = 5000) -> Dict:
    """Spot-instance churn on the paper topology: seeded nodes depart and
    rejoin mid-trace with advance preemption notices (varuna-style), plus
    optional capacity flaps (residual ``flap_scale`` capacity instead of a
    full departure).  Migrations off a draining/degraded node are forced —
    they ride the notice and pay ``forced_factor`` × the reconfiguration
    cost of an elective move.  ``autoscale=True`` arms the autoscaler
    hook: surviving nodes take a ``boost`` after ``lag_s`` of scale-out
    lag and drain for ``drain_s`` on scale-in."""
    from repro_torch.faults import churn_schedule
    sc = paper_scenario()
    sc = _finish(sc, "spot-churn", seed,
                 {"n_preemptions": n_preemptions, "down_s": down_s,
                  "notice_s": notice_s, "scale": scale, "flaps": flaps,
                  "flap_scale": flap_scale, "flap_s": flap_s,
                  "forced_factor": forced_factor, "autoscale": autoscale,
                  "boost": boost, "lag_s": lag_s, "drain_s": drain_s,
                  "rho": rho},
                 rho, n_ai_requests)
    horizon = estimated_horizon(sc)
    churn = churn_schedule(seed, len(sc["nodes"]), horizon,
                           n_preemptions=n_preemptions, down_s=down_s,
                           notice_s=notice_s, scale=scale, flaps=flaps,
                           flap_scale=flap_scale, flap_s=flap_s)
    sc["churn"] = churn
    sc["forced_reconfig_factor"] = float(forced_factor)
    if autoscale:
        sc["autoscale"] = {"boost": float(boost), "lag_s": float(lag_s),
                           "drain_s": float(drain_s)}
    sc["meta"]["params"]["churn"] = [dict(ev) for ev in churn]
    return sc


# --------------------------------------------------------------------------- #
@register("skewed-hetero")
def skewed_hetero(seed: int = 0, n_nodes: int = 8, skew: float = 4.0,
                  rho: float = 0.9, n_ai_requests: int = 5000,
                  jitter: float = 0.1) -> Dict:
    """GPU/CPU imbalance: one GPU-rich node holds ``skew``× the compute of
    a weak node; everything AI starts consolidated there, so any fault or
    hotspot forces placement onto genuinely inferior hardware."""
    assert n_nodes >= 2
    rng = np.random.default_rng(seed)
    nodes = [NodeSpec("n0-super", "gpu-heavy", skew * 100 * TFLOPS, 32,
                      96 * GB)]
    for i in range(1, n_nodes):
        scale = float(rng.uniform(1.0 - jitter, 1.0 + jitter))
        nodes.append(NodeSpec(f"n{i}-weak", "balanced",
                              100 * TFLOPS * scale, 48 * scale,
                              24 * GB * scale))

    large_nodes = [0, 0]                       # the AI rack IS the super node
    small_plan = [(DEFAULT_SMALL_ARCHS[i % len(DEFAULT_SMALL_ARCHS)],
                   1 + i % (n_nodes - 1)) for i in range(4)]
    sc = build_scenario(nodes, n_cells=n_nodes, large_nodes=large_nodes,
                        small_plan=small_plan)
    return _finish(sc, "skewed-hetero", seed,
                   {"n_nodes": n_nodes, "skew": skew, "rho": rho,
                    "jitter": jitter},
                   rho, n_ai_requests)
