"""Scenario-generation subsystem: parameterized, seeded scenario families.

Usage::

    from repro_torch.sim.scenarios import make_scenario, workload_for

    sc = make_scenario("flash-crowd", seed=3, magnitude=6.0)
    requests, info = workload_for(sc, seed=7)
    res = Simulator(sc).run(requests, placement, allocation)

Families (see :mod:`repro_torch.sim.scenarios.families` for parameters):
``paper``, ``dense-urban``, ``diurnal``, ``flash-crowd``,
``diurnal-flash`` (composed profile), ``heavy-tail``, ``trace``
(CSV/JSONL cluster-trace replay), ``node-outage``, ``skewed-hetero``.
All generators are deterministic in (seed, params);
:func:`scenario_fingerprint` certifies it.  :func:`workload_stream_for`
is the chunked-stream realization (O(window) memory);
:func:`workload_for` is its materialized view.
"""
from repro_torch.sim.scenarios.registry import (REGISTRY, family_names,
                                          make_scenario, register,
                                          scenario_fingerprint)
from repro_torch.sim.scenarios.builder import (build_scenario,
                                         effective_ai_capacity,
                                         validate_scenario)
from repro_torch.sim.scenarios.workload import (estimated_horizon, workload_config,
                                          workload_for, workload_stream_for)
from repro_torch.sim.scenarios import families  # noqa: F401  (populates REGISTRY)

__all__ = [
    "REGISTRY", "family_names", "make_scenario", "register",
    "scenario_fingerprint", "build_scenario", "effective_ai_capacity",
    "validate_scenario", "estimated_horizon", "workload_config",
    "workload_for", "workload_stream_for", "families",
]
