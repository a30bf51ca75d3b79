"""Critic training-data generation (paper §III-B offline phase).

Two complementary sources:

1. **Bulk exploration** — RandomPlacement runs across load levels/seeds:
   wide state coverage, but each state sees only the action that was taken.

2. **Counterfactual probes** — the decisive signal.  The simulator is
   deterministic given a workload, so replaying the same requests with a
   ScriptedPlacement that differs *only* in the action at probe epoch k
   yields (s_k, a, r) and (s_k, a', r') with the *identical* state s_k:
   a clean action-contrast the regression can't get from exploration alone.
   Probes cover both the pre-split state (consolidated large-AI) and the
   post-split state (anti-ping-pong: re-consolidating must score worse).

Both sources fan out through ``Simulator.run_batch``: exploration seeds
and probe replays are independent replicas of one scenario, so they
advance as ``[B, S]`` blocks instead of B solo event loops (the samples
are identical either way — the batched engine is discrete-outcome
identical per replica).  :func:`harvest_families` scales this across the
``repro_torch.sim.scenarios`` registry — per-family harvests (``paper``,
``node-outage``, ``flash-crowd``, ``heavy-tail``, …) for multi-family
critic training and held-out-family generalization measurements
(see ``benchmarks/critic_data.py``).
"""
from __future__ import annotations

import hashlib
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.controller import RandomPlacement, ScriptedPlacement
from repro_torch.obs import diag
from repro_torch.core.critic import epoch_records_to_samples
from repro_torch.sim.engine import DeadlineAwareAllocation, Simulator
from repro_torch.sim.scenarios import make_scenario, workload_stream_for
from repro_torch.sim.types import InstanceCategory

# actions probed at each counterfactual epoch (instance name, dst node) —
# written against the paper topology; resolve_probes() filters/derives for
# other topologies
PRE_SPLIT_PROBES: List[Optional[Tuple[str, int]]] = [
    None,
    ("large0", 1), ("large0", 4), ("large0", 5),
    ("large1", 1), ("large1", 4),
    ("du0", 1), ("du3", 0), ("cuup0", 2),
    ("small0", 0), ("small0", 1),
]
POST_SPLIT_PROBES: List[Optional[Tuple[str, int]]] = [
    None,
    ("large1", 1),       # re-consolidate onto n1 (bad)
    ("large0", 0),       # move back (bad)
    ("large0", 4), ("large0", 5),
    ("du4", 0), ("small0", 1), ("cuup2", 0),
]


def resolve_probes(scenario: Dict,
                   probes: Sequence[Optional[Tuple[str, int]]]
                   ) -> List[Optional[Tuple[str, int]]]:
    """Keep probes whose instance / destination exist in this topology.

    Families sharing the paper topology (the default harvest set) keep the
    full list; for other topologies, fall back to a derived set — each
    category's first instance probed toward every foreign node — so the
    counterfactual contrast survives a scaled scenario.
    """
    names = {s.name for s in scenario["instances"]}
    n_nodes = len(scenario["nodes"])
    kept = [p for p in probes
            if p is None or (p[0] in names and p[1] < n_nodes)]
    if len(kept) > 1:
        return kept
    derived: List[Optional[Tuple[str, int]]] = [None]
    for cat in (InstanceCategory.LARGE_AI, InstanceCategory.SMALL_AI,
                InstanceCategory.DU, InstanceCategory.CUUP):
        inst = next((s for s in scenario["instances"]
                     if s.category == cat), None)
        if inst is None:
            continue
        src = scenario["placement"][inst.sid]
        for dst in range(n_nodes):
            if dst != src:
                derived.append((inst.name, dst))
    return derived


def _run_blocks(sim: Simulator, runs: Sequence[Tuple[List, Callable]],
                batch_size: int):
    """Fan (workload, placement-factory) runs into ``run_batch`` blocks.

    ``batch_size <= 1`` keeps the classic per-run solo loop (same
    discrete outcomes; the batch-invariance test pins it)."""
    alloc = DeadlineAwareAllocation
    if batch_size <= 1:
        return [sim.run(wl, make_pol(), alloc()) for wl, make_pol in runs]
    results = []
    for lo in range(0, len(runs), batch_size):
        chunk = runs[lo:lo + batch_size]
        results.extend(sim.run_batch(
            [wl for wl, _ in chunk],
            [make_pol() for _, make_pol in chunk],
            lambda b: alloc()))
    return results


def harvest(scenario: Dict, *, epoch_interval: float = 5.0,
            bulk_runs: Sequence[Tuple[float, int]] = (
                (0.75, 1), (1.0, 2), (1.25, 3), (1.0, 4),
                (0.75, 5), (1.0, 6), (1.25, 7), (1.0, 8)),
            bulk_requests: int = 2500,
            probe_requests: int = 1500,
            probe_epochs_pre: Sequence[int] = (1, 2, 3, 4, 6, 10),
            probe_epochs_post: Sequence[int] = (6, 14),
            label_horizon: Optional[int] = None,
            probe_weight: int = 8,
            batch_size: int = 16,
            engine: Optional[str] = None,
            device="cuda",
            verbose: bool = False) -> List:
    """Returns (φ, r, mask) samples for :func:`repro_torch.core.critic.train_critic`.

    All simulator work fans into batched ``[B, S]`` runs of up to
    ``batch_size`` replicas (``batch_size <= 1`` keeps the solo loop; the
    samples are identical — pinned by tests).  ``engine`` / ``device`` go
    to the :class:`Simulator`: ``engine=None`` runs on ``device`` (batched
    blocks through the ``cuda`` kernel engine, the solo loop through the
    eager ``torch`` engine); ``engine="numpy"`` runs on the host.
    """
    sim = Simulator(scenario, epoch_interval=epoch_interval, engine=engine,
                    device=device)
    samples: List = []

    def log(msg):
        if verbose:
            diag(f"[datagen] {msg}")

    # ---- 1) bulk exploration (one batched block over load × seed) ------- #
    bulk: List[Tuple[List, Callable]] = []
    for rho, seed in bulk_runs:
        # materialized stream: metadata horizon, one shared request list
        # lazily cloned per replica at window-load time
        reqs = workload_stream_for(scenario, seed=seed,
                                   n_ai_requests=bulk_requests,
                                   rho=rho).materialize()
        bulk.append((reqs, lambda seed=seed: RandomPlacement(seed=seed,
                                                             cooldown=8)))
    for res in _run_blocks(sim, bulk, batch_size):
        samples += epoch_records_to_samples(res.epochs, horizon=label_horizon)
    log(f"bulk x{len(bulk)} (batch={batch_size}): {len(samples)} samples")

    # ---- 2) counterfactual probes (batched same-workload replays) -------- #
    # probes replay ONE workload many times: materialize once, every
    # replay clones lazily from the same list
    reqs = workload_stream_for(scenario, seed=42,
                               n_ai_requests=probe_requests,
                               rho=1.0).materialize()

    def collect(res, k: int, action) -> None:
        all_s = epoch_records_to_samples(res.epochs, horizon=label_horizon)
        # keep only the probe-epoch sample (clean counterfactual) plus the
        # prefix epochs once (they are identical across actions — dedup by
        # only keeping them for the None action)
        recs = [r for r in res.epochs if r.fulfill is not None]
        for i, rec in enumerate(recs):
            if rec.epoch == k:
                # clean counterfactual: upweight against the bulk data
                samples.extend([all_s[i]] * probe_weight)
            elif action is None and rec.epoch < k:
                samples.append(all_s[i])

    def probe_block(prefix: Dict, epochs: Sequence[int],
                    probes: Sequence) -> None:
        plan = []
        runs: List[Tuple[List, Callable]] = []
        for k in epochs:
            for action in probes:
                script = dict(prefix)
                if action is not None:
                    script[k] = action
                plan.append((k, action))
                runs.append((reqs,
                             lambda script=script: ScriptedPlacement(script)))
        for (k, action), res in zip(plan, _run_blocks(sim, runs,
                                                      batch_size)):
            collect(res, k, action)

    pre = resolve_probes(scenario, PRE_SPLIT_PROBES)
    probe_block({}, probe_epochs_pre, pre)
    log(f"pre-split probes @ {tuple(probe_epochs_pre)}: "
        f"{len(samples)} samples")

    split_prefix = {1: pre[1]} if len(pre) > 1 else {}
    post = resolve_probes(scenario, POST_SPLIT_PROBES)
    probe_block(split_prefix, probe_epochs_post, post)
    log(f"post-split probes @ {tuple(probe_epochs_post)}: "
        f"{len(samples)} samples")

    return samples


# scenario families harvested by default: the paper baseline plus the
# stress families whose migration outcomes the critic must generalize to
DEFAULT_FAMILIES = ("paper", "node-outage", "flash-crowd", "heavy-tail")


def harvest_families(families: Sequence[str] = DEFAULT_FAMILIES, *,
                     scenario_seed: int = 0,
                     scenario_params: Optional[Dict[str, Dict]] = None,
                     verbose: bool = False,
                     **harvest_kw) -> Dict[str, List]:
    """Per-family (φ, r, mask) sample sets across the scenario registry.

    Returns ``{family: samples}`` so callers can train on any subset —
    the all-family critic, or the leave-one-out critics the held-out
    generalization evaluation needs.  ``scenario_params[family]`` forwards
    family-specific knobs to :func:`make_scenario`.
    """
    out: Dict[str, List] = {}
    params = scenario_params or {}
    for family in families:
        sc = make_scenario(family, seed=scenario_seed,
                           **params.get(family, {}))
        if verbose:
            diag(f"[datagen] harvesting family {family!r}")
        out[family] = harvest(sc, verbose=verbose, **harvest_kw)
        if verbose:
            diag(f"[datagen] {family}: {len(out[family])} samples")
    return out


def merge_samples(per_family: Dict[str, List],
                  exclude: Sequence[str] = ()) -> List:
    """Flatten per-family samples, optionally holding families out."""
    out: List = []
    for family, samples in per_family.items():
        if family in exclude:
            continue
        out.extend(samples)
    return out


def samples_fingerprint(samples: Sequence[Tuple]) -> str:
    """Content hash of a (φ, r, mask) training set.

    Artifact manifests (:mod:`repro_torch.exp.artifacts`) record it as the
    ``data_hash`` — two critics trained from byte-identical harvests carry
    the same hash, so a manifest ties a deployed critic back to exactly
    the data that produced it.
    """
    h = hashlib.sha256()
    h.update(str(len(samples)).encode())
    for tup in samples:
        for arr in tup:
            a = np.ascontiguousarray(np.asarray(arr, np.float32))
            h.update(str(a.shape).encode())
            h.update(a.tobytes())
    return h.hexdigest()
