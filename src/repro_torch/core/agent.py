"""LLM placement agents π_LLM (paper §III-A, Eq. 8).

``ExternalLLMAgent`` drives any real LLM through ``callable(prompt) -> str``
with the structured prompt of :mod:`repro_torch.core.prompts` — this is the
deployment path.  No model is fetched, so experiments use deterministic
**agent stand-ins** that emulate the paper's five open-source agents as
policy-quality variants (scoring depth / noise / priority distortions).
Table-II-style ablations therefore compare stand-ins; the critic mechanism
itself (the paper's claim) is exercised unchanged.

The stand-in scoring mirrors the prompt's ordered priorities: P1 protect RAN
floors, P2 relieve AI contention toward headroom, P3 charge the R_s outage.
It is vectorized over the candidate set (:meth:`HeuristicAgent.
score_candidates` evaluates all |M_k| migrations as one ``[C]`` numpy pass),
and :meth:`Agent.shortlist_batch` is the epoch-pipeline entry point: the
batched engine hands every replica's (snapshot, candidates) at once.
Stand-ins shortlist each replica from the vectorized scorer;
``ExternalLLMAgent`` inherits the per-replica fallback (one completion call
per snapshot) so the interface stays uniform.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import prompts
from repro_torch.core.placement import action_id
from repro_torch.faults.errors import MalformedShortlistError
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import MigrationAction

Shortlist = List[Optional[MigrationAction]]


class Agent:
    name: str = "agent"

    def shortlist(self, snap: EpochSnapshot,
                  candidates: Sequence[Optional[MigrationAction]],
                  K: int = 3) -> Shortlist:
        raise NotImplementedError

    def shortlist_batch(self, snaps: Sequence[EpochSnapshot],
                        candidates_list: Sequence[Sequence],
                        K: int = 3) -> List[Shortlist]:
        """Shortlists for B replicas' epoch snapshots at once.

        The default loops :meth:`shortlist` per replica — correct for any
        agent (external LLMs fall back to one call per replica).  Results
        must be independent of how replicas are grouped into a batch.
        """
        return [self.shortlist(s, c, K)
                for s, c in zip(snaps, candidates_list)]

    def batch_key(self) -> Optional[tuple]:
        """Config identity for cross-replica grouping.

        Replicas whose agents share a key may be decided by one batched
        evaluation (the agents must be interchangeable: deterministic and
        equal-configured).  ``None`` (the default) means this agent has
        per-instance state or external side effects, so the epoch pipeline
        keys the group to the instance instead."""
        return None


class ExternalLLMAgent(Agent):
    """Adapter for a real LLM: prompt in, validated ordered shortlist out."""

    def __init__(self, complete: Callable[[str], str], name: str = "llm"):
        self.complete = complete
        self.name = name
        self.last_prompt: Optional[str] = None
        self.last_response: Optional[str] = None

    def shortlist(self, snap, candidates, K=3):
        prompt = prompts.build_prompt(snap, candidates, K)
        self.last_prompt = prompt
        text = self.complete(prompt)
        self.last_response = text
        out = prompts.parse_response(text, candidates, K)
        if not out:
            # nothing in the reply maps to a candidate: a garbage or
            # truncated completion, NOT a "no migration" choice (that
            # parses as [None]) — raise the typed taxonomy error so the
            # controller can degrade instead of silently staying put
            tail = (text or "").strip()[-200:]
            raise MalformedShortlistError(
                "LLM reply contained no recognizable shortlist"
                + (f": ...{tail!r}" if tail else " (empty reply)"))
        return out


# --------------------------------------------------------------------------- #
# deterministic stand-ins
# --------------------------------------------------------------------------- #
@dataclasses.dataclass
class StandInProfile:
    """Quality knobs that differentiate the emulated agents."""
    noise: float = 0.0            # score jitter (ranking errors)
    ran_weight: float = 1.0       # P1 fidelity
    outage_weight: float = 1.0    # P3 fidelity (0 => ignores R_s)
    eagerness: float = 0.0        # constant bonus for migrating at all
    threshold: float = 0.25       # min score to propose a migration at all


class HeuristicAgent(Agent):
    """Deterministic stand-in scoring candidates by the P1–P3 priorities."""

    def __init__(self, name: str = "heuristic",
                 profile: StandInProfile = StandInProfile(), seed: int = 0):
        self.name = name
        self.profile = profile
        self.seed = seed

    def batch_key(self) -> tuple:
        return ("stand-in", self.name, self.seed,
                dataclasses.astuple(self.profile))

    # -- the P1-P3 value model ------------------------------------------- #
    def score_candidates(self, snap: EpochSnapshot,
                         migrations: Sequence[MigrationAction]) -> np.ndarray:
        """P1–P3 scores for every migration candidate as one ``[C]`` pass.

        This is the canonical scorer: the solo and batched decide paths
        both rank from these values, so batching cannot change outcomes.
        """
        C = len(migrations)
        if not C:
            return np.zeros(0)
        p = self.profile
        insts = [snap.instances[a.sid] for a in migrations]
        sids = np.array([a.sid for a in migrations], np.int64)
        srcs = np.array([a.src for a in migrations], np.int64)
        dsts = np.array([a.dst for a in migrations], np.int64)
        gflops = np.array([n.gpu_flops for n in snap.nodes], np.float64)
        ccores = np.array([n.cpu_cores for n in snap.nodes], np.float64)
        psi_s = snap.psi_g[sids].astype(np.float64)
        psi_c_s = snap.psi_c[sids].astype(np.float64)

        # P2 (GPU): contention differential the service experiences, gated
        # by its own demand (a tiny DU gains nothing from fleeing a hot
        # node; a backlogged large-AI gains everything).  Pressure combines
        # standing backlog with allocated utilization (streams that drain
        # fast leave no backlog but still occupy the node), and moving to a
        # smaller node slows the service's own backlog down.
        node_psi_g = snap.psi_g_by_node()
        src_others = ((node_psi_g[srcs] - psi_s) / np.maximum(gflops[srcs],
                                                             1.0)
                      + 0.5 * snap.gpu_util[srcs])
        dst_others = ((node_psi_g[dsts]
                       - np.where(srcs == dsts, psi_s, 0.0))
                      / np.maximum(gflops[dsts], 1.0)
                      + 0.5 * snap.gpu_util[dsts])
        own_slowdown = psi_s / gflops[dsts] - psi_s / gflops[srcs]
        scale_g = np.tanh(psi_s / gflops[srcs])
        relief = scale_g * (src_others - dst_others - own_slowdown)

        # P2 (CPU): same shape for CPU-bound instances (CU-UP)
        scale_c = np.tanh(psi_c_s / ccores[srcs])
        cpu_relief = scale_c * (snap.cpu_util[srcs] - snap.cpu_util[dsts]
                                - (psi_c_s / ccores[dsts]
                                   - psi_c_s / ccores[srcs]))

        # P1: RAN protection — penalize moving load onto RAN-floored nodes;
        # moving an AI service *off* a RAN-floored node relieves contention
        # for that node's DU/CU-UP (RAN instances gain nothing by fleeing —
        # their floors travel with them).
        ran_risk = snap.ran_floor_g[dsts] + snap.ran_floor_c[dsts]
        not_ran = np.array([not i.category.is_ran for i in insts])
        ran_relief = np.where(not_ran,
                              snap.ran_floor_g[srcs] + snap.ran_floor_c[srcs],
                              0.0)
        p1 = p.ran_weight * (0.3 * ran_relief - 1.0 * ran_risk)

        # P3: reconfiguration cost — R_s scaled by how much traffic the
        # service sees (arrival pressure) and its current urgency
        rcfg = np.array([i.reconfig_s for i in insts], np.float64)
        rates = np.array([snap.arrival_rate.get(i.arch, 0.0) for i in insts],
                         np.float64)
        outage = p.outage_weight * rcfg * (0.05 + 0.02 * rates)

        return relief + cpu_relief + p1 - outage + p.eagerness

    def _score(self, snap: EpochSnapshot,
               a: Optional[MigrationAction]) -> float:
        if a is None:
            return 0.0
        return float(self.score_candidates(snap, [a])[0])

    def _jitter(self, snap: EpochSnapshot, a, scale: float) -> float:
        if scale <= 0:
            return 0.0
        key = f"{self.name}:{self.seed}:{snap.epoch}:{action_id(a)}"
        h = int(hashlib.sha256(key.encode()).hexdigest()[:8], 16)
        return (h / 0xFFFFFFFF - 0.5) * 2 * scale

    def shortlist(self, snap, candidates, K=3):
        migrations = [a for a in candidates if a is not None]
        base = self.score_candidates(snap, migrations)
        scored: List[Tuple[float, MigrationAction]] = [
            (float(s) + self._jitter(snap, a, self.profile.noise), a)
            for s, a in zip(base, migrations)]
        scored.sort(key=lambda x: -x[0])
        # propose migrations only above the confidence threshold; always keep
        # the no-migration option in the list (mirrors LLM hedging)
        top = [a for sc, a in scored[:K - 1] if sc > self.profile.threshold]
        top.append(None)
        return top


# The five emulated open-source agents from Table II, as quality variants.
AGENT_ZOO = {
    "qwen3-32b-sim": StandInProfile(noise=0.10),
    "gpt-oss-20b-sim": StandInProfile(noise=0.15),
    "qwen2.5-72b-sim": StandInProfile(noise=0.35, ran_weight=0.7),
    "deepseek-r1-70b-sim": StandInProfile(noise=0.25, outage_weight=0.1,
                                          eagerness=0.2, threshold=0.1),
    "gpt-oss-120b-sim": StandInProfile(noise=0.20, ran_weight=0.3,
                                       outage_weight=0.4, threshold=0.15),
}


def make_agent(name: str, seed: int = 0) -> Agent:
    if name not in AGENT_ZOO:
        raise KeyError(f"unknown stand-in {name!r}; known: {list(AGENT_ZOO)}")
    return HeuristicAgent(name=name, profile=AGENT_ZOO[name], seed=seed)
