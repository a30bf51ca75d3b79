"""HAF two-layer controller (paper §III): agentic placement + critic gating.

The placement layer runs at epochs: candidate generation M_k (Eq. §III-A),
agent shortlist A_k = π_LLM(s, M_k) (Eq. 8), critic selection
j* = argmax r̄(r̂_θ(s, a)) (Eq. 11), commit Π(y, a^{(j*)}) (Eq. 12).
The allocation layer is the closed-form deadline-aware solve (§III-C),
wired in by the simulator through :class:`DeadlineAwareAllocation`.

Batched epochs: :meth:`HAFPlacement.decide_group` is the epoch-pipeline
entry point — the engine hands every replica that reached an epoch boundary
this tick (grouped by :meth:`batch_key`), candidate features stack into one
``[B, C, F]`` block, and the critic's frozen net runs once for the whole
group.  :meth:`decide` is the B=1 view of the same code, so a replica's
decision cannot depend on which batch-mates it shipped with.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.core.agent import Agent
from repro_torch.core.critic import Critic
from repro_torch.core.placement import candidate_actions
from repro_torch.faults.errors import LLMEndpointError
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import MigrationAction


class HAFPlacement:
    """The paper's placement layer. ``critic=None`` gives HAF-NoCritic.

    ``fallback_agent`` arms the degradation ladder: when the primary
    agent's shortlist raises :class:`LLMEndpointError` (its retry budget
    is already spent inside the completion callable), the epoch decides
    with the deterministic stand-in instead of propagating — the decision
    is tagged via ``last_degraded`` so the engine counts and traces it.
    """

    def __init__(self, agent: Agent, critic: Optional[Critic] = None,
                 K: int = 3, min_score_margin: float = 0.005,
                 fallback_agent: Optional[Agent] = None):
        self.agent = agent
        self.critic = critic
        self.K = K
        self.min_score_margin = min_score_margin
        self.fallback_agent = fallback_agent
        self.name = f"HAF({agent.name}{'+critic' if critic else ''})"
        self.last_shortlist: List[Optional[MigrationAction]] = []
        self.last_scores = None
        # predicted benefit of the decided action over no-migration
        # (critic score delta) — read by the trace recorder's decision log
        self.last_margin = None
        # degradation reason of the latest decision (None = healthy)
        self.last_degraded: Optional[str] = None

    def batch_key(self) -> tuple:
        """Replicas whose policies share this key decide as one group.

        Deterministic equal-config agents key by config; stateful agents
        (external LLMs) key by instance, so they still flow through the
        batched pipeline but only group with themselves."""
        agent_key = self.agent.batch_key()
        if agent_key is None:
            agent_key = ("agent-inst", id(self.agent))
        critic_fp = self.critic.fingerprint() if self.critic else None
        fb = self.fallback_agent
        fb_key = None if fb is None \
            else (fb.batch_key() or ("agent-inst", id(fb)))
        return (agent_key, critic_fp, self.K, self.min_score_margin, fb_key)

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        return HAFPlacement.decide_group([self], [snap])[0]

    @staticmethod
    def decide_group(policies: Sequence["HAFPlacement"],
                     snaps: Sequence[EpochSnapshot]
                     ) -> List[Optional[MigrationAction]]:
        """One batched placement decision for B compatible replicas.

        Per replica: candidate generation M_k, agent shortlist (stand-ins
        score all candidates in one vectorized pass; external LLMs get one
        completion call each), then ONE padded ``[B, C, F]`` critic
        evaluation scores every replica's shortlist+no-migration options.
        The critic forward is batch-shape invariant, so each replica's
        action is bit-identical to deciding it alone.
        """
        B = len(policies)
        out: List[Optional[MigrationAction]] = [None] * B
        m_ks = [candidate_actions(s) for s in snaps]
        # one shortlist_batch call per compatible agent group: agents
        # sharing a config batch_key (same K) are interchangeable; anything
        # else — mixed direct calls, stateful LLM agents — dispatches per
        # instance, so a replica's shortlist always comes from its own
        # agent's semantics
        shortlists: List = [None] * B
        agent_groups: dict = {}
        for i, pol in enumerate(policies):
            akey = pol.agent.batch_key()
            key = (type(pol.agent), akey, pol.K) if akey is not None \
                else ("inst", id(pol.agent), pol.K)
            agent_groups.setdefault(key, []).append(i)
        degraded: List[Optional[str]] = [None] * B
        for idxs in agent_groups.values():
            lead = policies[idxs[0]]
            try:
                rows = lead.agent.shortlist_batch(
                    [snaps[i] for i in idxs], [m_ks[i] for i in idxs],
                    lead.K)
                reason = None
            except LLMEndpointError as err:
                if lead.fallback_agent is None:
                    raise
                # degradation ladder: the retry budget is spent — this
                # epoch decides with the deterministic stand-in.  A group
                # only ever shares one agent instance (LLM agents key per
                # instance), so the lead's fallback covers the group.
                reason = err.kind
                rows = lead.fallback_agent.shortlist_batch(
                    [snaps[i] for i in idxs], [m_ks[i] for i in idxs],
                    lead.K)
            for i, row in zip(idxs, rows):
                shortlists[i] = row
                degraded[i] = reason
        gated = []                     # (index, options) for critic scoring
        for i, (pol, shortlist) in enumerate(zip(policies, shortlists)):
            pol.last_shortlist = [a for a in shortlist if a is not None]
            pol.last_scores = None
            pol.last_margin = None
            pol.last_degraded = degraded[i]
            if pol.critic is None:
                # HAF-NoCritic: trust the agent's top-ranked candidate
                out[i] = shortlist[0] if shortlist else None
                continue
            # critic scores the shortlist *plus* the no-migration action,
            # so a migration must beat staying put — this is the migration
            # gating the paper credits for the reduced migration counts
            # (Table II).
            options = list(shortlist)
            if None not in options:
                options.append(None)
            gated.append((i, options))
        # one padded [B, C, F] evaluation per distinct critic (an engine
        # group always shares one — the key pins the fingerprint — but
        # direct decide_group calls may mix critics)
        by_critic = {}
        for item in gated:
            fp = policies[item[0]].critic.fingerprint()
            by_critic.setdefault(fp, []).append(item)
        for group in by_critic.values():
            critic = policies[group[0][0]].critic
            choices, score_rows = critic.select_batch(
                [snaps[i] for i, _ in group],
                [options for _, options in group])
            for (i, options), choice, scores in zip(group, choices,
                                                    score_rows):
                pol = policies[i]
                pol.last_scores = scores
                none_idx = options.index(None)
                if choice is None:
                    if len(options) > 1:
                        pol.last_margin = float(
                            max(scores) - scores[none_idx])
                    continue
                # optional hysteresis: require a margin over no-migration
                chosen_idx = options.index(choice)
                pol.last_margin = float(
                    scores[chosen_idx] - scores[none_idx])
                if scores[chosen_idx] < scores[none_idx] \
                        + pol.min_score_margin:
                    continue
                out[i] = choice
        return out


class ScriptedPlacement:
    """Commit scripted actions at given epochs (critic data + tests).

    ``script``: {epoch: (instance_name, dst_node) | None}.  The action is
    resolved against the live candidate set; infeasible entries are skipped.
    """

    def __init__(self, script):
        self.script = dict(script)
        self.name = "scripted"
        self.last_shortlist: List[Optional[MigrationAction]] = []

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        self.last_shortlist = []
        want = self.script.get(snap.epoch)
        if want is None:
            return None
        name, dst = want
        for a in candidate_actions(snap):
            if a is None:
                continue
            if snap.instances[a.sid].name == name and a.dst == dst:
                return a
        return None


class RandomPlacement:
    """Exploration policy used to harvest critic training data.

    ``cooldown`` spaces migrations at least that many epochs apart so the
    multi-interval outcome label of each action is not contaminated by the
    next exploratory action; ``category_bias`` over-samples the decisive
    (expensive) action types so the critic sees their outcomes.
    """

    def __init__(self, seed: int = 0, migrate_prob: float = 0.6,
                 cooldown: int = 4, large_bias: float = 4.0):
        import numpy as np
        self.rng = np.random.default_rng(seed)
        self.migrate_prob = migrate_prob
        self.cooldown = cooldown
        self.large_bias = large_bias
        self._last_mig_epoch = -10**9
        self.name = "random-explore"
        self.last_shortlist: List[Optional[MigrationAction]] = []

    def decide(self, snap: EpochSnapshot) -> Optional[MigrationAction]:
        import numpy as np
        self.last_shortlist = []
        if snap.epoch - self._last_mig_epoch < self.cooldown:
            return None
        m_k = candidate_actions(snap)
        migrations = [a for a in m_k if a is not None]
        if not migrations or self.rng.random() > self.migrate_prob:
            return None
        w = np.array([
            self.large_bias
            if snap.instances[a.sid].category.value == "LARGE_AI" else 1.0
            for a in migrations])
        a = migrations[self.rng.choice(len(migrations), p=w / w.sum())]
        self._last_mig_epoch = snap.epoch
        return a
