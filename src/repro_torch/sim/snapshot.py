"""Epoch snapshot: the system state s_{t_k} handed to the placement layer.

Pure data (numpy arrays + specs) so that agents, prompts, and the critic all
read the same observation — nothing reaches into live simulator internals.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sim.types import InstanceSpec, MigrationAction, NodeSpec


@dataclasses.dataclass
class EpochSnapshot:
    t: float
    epoch: int
    nodes: List[NodeSpec]
    instances: List[InstanceSpec]
    placement: np.ndarray            # [S] node index
    reconfig_until: np.ndarray       # [S]
    # node-level
    gpu_util: np.ndarray             # [N] Σ alloc / G_n
    cpu_util: np.ndarray             # [N]
    ran_floor_g: np.ndarray          # [N] RAN floor fraction of G_n
    ran_floor_c: np.ndarray          # [N]
    vram_used: np.ndarray            # [N] bytes
    vram_headroom: np.ndarray        # [N] bytes
    # instance-level
    queue_len: np.ndarray            # [S]
    psi_g: np.ndarray                # [S] backlog FLOPs
    psi_c: np.ndarray                # [S] backlog core-s
    omega: np.ndarray                # [S] urgency
    alloc_g: np.ndarray              # [S]
    alloc_c: np.ndarray              # [S]
    kv_held: np.ndarray              # [S] bytes
    # recent outcomes over the last interval (class-resolved)
    recent_fulfill: Dict[str, float] = dataclasses.field(default_factory=dict)
    arrival_rate: Dict[str, float] = dataclasses.field(default_factory=dict)
    # time-varying capacity view (spot churn): per-node effective-capacity
    # scale (1 = full, 0 = departed) and the preemption-notice horizon
    # (node n is draining while t < drain_until[n]).  ``None`` on
    # hand-built snapshots keeps every pre-churn consumer byte-identical.
    node_scale: Optional[np.ndarray] = None  # [N]
    drain_until: Optional[np.ndarray] = None  # [N]

    @property
    def N(self) -> int:
        return len(self.nodes)

    @property
    def S(self) -> int:
        return len(self.instances)

    def node_of(self, sid: int) -> int:
        return int(self.placement[sid])

    def psi_g_by_node(self) -> np.ndarray:
        """Per-node Σ Ψ^g ``[N]``, accumulated in sid order (cached).

        The batched epoch pipeline reads this once per snapshot — the
        agents' P2 pressure terms and the critic's node feature blocks
        both derive from it, so they cannot disagree on the aggregate.
        The unbuffered ``np.add.at`` gives each node its instances'
        backlogs in ascending-sid order: the same addition sequence a
        per-node Python loop produces, hence the same doubles.
        """
        cached = getattr(self, "_psi_g_by_node", None)
        if cached is None:
            cached = np.zeros(self.N)
            np.add.at(cached, self.placement, self.psi_g.astype(np.float64))
            self._psi_g_by_node = cached
        return cached

    def gpu_demand_frac(self, sid: int) -> float:
        """Service backlog vs its node's GPU capacity (contention proxy)."""
        n = self.node_of(sid)
        return float(self.psi_g[sid] / max(self.nodes[n].gpu_flops, 1.0))

    def apply(self, action: Optional[MigrationAction]) -> np.ndarray:
        """Π(y, a): the placement vector after applying the action."""
        y = self.placement.copy()
        if action is not None:
            y[action.sid] = action.dst
        return y
