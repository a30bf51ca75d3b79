"""Candidate migration generation M_k (paper §III-A).

Single-instance migrations relative to the inherited placement, filtered for
feasibility against the VRAM constraint (Eq. 4) and in-flight
reconfigurations, plus the explicit no-migration option:
|M_k| ≤ |S^M|·(|N|−1) + 1.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import InstanceCategory, MigrationAction

# S^M: categories eligible for migration (all; the critic / agents learn to
# avoid the expensive ones, as the paper's Table II migration counts show).
MOVABLE = (InstanceCategory.DU, InstanceCategory.CUUP,
           InstanceCategory.LARGE_AI, InstanceCategory.SMALL_AI)


def candidate_actions(snap: EpochSnapshot,
                      movable=MOVABLE) -> List[Optional[MigrationAction]]:
    """Feasible single-instance migrations + the no-migration option."""
    out: List[Optional[MigrationAction]] = [None]
    headroom = snap.vram_headroom
    for inst in snap.instances:
        if inst.category not in movable or not inst.movable:
            continue
        if snap.t < snap.reconfig_until[inst.sid]:
            continue          # already undergoing reconfiguration
        src = snap.node_of(inst.sid)
        need = inst.weight_bytes + float(snap.kv_held[inst.sid])
        for dst in range(snap.N):
            if dst == src:
                continue
            if headroom[dst] < need:
                continue      # violates Eq. 4 at the destination
            out.append(MigrationAction(sid=inst.sid, src=src, dst=dst))
    return out


def action_id(a: Optional[MigrationAction]) -> str:
    if a is None:
        return "no-migration"
    return f"mig:s{a.sid}:n{a.src}->n{a.dst}"


def parse_action_id(token: str, candidates) -> Optional[MigrationAction]:
    """Inverse of ``action_id`` restricted to the candidate set."""
    by_id = {action_id(a): a for a in candidates}
    return by_id.get(token.strip(), None)
