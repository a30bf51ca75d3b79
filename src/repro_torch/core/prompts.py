"""Structured prompt for the LLM placement agent (paper §III-A).

Three components, exactly as the paper specifies:
  1. system policy — the formulation's ordered decision priorities,
  2. per-epoch state snapshot — feasibility and contention signals,
  3. the candidate action set M_k — the identifiers the agent may select.

The agent must answer with a JSON list of ≤ K candidate identifiers, ordered
best-first.  ``parse_response`` validates against M_k (robust to markdown
fences and prose around the JSON).
"""
from __future__ import annotations

import json
import re
from typing import List, Optional, Sequence

from repro_torch.core.placement import action_id
from repro_torch.sim.snapshot import EpochSnapshot
from repro_torch.sim.types import MigrationAction

SYSTEM_POLICY = """\
You are the slow-timescale placement controller of an AI-RAN edge cluster.
GPU/CPU/VRAM are shared between hard-real-time RAN functions (DU: GPU-bound
PHY/MAC; CU-UP: CPU-bound PDCP) and elastic AI inference services.  Once you
commit a placement it is held for the next interval; a fast closed-form
allocator handles per-request GPU/CPU shares underneath you.

Decide which single migration (or none) to apply, following these ordered
priorities:
  P1. Protect RAN-only deadline satisfaction: never overload a node's GPU/CPU
      so that its DU/CU-UP capacity floors cannot be met.
  P2. Improve end-to-end AI request fulfillment: move AI services away from
      contended nodes toward nodes with spare GPU, CPU and VRAM headroom;
      split co-located heavy services that exceed their node's capacity.
  P3. Account for reconfiguration cost: a migrated instance is OFFLINE for
      its reload time R_s (large-AI ~8 s, small-AI ~0.5 s, RAN ~0.05 s).
      Only migrate when the expected SLO gain over the interval outweighs
      the interruption.

Answer with a JSON array of at most {K} candidate identifiers from the
CANDIDATE ACTIONS list, ordered from most to least promising.  Always
include only identifiers that appear in the list.  Example:
["mig:s12:n0->n1", "no-migration"]
"""


def _fmt_bytes(b: float) -> str:
    return f"{b / 1024**3:.1f}GB"


def state_snapshot_text(snap: EpochSnapshot) -> str:
    lines = [f"TIME t={snap.t:.1f}s  epoch={snap.epoch}", "", "NODES:"]
    for n, node in enumerate(snap.nodes):
        residents = [snap.instances[s].name for s in range(snap.S)
                     if snap.placement[s] == n]
        lines.append(
            f"  n{n} [{node.kind}] gpu_util={snap.gpu_util[n]:.2f} "
            f"cpu_util={snap.cpu_util[n]:.2f} "
            f"ran_floor_gpu={snap.ran_floor_g[n]:.2f} "
            f"vram_free={_fmt_bytes(snap.vram_headroom[n])} "
            f"hosts={','.join(residents) or '-'}")
    lines.append("")
    lines.append("INSTANCES (backlog = queued work in node-GPU-seconds):")
    for s, inst in enumerate(snap.instances):
        n = snap.node_of(s)
        backlog_s = snap.psi_g[s] / max(snap.nodes[n].gpu_flops, 1.0)
        reconf = ""
        if snap.t < snap.reconfig_until[s]:
            reconf = f" RECONFIGURING(until t={snap.reconfig_until[s]:.1f})"
        lines.append(
            f"  {inst.name} [{inst.category.value}] on n{n} "
            f"queue={int(snap.queue_len[s])} backlog={backlog_s:.2f}s "
            f"urgency={snap.omega[s]:.1f} "
            f"kv={_fmt_bytes(snap.kv_held[s])} "
            f"weights={_fmt_bytes(inst.weight_bytes)} "
            f"R_s={inst.reconfig_s:.2f}s{reconf}")
    lines.append("")
    rf = snap.recent_fulfill
    lines.append(
        "RECENT SLO FULFILLMENT (last interval): "
        f"large-AI={rf.get('LARGE_AI', 1.0):.2f} "
        f"small-AI={rf.get('SMALL_AI', 1.0):.2f} "
        f"RAN={rf.get('RAN', 1.0):.2f}")
    return "\n".join(lines)


def candidate_list_text(snap: EpochSnapshot,
                        candidates: Sequence[Optional[MigrationAction]]
                        ) -> str:
    lines = ["CANDIDATE ACTIONS (choose identifiers from this list only):"]
    for a in candidates:
        if a is None:
            lines.append("  no-migration : keep the current placement")
            continue
        inst = snap.instances[a.sid]
        head = _fmt_bytes(snap.vram_headroom[a.dst])
        lines.append(
            f"  {action_id(a)} : move {inst.name} "
            f"[{inst.category.value}, R_s={inst.reconfig_s:.2f}s] "
            f"n{a.src}->n{a.dst} "
            f"(dest gpu_util={snap.gpu_util[a.dst]:.2f} "
            f"cpu_util={snap.cpu_util[a.dst]:.2f} vram_free={head})")
    return "\n".join(lines)


def build_prompt(snap: EpochSnapshot,
                 candidates: Sequence[Optional[MigrationAction]],
                 K: int = 3) -> str:
    return "\n\n".join([
        SYSTEM_POLICY.format(K=K),
        state_snapshot_text(snap),
        candidate_list_text(snap, candidates),
    ])


_JSON_RE = re.compile(r"\[[^\[\]]*\]", re.S)


def parse_response(text: str,
                   candidates: Sequence[Optional[MigrationAction]],
                   K: int = 3) -> List[Optional[MigrationAction]]:
    """Validate an LLM reply into an ordered shortlist A_k ⊆ M_k, |A_k| ≤ K."""
    by_id = {action_id(a): a for a in candidates}
    tokens: List[str] = []
    m = _JSON_RE.search(text or "")
    if m:
        try:
            arr = json.loads(m.group(0))
            tokens = [str(x) for x in arr]
        except json.JSONDecodeError:
            tokens = []
    if not tokens:   # fall back to scanning for identifiers in prose
        tokens = re.findall(r"mig:s\d+:n\d+->n\d+|no-migration", text or "")
    out: List[Optional[MigrationAction]] = []
    seen = set()
    for tok in tokens:
        tok = tok.strip()
        if tok in by_id and tok not in seen:
            out.append(by_id[tok])
            seen.add(tok)
        if len(out) >= K:
            break
    return out
