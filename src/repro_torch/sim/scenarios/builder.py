"""Topology builder shared by the scenario families.

Every family assembles the same scenario dict :func:`paper_scenario`
emits (nodes / instances / placement / work_models / service_sids /
delays), optionally extended with the registry metadata keys the
:mod:`repro_torch.eval` harness reads:

  ``meta``      {"family", "seed", "params"} — provenance
  ``workload``  plain-dict workload recipe (see scenarios/workload.py)
  ``outages``   [[node, t_start, t_end], ...] availability windows

The ``Simulator`` consumes the core keys directly and ignores the rest
(except ``outages``, which the engine schedules as fault events).
"""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.configs import get_config
from repro_torch.sim.scenario import (R_LARGE_AI, R_RAN, R_SMALL_AI,
                                RAN_PACKET_DELAY, TRANSPORT_DELAY,
                                work_model_for)
from repro_torch.sim.types import (GB, TFLOPS, InstanceCategory, InstanceSpec,
                             NodeSpec)

# reference node archetypes (Table I); families may jitter the capacities
NODE_KINDS: Dict[str, Tuple[float, float, float]] = {
    "gpu-heavy": (200 * TFLOPS, 32, 80 * GB),
    "cpu-heavy": (40 * TFLOPS, 128, 24 * GB),
    "balanced": (120 * TFLOPS, 64, 48 * GB),
}

DEFAULT_LARGE_ARCH = "phi3-medium-14b"
DEFAULT_SMALL_ARCHS = ("qwen2-0.5b", "mamba2-130m")

# Table I γ_q (transient KV) ranges per service class
LARGE_KV = (0.4 * GB, 0.6 * GB)
SMALL_KV = {"qwen2-0.5b": (0.01 * GB, 0.04 * GB),
            "mamba2-130m": (0.005 * GB, 0.01 * GB)}


def make_node(name: str, kind: str, scale: float = 1.0) -> NodeSpec:
    """One node of a reference archetype, capacities scaled by ``scale``."""
    g, c, v = NODE_KINDS[kind]
    return NodeSpec(name, kind, g * scale, c * scale, v * scale)


def default_work_models() -> Dict[str, List]:
    """The paper's service mix: one large-AI arch + two small-AI archs."""
    return {
        "large": [work_model_for(DEFAULT_LARGE_ARCH, LARGE_KV)],
        "small": [work_model_for(a, SMALL_KV[a], context_len=256)
                  for a in DEFAULT_SMALL_ARCHS],
    }


def build_scenario(nodes: Sequence[NodeSpec],
                   n_cells: int,
                   large_nodes: Sequence[int],
                   small_plan: Sequence[Tuple[str, int]],
                   ran_node_of: Optional[Callable[[int], int]] = None,
                   large_arch: str = DEFAULT_LARGE_ARCH,
                   work_models: Optional[Dict] = None) -> Dict:
    """Assemble the Simulator scenario dict from a topology plan.

    ``large_nodes``: one entry per large-AI replica (its home node).
    ``small_plan``: (arch, node) per small-AI replica.
    ``ran_node_of``: cell -> node for its DU/CU-UP pair (default c % N).
    """
    nodes = list(nodes)
    N = len(nodes)
    if ran_node_of is None:
        ran_node_of = lambda c: c % N  # noqa: E731

    instances: List[InstanceSpec] = []
    placement: List[int] = []
    sid = 0
    for cell in range(n_cells):
        n = int(ran_node_of(cell))
        instances.append(InstanceSpec(
            sid=sid, name=f"du{cell}", category=InstanceCategory.DU,
            weight_bytes=2 * GB, reconfig_s=R_RAN, cell=cell))
        placement.append(n)
        sid += 1
        instances.append(InstanceSpec(
            sid=sid, name=f"cuup{cell}", category=InstanceCategory.CUUP,
            weight_bytes=0.0, reconfig_s=R_RAN, cell=cell))
        placement.append(n)
        sid += 1

    large_cfg = get_config(large_arch)
    for i, n in enumerate(large_nodes):
        instances.append(InstanceSpec(
            sid=sid, name=f"large{i}", category=InstanceCategory.LARGE_AI,
            weight_bytes=float(large_cfg.weight_bytes()),
            reconfig_s=R_LARGE_AI, arch=large_arch))
        placement.append(int(n))
        sid += 1

    for i, (arch, n) in enumerate(small_plan):
        cfg = get_config(arch)
        instances.append(InstanceSpec(
            sid=sid, name=f"small{i}", category=InstanceCategory.SMALL_AI,
            weight_bytes=float(cfg.weight_bytes()),
            reconfig_s=R_SMALL_AI, arch=arch))
        placement.append(int(n))
        sid += 1

    service_sids: Dict[str, List[int]] = {}
    for s in instances:
        if s.category.is_ai:
            service_sids.setdefault(s.arch, []).append(s.sid)

    sc = {
        "nodes": nodes,
        "instances": instances,
        "placement": placement,
        "work_models": work_models or default_work_models(),
        "service_sids": service_sids,
        "transport_delay": TRANSPORT_DELAY,
        "ran_packet_delay": RAN_PACKET_DELAY,
    }
    validate_scenario(sc)
    return sc


def effective_ai_capacity(nodes: Sequence[NodeSpec],
                          reserve: float = 0.2) -> float:
    """G in the ρ definition: the GPU-heavy pool after the RAN floor
    reservation (the paper provisions 2×200 TF → 320 TF at reserve=0.2)."""
    gpu = sum(n.gpu_flops for n in nodes if n.kind == "gpu-heavy")
    if gpu == 0.0:                      # no gpu-heavy tier: use the best node
        gpu = max(n.gpu_flops for n in nodes)
    return (1.0 - reserve) * gpu


def validate_scenario(sc: Dict) -> None:
    """Structural invariants every generated scenario must satisfy."""
    nodes, instances = sc["nodes"], sc["instances"]
    placement = sc["placement"]
    N = len(nodes)
    assert len(placement) == len(instances), "placement/instance mismatch"
    for i, (s, n) in enumerate(zip(instances, placement)):
        assert 0 <= n < N, f"{s.name} placed on nonexistent node {n}"
        assert s.sid == i, "sids must be dense and ordered"

    # every cell referenced by an instance has a full DU + CU-UP pair
    cells = {s.cell for s in instances if s.cell >= 0}
    by_cat = {}
    for s in instances:
        by_cat.setdefault((s.category, s.cell), []).append(s)
    for c in sorted(cells):
        assert (InstanceCategory.DU, c) in by_cat, f"cell {c} has no DU"
        assert (InstanceCategory.CUUP, c) in by_cat, f"cell {c} has no CU-UP"

    # initial weights fit in VRAM on every node (Eq. 4 at t=0)
    used = [0.0] * N
    for s, n in zip(instances, placement):
        used[n] += s.weight_bytes
    for n in range(N):
        assert used[n] <= nodes[n].vram_bytes, (
            f"node {nodes[n].name}: initial weights {used[n] / GB:.1f} GB "
            f"exceed VRAM {nodes[n].vram_bytes / GB:.1f} GB")

    # RAN floors realizable: DU hosts need GPU, CU-UP hosts need CPU
    for s, n in zip(instances, placement):
        if s.category == InstanceCategory.DU:
            assert nodes[n].gpu_flops > 0, f"{s.name} on GPU-less node"
        elif s.category == InstanceCategory.CUUP:
            assert nodes[n].cpu_cores > 0, f"{s.name} on CPU-less node"

    # service_sids covers exactly the AI instances
    listed = sorted(sid for sids in sc["service_sids"].values()
                    for sid in sids)
    ai = sorted(s.sid for s in instances if s.category.is_ai)
    assert listed == ai, "service_sids inconsistent with AI instances"
    for arch, sids in sc["service_sids"].items():
        for sid in sids:
            assert instances[sid].arch == arch, "service_sids arch mismatch"
