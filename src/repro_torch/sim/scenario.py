"""The paper's evaluation scenario (Table I), derived from real arch configs.

6 heterogeneous nodes (2 GPU-heavy, 2 CPU-heavy, 2 balanced), 6 cells with a
DU + CU-UP pair each, 2 large-AI replicas (phi3-medium-14b — 28 GB bf16
weights, exactly the paper's "large-AI model weight 28 GB") and 4 small-AI
replicas (qwen2-0.5b ×2, mamba2-130m ×2, sub-GB weights).  Migration delays:
~8 s large-AI reload, ~0.5 s small-AI, ~0.05 s RAN reinit.

Initial placement is a consolidated deploy: both large-AI replicas on the
first GPU-heavy node — the realistic "AI rack" configuration whose repair
requires a *large-AI* migration, which is precisely the behaviour Table III
separates HAF from the baselines on.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.configs import get_config
from repro_torch.sim.types import (GB, TFLOPS, InstanceCategory, InstanceSpec,
                             NodeSpec)
from repro_torch.sim.workload import ServiceWorkModel

TRANSPORT_DELAY = 200e-6          # δ, one-way per hop (Table I)
RAN_PACKET_DELAY = 300e-6         # RAN-stage packet processing inside δ_q

# Migration delays R_s (Table I)
R_LARGE_AI = 8.0
R_SMALL_AI = 0.5
R_RAN = 0.05


def work_model_for(arch: str, kv_range: Tuple[float, float],
                   context_len: int = 2048) -> ServiceWorkModel:
    """Derive the per-token request cost from the real ArchConfig."""
    cfg = get_config(arch)
    return ServiceWorkModel(
        arch=arch,
        flops_per_token=cfg.flops_per_token(context_len=context_len),
        cpu_secs_per_req=1e-4,
        kv_bytes_per_req=kv_range,
    )


def paper_scenario() -> Dict:
    """Returns {nodes, instances, placement, work_models, ...}."""
    nodes: List[NodeSpec] = [
        NodeSpec("n0-gpu", "gpu-heavy", 200 * TFLOPS, 32, 80 * GB),
        NodeSpec("n1-gpu", "gpu-heavy", 200 * TFLOPS, 32, 80 * GB),
        NodeSpec("n2-cpu", "cpu-heavy", 40 * TFLOPS, 128, 24 * GB),
        NodeSpec("n3-cpu", "cpu-heavy", 40 * TFLOPS, 128, 24 * GB),
        NodeSpec("n4-bal", "balanced", 120 * TFLOPS, 64, 48 * GB),
        NodeSpec("n5-bal", "balanced", 120 * TFLOPS, 64, 48 * GB),
    ]

    instances: List[InstanceSpec] = []
    sid = 0
    # one DU + CU-UP per cell (Table I: 6 each)
    for cell in range(6):
        instances.append(InstanceSpec(
            sid=sid, name=f"du{cell}", category=InstanceCategory.DU,
            weight_bytes=2 * GB, reconfig_s=R_RAN, cell=cell))
        sid += 1
        instances.append(InstanceSpec(
            sid=sid, name=f"cuup{cell}", category=InstanceCategory.CUUP,
            weight_bytes=0.0, reconfig_s=R_RAN, cell=cell))
        sid += 1

    large_cfg = get_config("phi3-medium-14b")
    for i in range(2):
        instances.append(InstanceSpec(
            sid=sid, name=f"large{i}", category=InstanceCategory.LARGE_AI,
            weight_bytes=float(large_cfg.weight_bytes()),   # ≈ 28 GB bf16
            reconfig_s=R_LARGE_AI, arch="phi3-medium-14b"))
        sid += 1

    small_archs = ["qwen2-0.5b", "qwen2-0.5b", "mamba2-130m", "mamba2-130m"]
    for i, arch in enumerate(small_archs):
        cfg = get_config(arch)
        instances.append(InstanceSpec(
            sid=sid, name=f"small{i}", category=InstanceCategory.SMALL_AI,
            weight_bytes=float(cfg.weight_bytes()),
            reconfig_s=R_SMALL_AI, arch=arch))
        sid += 1

    # initial placement: DU/CU-UP pair per node; consolidated large-AI on n0;
    # small-AI spread over the CPU-heavy and balanced nodes.
    placement = {}
    for cell in range(6):
        placement[f"du{cell}"] = cell
        placement[f"cuup{cell}"] = cell
    placement["large0"] = 0
    placement["large1"] = 0
    placement["small0"] = 2
    placement["small1"] = 3
    placement["small2"] = 4
    placement["small3"] = 5
    placement_idx = [placement[s.name] for s in instances]

    work_models = {
        "large": [work_model_for("phi3-medium-14b",
                                 (0.4 * GB, 0.6 * GB))],   # Table I γ_q
        "small": [work_model_for("qwen2-0.5b", (0.01 * GB, 0.04 * GB),
                                 context_len=256),
                  work_model_for("mamba2-130m", (0.005 * GB, 0.01 * GB),
                                 context_len=256)],
    }
    # service identity (arch) -> replica sids, for routing
    service_sids: Dict[str, List[int]] = {}
    for s in instances:
        if s.category.is_ai:
            service_sids.setdefault(s.arch, []).append(s.sid)

    return {
        "nodes": nodes,
        "instances": instances,
        "placement": placement_idx,
        "work_models": work_models,
        "service_sids": service_sids,
        "transport_delay": TRANSPORT_DELAY,
        "ran_packet_delay": RAN_PACKET_DELAY,
    }
