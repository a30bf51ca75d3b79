"""Core simulator types: nodes, instances, requests, actions (paper §II)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional

GB = 1024 ** 3
TFLOPS = 1.0e12


class InstanceCategory(str, enum.Enum):
    DU = "DU"              # GPU-bound PHY/MAC baseband            (S^D)
    CUUP = "CUUP"          # CPU-bound PDCP / user-plane forwarding (S^U)
    LARGE_AI = "LARGE_AI"  # multi-GB weights, second-scale reload  (S^L)
    SMALL_AI = "SMALL_AI"  # sub-GB weights, sub-second reload      (S^S)

    @property
    def is_ran(self) -> bool:
        return self in (InstanceCategory.DU, InstanceCategory.CUUP)

    @property
    def is_ai(self) -> bool:
        return not self.is_ran


class RequestClass(str, enum.Enum):
    RAN = "RAN"            # Q^r: DU -> CU-UP only
    LARGE_AI = "LARGE_AI"  # Q^e targeting a large-AI service
    SMALL_AI = "SMALL_AI"  # Q^e targeting a small-AI service

    @property
    def is_ai(self) -> bool:
        return self is not RequestClass.RAN


@dataclasses.dataclass(frozen=True)
class NodeSpec:
    """One edge compute node: capacities (Eq. 3–4)."""
    name: str
    kind: str                   # "gpu-heavy" | "cpu-heavy" | "balanced"
    gpu_flops: float            # G_n  [FLOP/s]
    cpu_cores: float            # C_n  [cores]
    vram_bytes: float           # V_n  [bytes]


@dataclasses.dataclass(frozen=True)
class InstanceSpec:
    """One hosted instance s ∈ S (persistent service or RAN function)."""
    sid: int                    # dense index into S
    name: str
    category: InstanceCategory
    weight_bytes: float         # M_s — model weights / PHY-MAC libraries
    reconfig_s: float           # R_s — migration outage at the destination
    cell: int = -1              # for DU/CU-UP: the serving cell
    arch: str = ""              # AI services: the backing repro_torch.configs arch
    movable: bool = True        # eligible for migration (∈ S^M)

    @property
    def is_ran(self) -> bool:
        return self.category.is_ran


@dataclasses.dataclass
class Request:
    """One request q (Q^e or Q^r) with per-stage work (Eq. 1–2)."""
    rid: int
    cls: RequestClass
    arrival: float              # a_q
    deadline: float             # τ_q (relative budget, seconds)
    cell: int                   # serving cell (fixes the DU/CU-UP pair)
    # per-stage work: RAN requests use (du_g, cuup_c); AI requests use ai_g/ai_c
    du_work_g: float = 0.0      # Φ^g on the DU          [FLOPs]
    du_work_c: float = 0.0      # Φ^c on the DU          [core-s]
    cuup_work_c: float = 0.0    # Φ^c on the CU-UP       [core-s]
    ai_work_g: float = 0.0      # Φ^g on the AI service  [FLOPs]
    ai_work_c: float = 0.0      # Φ^c on the AI service  [core-s]
    kv_bytes: float = 0.0       # γ_q transient KV cache [bytes]
    service: str = ""           # AI service identity (arch name) for routing
    # runtime state
    target_sid: int = -1        # chosen AI instance (routing decision)
    stage_entered: float = 0.0
    finish: float = -1.0

    @property
    def total_ai_work(self) -> float:
        return self.ai_work_g

    def fulfilled(self) -> bool:
        return self.finish >= 0 and (self.finish - self.arrival) <= self.deadline


@dataclasses.dataclass(frozen=True)
class MigrationAction:
    """a = (s, n(s) -> n'): move instance sid to node dst (paper §III-A)."""
    sid: int
    src: int
    dst: int

    def describe(self, instances, nodes) -> str:
        s = instances[self.sid]
        return (f"migrate {s.name} [{s.category.value}] "
                f"{nodes[self.src].name} -> {nodes[self.dst].name}")


NO_MIGRATION: Optional[MigrationAction] = None
