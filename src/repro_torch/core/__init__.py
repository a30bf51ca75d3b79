"""The paper's contribution: HAF — hierarchical agentic resource sharing.

  allocator      closed-form deadline-aware GPU/CPU allocation (Eq. 13–19)
  allocator_np   NumPy twin for the simulator's event loop

The agentic epoch layer (placement, prompts, agent, critic, controller,
baselines) plugs into :class:`repro_torch.sim.engine.PlacementPolicy`.
"""
from repro_torch.core.allocator import (AllocResult, allocate_cluster,
                                        allocate_node, solve_resource)

__all__ = ["AllocResult", "allocate_cluster", "allocate_node",
           "solve_resource"]
