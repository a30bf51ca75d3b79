"""The paper's contribution: HAF — hierarchical agentic resource sharing.

  allocator      closed-form deadline-aware GPU/CPU allocation (Eq. 13–19)
  allocator_np   NumPy twin for the simulator's event loop
  features       the critic's state–action feature map φ(s, a) (Eq. 9)
  placement      candidate migration generation M_k (§III-A)
  prompts        the structured LLM prompt (§III-A)
  agent          π_LLM interface + deterministic stand-ins (Eq. 8)
  critic         predictive critic r̂_θ + offline training (§III-B)
  controller     the two-layer HAF controller (Eq. 11–12)
  baselines      HAF-Static / Round-Robin / Lyapunov / Game-Theory / CAORA
  datagen        the critic's training-data harvest (§III-B offline phase)

The agentic epoch layer plugs into
:class:`repro_torch.sim.engine.PlacementPolicy`.
"""
from repro_torch.core.allocator import (AllocResult, allocate_cluster,
                                        allocate_node, solve_resource)
from repro_torch.core.agent import (AGENT_ZOO, Agent, ExternalLLMAgent,
                                    HeuristicAgent, make_agent)
from repro_torch.core.controller import HAFPlacement, RandomPlacement
from repro_torch.core.critic import (Critic, epoch_records_to_samples,
                                     train_critic)
from repro_torch.core.placement import action_id, candidate_actions

__all__ = [
    "AllocResult", "allocate_cluster", "allocate_node", "solve_resource",
    "AGENT_ZOO", "Agent", "ExternalLLMAgent", "HeuristicAgent", "make_agent",
    "HAFPlacement", "RandomPlacement", "Critic", "train_critic",
    "epoch_records_to_samples", "candidate_actions", "action_id",
]
