"""Discrete-event simulation of an AI-RAN edge cluster (paper §IV).

Heterogeneous nodes share GPU/CPU/VRAM between DU / CU-UP RAN functions and
large/small AI services; requests carry per-stage work and deadlines; the
placement layer acts at epochs, the allocation layer at every event.
"""
from repro_torch.sim.types import (InstanceCategory, InstanceSpec, NodeSpec,
                             Request, RequestClass, MigrationAction)
from repro_torch.sim.cluster import ClusterState
from repro_torch.sim.engine import Simulator, SimResult
from repro_torch.sim.event_core import ENGINES, make_event_core
from repro_torch.sim.stream import ArrivalStream, ListStream, as_arrival_stream
from repro_torch.sim.workload import (WorkloadConfig, generate_workload,
                                workload_stream)
from repro_torch.sim.scenario import paper_scenario
from repro_torch.sim.scenarios import (family_names, make_scenario,
                                 scenario_fingerprint, workload_for,
                                 workload_stream_for)

__all__ = [
    "InstanceCategory", "InstanceSpec", "NodeSpec", "Request", "RequestClass",
    "MigrationAction", "ClusterState", "Simulator", "SimResult",
    "ENGINES", "make_event_core",
    "ArrivalStream", "ListStream", "as_arrival_stream",
    "WorkloadConfig", "generate_workload", "workload_stream",
    "paper_scenario", "family_names", "make_scenario",
    "scenario_fingerprint", "workload_for", "workload_stream_for",
]
