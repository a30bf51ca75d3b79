"""State carried across packages: plain data in, this package's objects out.

There are no weights in this system.  What two implementations must agree
on is the scenario, the workload and the ``[B, S]`` block state of a tick.
Everything here takes plain tuples / dicts / numpy arrays (what
``dataclasses.asdict`` and enum ``.value`` give), so it can rebuild state
recorded by any other implementation without ever seeing its types.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping

import numpy as np
import torch

from repro_torch.sim.types import (InstanceCategory, InstanceSpec, NodeSpec,
                                   Request, RequestClass)
from repro_torch.sim.workload import ServiceWorkModel

# event_step's inputs and outputs, in argument / result order
STEP_INPUTS = ("rem_g", "rem_c", "alloc_g", "alloc_c", "avail", "t", "t_ev",
               "live")
STEP_OUTPUTS = ("rem_g", "rem_c", "started", "t_comp", "sid")


def block_arrays_to_torch(arrays: Mapping[str, np.ndarray], device
                          ) -> Dict[str, torch.Tensor]:
    """numpy block state -> contiguous tensors on ``device`` (dtypes kept:
    float64 stays float64, bool stays bool)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in arrays.items()}


def block_arrays_from_torch(tensors: Mapping[str, torch.Tensor]
                            ) -> Dict[str, np.ndarray]:
    """Tensors (any device) -> numpy arrays on the host, dtypes kept."""
    return {k: v.detach().cpu().numpy() for k, v in tensors.items()}


_REQUEST_FIELDS = tuple(f.name for f in dataclasses.fields(Request))


def requests_from_records(records: Iterable) -> List[Request]:
    """Rebuild :class:`Request` objects from dicts (``dataclasses.asdict``
    form, ``cls`` as the enum's value) or from tuples in field order."""
    out = []
    for rec in records:
        if not isinstance(rec, Mapping):
            rec = dict(zip(_REQUEST_FIELDS, rec))
        rec = dict(rec)
        rec["cls"] = RequestClass(rec["cls"])
        out.append(Request(**rec))
    return out


def scenario_from_plain(plain: Mapping) -> Dict:
    """Rebuild a Simulator scenario dict from its plain form: ``nodes`` /
    ``instances`` / ``work_models`` entries as field dicts (``category`` as
    the enum's value); every other key is plain data already and is copied
    as it is."""
    sc = dict(plain)
    sc["nodes"] = [NodeSpec(**n) for n in plain["nodes"]]
    sc["instances"] = [
        InstanceSpec(**{**i, "category": InstanceCategory(i["category"])})
        for i in plain["instances"]]
    sc["work_models"] = {
        kind: [ServiceWorkModel(**{
            **m, "kv_bytes_per_req": tuple(m["kv_bytes_per_req"])})
            for m in models]
        for kind, models in plain["work_models"].items()}
    return sc
