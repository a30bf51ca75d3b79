"""State carried across packages: plain data in, this package's objects out.

What two implementations must agree on is the scenario, the workload, the
``[B, S]`` block state of a tick and, for the served models, the weights.
Everything here takes plain tuples / dicts / numpy arrays (what
``dataclasses.asdict``, enum ``.value`` and ``np.asarray`` give), so it can
rebuild state recorded by any other implementation without ever seeing its
types.

Model weights (:func:`params_from_numpy`): the reference keeps a model's
parameters as a tree of arrays in which every per-layer weight is stacked on
a leading layer axis, ``layers/<name>`` of shape ``[L, ...]``.  The port keeps
each such subtree as a list of per-layer dicts, so ``layers/<name>[l]``
becomes ``params["layers"][l][<name>]`` (at any depth of nesting, e.g.
``layers/attn/wq[l]`` -> ``params["layers"][l]["attn"]["wq"]``).  The stacked
subtrees are ``models.common.STACKED``: ``layers``, ``dense_layers`` (MoE
configs' leading dense layers), ``ssm_layers`` and ``shared`` (hybrid: the
Mamba2 layers and the shared attention blocks), ``enc_layers`` and
``dec_layers`` (encoder-decoder).  Every other leaf (``embed``,
``final_norm``, ``lm_head``, ``enc_norm``, the unstacked ``mtp`` subtree)
keeps its name and shape.  :func:`params_to_numpy` is the inverse: the
port's parameters back in the reference's stacked tree of numpy arrays.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterable, List, Mapping

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.api import resolve_device
from repro_torch.models.common import (split_stacked, stack_stacked,
                                       tree_leaves, tree_map)
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


def _array_to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # ml_dtypes' bfloat16: 2-byte view
        return torch.from_numpy(
            np.array(a).view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))     # a writable copy


def params_from_numpy(cfg: ArchConfig, tree: Mapping[str, Any],
                      device=None) -> Dict[str, Any]:
    """The reference's parameter tree as numpy arrays (``jax.tree.map(
    np.asarray, params)``) -> the port's parameters on ``device``, in
    ``cfg.param_dtype``, with the stacked ``layers`` split per layer (see the
    module docstring).  ``device=None`` means CUDA, as for ``build_model``,
    and raises where there is none; pass ``device="cpu"`` for the CPU.  Every
    family of the zoo has this layout."""
    device = resolve_device(device)
    dtype = getattr(torch, cfg.param_dtype)
    return split_stacked(tree_map(
        lambda a: _array_to_torch(a).to(device=device, dtype=dtype),
        dict(tree)))


def tensor_to_numpy(t: torch.Tensor) -> np.ndarray:
    """A host numpy copy of ``t``; bfloat16 (which numpy lacks) comes back
    as float32, which holds every bfloat16 value exactly."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy().copy()


def params_to_numpy(cfg: ArchConfig, params: Mapping[str, Any]
                    ) -> Dict[str, Any]:
    """The port's parameters (any device, in ``cfg.param_dtype``) -> the
    reference's tree of numpy arrays: every per-layer list stacked back on
    a leading ``[L]`` axis (see the module docstring).  bfloat16 leaves come
    back as float32 (:func:`tensor_to_numpy`), so ``params_from_numpy(cfg,
    params_to_numpy(cfg, p))`` gives ``p`` again."""
    dtype = getattr(torch, cfg.param_dtype)
    bad = {t.dtype for t in tree_leaves(params)} - {dtype}
    if bad:
        raise ValueError(f"{cfg.name}: parameters in {sorted(map(str, bad))}"
                         f", expected {dtype}")
    return tree_map(tensor_to_numpy, stack_stacked(dict(params)))
