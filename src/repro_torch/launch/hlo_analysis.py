"""Roofline terms of a traced step on the H100 (twin of the reference's
``launch/hlo_analysis.py``, whose name it keeps).

There is no HLO here: :class:`OpCounter`, a ``TorchDispatchMode``, counts
the aten ops that a step runs on each rank's *local* tensors, as the
reference's analysis reads the per-device module after SPMD partitioning:

- FLOPs of the matrix-class ops (``mm``, ``bmm``, ``addmm``, attention,
  convolution) by ``torch.utils.flop_counter``'s formulas at the local
  shapes;
- bytes as each op's inputs plus outputs (views move nothing and are not
  counted; nothing is fused, so this is an upper bound where XLA's "bytes
  accessed" is after fusion);
- collective bytes by the reference's five kinds, from the
  ``_c10d_functional`` ops that DTensor issues (output bytes, as the
  reference counts them), each priced at the rate of its group: NVLink
  within a node of :data:`NODE` cards, InfiniBand when the group spans
  nodes (ranks ``r`` and ``r'`` share a node where ``r // NODE == r' //
  NODE``);
- the peak of live local bytes made during the step (:func:`memory_stats`).

A ``DTensor``-level op is not counted: the mode defers it to DTensor
(``NotImplemented``) and sees the local ops and collectives it runs; the
metadata that DTensor's sharding propagation computes on ``FakeTensor``s at
the global shapes is not counted either.  (``FlopCounterMode`` over
DTensors counts the global op.)

Hardware model: NVIDIA H100 80GB HBM3 (SXM5), 700 W, from NVIDIA's H100
datasheet -- the numbers below are the datasheet's, not measured here.
"""
from __future__ import annotations

import dataclasses
import weakref
from typing import Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

# NVIDIA H100 80GB HBM3 (SXM5), 700 W (H100 datasheet)
PEAK_FLOPS = 989.4e12        # bf16 dense tensor-core FLOP/s per card
HBM_BW = 3.35e12             # HBM3 bytes/s per card
NVLINK_BW = 450e9            # NVLink 4 bytes/s, one direction, within a node
IB_BW = 50e9                 # 400 Gb/s InfiniBand NDR per card across nodes
NODE = 8                     # cards a node (HGX H100 8-GPU)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

# _c10d_functional op name -> the reference's collective kind
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
    "isend": "collective-permute",
    "irecv": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")


@dataclasses.dataclass
class Roofline:
    flops: float                 # per-device counted FLOPs
    hbm_bytes: float             # per-device bytes of op inputs + outputs
    coll_bytes: float            # per-device collective bytes
    coll_breakdown: Dict[str, int]
    out_bytes: float             # output bytes of the step
    model_flops: float = 0.0     # analytic 6·N·D or 2·N·D
    # seconds of the collectives, each at its group's link rate; None
    # prices coll_bytes at NVLINK_BW
    coll_seconds: Optional[float] = None

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def t_collective(self) -> float:
        if self.coll_seconds is not None:
            return self.coll_seconds
        return self.coll_bytes / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def roofline_fraction(self) -> float:
        """useful-compute time / actual bounding time (≤ 1)."""
        t_use = self.model_flops / PEAK_FLOPS if self.model_flops else \
            self.t_compute
        bound = max(self.t_compute, self.t_memory, self.t_collective)
        return t_use / bound if bound > 0 else 0.0

    @property
    def flops_utilization(self) -> float:
        """MODEL_FLOPS / counted FLOPs — remat/redundancy waste detector."""
        return (self.model_flops / self.flops) if self.flops else 0.0

    def to_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "coll_bytes": self.coll_bytes,
            "coll_breakdown": self.coll_breakdown,
            "model_flops": self.model_flops,
            "t_compute": self.t_compute, "t_memory": self.t_memory,
            "t_collective": self.t_collective,
            "bottleneck": self.bottleneck,
            "roofline_fraction": self.roofline_fraction,
            "flops_utilization": self.flops_utilization,
        }


def nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_bandwidth(group_name: str) -> float:
    """NVLink where every rank of the group is on one node, else
    InfiniBand."""
    from torch.distributed.distributed_c10d import (_resolve_process_group,
                                                    get_process_group_ranks)
    ranks = get_process_group_ranks(_resolve_process_group(group_name))
    return NVLINK_BW if len({r // NODE for r in ranks}) <= 1 else IB_BW


class OpCounter(TorchDispatchMode):
    """Counts the local ops of everything run under it (see the module
    docstring): ``flops``, ``bytes``, ``coll_bytes`` by kind,
    ``coll_seconds`` and ``peak_bytes`` (live local bytes made under it)."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.coll = {k: 0 for k in COLLECTIVES}
        self.coll_seconds = 0.0
        self.live = 0
        self.peak_bytes = 0
        self._bw: Dict[str, float] = {}
        self._seen = weakref.WeakSet()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented            # DTensor runs the local ops
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types) or any(
                isinstance(t, FakeTensor) for t in tree_leaves(out)):
            return out                       # sharding propagation's metadata
        self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out) -> None:
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS:
            kind = _KINDS.get(name)
            if kind is not None:
                size = sum(nbytes(t) for t in tree_leaves(out)
                           if isinstance(t, torch.Tensor))
                group = next((a for a in reversed(args) if isinstance(a, str)),
                             None)
                bw = NVLINK_BW if group is None else self._bandwidth(group)
                self.coll[kind] += size
                self.coll_seconds += size / bw
            self._track(out)
            return
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if func.is_view:
            return
        ins = sum(nbytes(t) for t in tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor))
        outs = sum(nbytes(t) for t in tree_leaves(out)
                   if isinstance(t, torch.Tensor))
        self.bytes += ins + outs
        self._track(out)

    def _bandwidth(self, group: str) -> float:
        if group not in self._bw:
            self._bw[group] = _group_bandwidth(group)
        return self._bw[group]

    def _track(self, out) -> None:
        """Add each new output storage to the live bytes until it dies."""
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen.add(st)
            n = st.nbytes()
            self.live += n
            self.peak_bytes = max(self.peak_bytes, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def roofline(self, model_flops: float = 0.0,
                 out_bytes: float = 0.0) -> Roofline:
        return Roofline(flops=float(self.flops), hbm_bytes=float(self.bytes),
                        coll_bytes=float(sum(self.coll.values())),
                        coll_breakdown=dict(self.coll),
                        out_bytes=float(out_bytes), model_flops=model_flops,
                        coll_seconds=self.coll_seconds)


def analytic_model_flops(cfg, kind: str, seq_len: int, global_batch: int
                         ) -> float:
    """MODEL_FLOPS per the spec: 6·N_active·D train / 2·N_active·D forward,
    plus the attention context term (decode reads the whole KV cache;
    causal prefill averages S/2).  Uses the arch's own cost model."""
    if kind == "decode":
        per_tok = cfg.flops_per_token(context_len=seq_len)
        return per_tok * global_batch
    ctx = seq_len // 2                       # causal average
    per_tok = cfg.flops_per_token(context_len=ctx)
    tokens = global_batch * seq_len
    mult = 3.0 if kind == "train" else 1.0   # fwd+bwd ≈ 3× fwd
    return mult * per_tok * tokens


def memory_stats(argument_bytes: float, output_bytes: float,
                 temp_bytes: float, alias_bytes: float = 0.0
                 ) -> Dict[str, float]:
    """The reference's keys: argument and output bytes of the step on one
    device, temp the peak of live local bytes made during it less the
    outputs (alive at its end, and counted apart, as XLA's temp leaves
    them out), alias the outputs that are arguments updated in place (a
    decode cache); no generated code."""
    out = {"argument_size_in_bytes": float(argument_bytes),
           "output_size_in_bytes": float(output_bytes),
           "temp_size_in_bytes": float(temp_bytes),
           "generated_code_size_in_bytes": 0.0,
           "alias_size_in_bytes": float(alias_bytes)}
    out["total_per_device"] = (out["argument_size_in_bytes"]
                               + out["output_size_in_bytes"]
                               + out["temp_size_in_bytes"]
                               - out["alias_size_in_bytes"])
    return out
