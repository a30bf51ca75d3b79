"""A process-group backend that stages CUDA collectives through host memory
(``"hoststaged"``), for several ranks that share one card.

NCCL takes one rank a card, so ranks that share a card need gloo, whose
CUDA collectives copy each buffer to the host, run there and copy it back.
The functional collectives that DTensor issues (``_c10d_functional``) crash
on gloo's CUDA path in some releases (torch 2.11: a segmentation fault in
``wait_tensor`` of a CUDA ``all_gather_into_tensor``) while the same
collectives through the synchronous API run.  This backend does what gloo's
CUDA path does, in the open: each collective copies its CUDA buffers to the
host, runs gloo's CPU collective synchronously, and copies the result back;
the ranks' tensors and their compute stay on the card.  It is slow, and
meant for rehearsing a mesh on one card, never for measuring a
collective's speed.

    import repro_torch.distributed.hoststaged  # registers the backend
    torch.distributed.init_process_group("cpu:gloo,cuda:hoststaged", ...)
"""
from __future__ import annotations

from typing import List

import torch
import torch.distributed as dist
from torch._C._distributed_c10d import (AllgatherOptions, AllreduceOptions,
                                        AllToAllOptions, BarrierOptions,
                                        BroadcastOptions,
                                        ReduceScatterOptions,
                                        _create_work_from_future)
from torch.futures import Future

NAME = "hoststaged"


def _done(result) -> dist.Work:
    fut = Future()
    fut.set_result(result)
    return _create_work_from_future(fut)


def _host(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    return [t.detach().to("cpu", copy=True) for t in ts]


def _host_empty(ts: List[torch.Tensor]) -> List[torch.Tensor]:
    """Host buffers for outputs (nothing copied in)."""
    return [torch.empty_like(t, device="cpu") for t in ts]


def _back(devs: List[torch.Tensor], hosts: List[torch.Tensor]) -> None:
    for d, h in zip(devs, hosts):
        d.copy_(h)


class HostStagedGloo(dist.ProcessGroup):
    """Every collective on host copies through an inner gloo group (see
    the module docstring); finished when it returns."""

    def __init__(self, store, rank: int, size: int, timeout):
        super().__init__(rank, size)
        self._gloo = dist.ProcessGroupGloo(store, rank, size, timeout)

    def getBackendName(self) -> str:
        return NAME

    @property
    def group_name(self) -> str:
        """The name c10d registered this group under."""
        return dist.distributed_c10d._world.pg_names[self]

    def allreduce(self, tensors, opts=AllreduceOptions()):
        hosts = _host(tensors)
        self._gloo.allreduce(hosts, opts).wait()
        _back(tensors, hosts)
        return _done(tensors)

    def allreduce_coalesced(self, tensors, opts=AllreduceOptions()):
        for t in tensors:
            self.allreduce([t], opts)
        return _done(tensors)

    def broadcast(self, tensors, opts=BroadcastOptions()):
        hosts = _host(tensors)
        self._gloo.broadcast(hosts, opts).wait()
        _back(tensors, hosts)
        return _done(tensors)

    def allgather(self, output_lists, inputs, opts=AllgatherOptions()):
        outs = [_host_empty(o) for o in output_lists]
        self._gloo.allgather(outs, _host(inputs), opts).wait()
        for dev, host in zip(output_lists, outs):
            _back(dev, host)
        return _done(output_lists)

    def _allgather_base(self, output, input, opts=AllgatherOptions()):
        chunks = list(torch.chunk(output, self.size()))
        return self.allgather([chunks], [input], opts)

    all_gather_single = _allgather_base

    def allgather_into_tensor_coalesced(self, outputs, inputs,
                                        opts=AllgatherOptions()):
        for o, i in zip(outputs, inputs):
            self._allgather_base(o, i, opts)
        return _done(outputs)

    all_gather_single_coalesced = allgather_into_tensor_coalesced

    def reduce_scatter(self, outputs, input_lists,
                       opts=ReduceScatterOptions()):
        # gloo has no reduce-scatter of its own: an all-reduce, then this
        # rank's piece
        for out, pieces in zip(outputs, input_lists):
            whole = torch.cat([p.detach().reshape(-1) for p in pieces]).cpu()
            self._gloo.allreduce([whole], _reduce(opts.reduceOp)).wait()
            n = out.numel()
            r = self.rank()
            out.copy_(whole[r * n:(r + 1) * n].view_as(out))
        return _done(outputs)

    def _reduce_scatter_base(self, output, input,
                             opts=ReduceScatterOptions()):
        pieces = list(torch.chunk(input, self.size()))
        return self.reduce_scatter([output], [pieces], opts)

    reduce_scatter_single = _reduce_scatter_base

    def reduce_scatter_tensor_coalesced(self, outputs, inputs,
                                        opts=ReduceScatterOptions()):
        for o, i in zip(outputs, inputs):
            self._reduce_scatter_base(o, i, opts)
        return _done(outputs)

    reduce_scatter_single_coalesced = reduce_scatter_tensor_coalesced

    def alltoall_base(self, output, input, output_split_sizes,
                      input_split_sizes, opts=AllToAllOptions()):
        # an all-gather of every rank's input, then this rank's pieces
        n = self.size()
        ins = (list(torch.split(input, input_split_sizes))
               if input_split_sizes else list(torch.chunk(input, n)))
        sizes = torch.tensor([p.numel() for p in ins])
        all_sizes = [torch.empty_like(sizes) for _ in range(n)]
        self._gloo.allgather([all_sizes], [sizes]).wait()
        flat = torch.cat([p.detach().reshape(-1) for p in ins]).cpu()
        longest = max(int(s.sum()) for s in all_sizes)
        padded = torch.zeros(longest, dtype=flat.dtype)
        padded[:flat.numel()] = flat
        gathered = [torch.empty_like(padded) for _ in range(n)]
        self._gloo.allgather([gathered], [padded]).wait()
        r = self.rank()
        mine = []
        for src in range(n):
            start = int(all_sizes[src][:r].sum())
            mine.append(gathered[src][start:start + int(all_sizes[src][r])])
        output.copy_(torch.cat(mine).view_as(output))
        return _done([output])

    all_to_all_single = alltoall_base

    def barrier(self, opts=BarrierOptions()):
        self._gloo.barrier().wait()
        return _done([])


def _reduce(op) -> AllreduceOptions:
    opts = AllreduceOptions()
    opts.reduceOp = op
    return opts


def _create(store, rank, size, timeout):
    return HostStagedGloo(store, rank, size, timeout)


if NAME not in dist.Backend.backend_list:
    dist.Backend.register_backend(NAME, _create, devices=["cpu", "cuda"])
