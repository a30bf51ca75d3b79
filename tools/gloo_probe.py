"""Which collectives run for four ranks that share one GPU.

    PYTHONPATH=src python3 tools/gloo_probe.py \
        [--backend gloo|cpu:gloo,cuda:hoststaged]

Spawns four ranks on card 0 (NCCL takes one rank a card, so they use a
gloo-based backend) and runs, on CUDA tensors, the synchronous collectives
(``all_reduce``, ``all_gather_into_tensor``, ``reduce_scatter_tensor``,
``all_to_all_single``, ``broadcast``, ``barrier``) and then the DTensor
redistributions that the port's mesh code issues through the functional
collectives (shard -> replicate, partial -> replicate / shard, a max
partial, shard -> shard on another dim) on a 2 x 2 device mesh.  Each rank
prints one line a step, "ok" or "FAIL" with the error; a crash of the
process (a segmentation fault in a collective) prints the Python stack
(``faulthandler``) and the command exits non-zero.
"""
import argparse
import datetime
import faulthandler
import socket

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run(rank: int, port: int, backend: str) -> None:
    faulthandler.enable()
    torch.cuda.set_device(0)
    import repro_torch.distributed.hoststaged  # noqa: F401 — the backend
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4,
                            timeout=datetime.timedelta(seconds=120))
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    def step(name, fn):
        try:
            fn()
            torch.cuda.synchronize()
            print(f"rank{rank} {name} ok", flush=True)
        except Exception as e:  # noqa: BLE001 — report and go on
            print(f"rank{rank} {name} FAIL {type(e).__name__}: "
                  f"{str(e)[:300]}", flush=True)

    ones = lambda n: torch.ones(n, device="cuda")
    step("all_reduce", lambda: dist.all_reduce(ones(8)))
    step("all_gather_into_tensor",
         lambda: dist.all_gather_into_tensor(ones(32), ones(8)))
    step("reduce_scatter_tensor",
         lambda: dist.reduce_scatter_tensor(ones(2), ones(8)))
    step("all_to_all_single", lambda: dist.all_to_all_single(ones(8),
                                                             ones(8)))
    step("broadcast", lambda: dist.broadcast(ones(8), 0))
    step("barrier", dist.barrier)
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    t = torch.arange(64, dtype=torch.float32, device="cuda").reshape(8, 8)
    d = distribute_tensor(t, mesh, [Shard(0), Shard(1)], src_data_rank=None)
    part = DTensor.from_local(torch.ones(4, 4, device="cuda"), mesh,
                              [Partial(), Partial()], run_check=False)
    step("shard->replicate", d.full_tensor)
    step("partial->replicate",
         lambda: part.redistribute(mesh, [Replicate(), Replicate()]))
    step("partial->shard",
         lambda: part.redistribute(mesh, [Shard(0), Shard(1)]))
    step("partial(max)->replicate", lambda: DTensor.from_local(
        ones(4), mesh, [Partial("max"), Replicate()],
        run_check=False).full_tensor())
    step("shard(0)->shard(1)",
         lambda: d.redistribute(mesh, [Shard(1), Shard(1)]))
    dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--backend", default="gloo")
    args = ap.parse_args()
    print(torch.__version__, args.backend, flush=True)
    mp.start_processes(run, args=(free_port(), args.backend), nprocs=4,
                       start_method="spawn")
    print("probe finished", flush=True)


if __name__ == "__main__":
    main()
