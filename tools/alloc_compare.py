#!/usr/bin/env python3
"""Time the port's alloc_active_set path of one source tree on the GPU.

    python3 tools/alloc_compare.py [--src DIR] [--label NAME]

``DIR`` is the ``src`` directory of a checkout of this repository (default:
this checkout's); its ``repro_torch`` is imported and its kernels are built
into that checkout's ``build/``.  Run it on two trees in one session (A, B,
B, A) to compare them on one card: it uses only the public entry points
both have (``ops.alloc_active_set``, ``allocator.allocate_cluster``).

Prints one JSON line: for each timed case of ``chip_smoke.py`` (yardstick
data at (1024, 64) and (16384, 128), feasible-dominant data at (16384,
128)) the CUDA-event µs a call (median of 5 runs of 50 back-to-back calls
behind a device sleep), the device µs and kernel launches a call of the
allocator's kernels under torch.profiler (20 calls), and the host µs of one
``ops.alloc_active_set`` call (median and 10th percentile of 200, wall
clock, not synchronised); then ``allocate_cluster`` at (16384, 128) on
chip_smoke's float64 inputs (two solves): CUDA-event µs and device µs a
call.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# the allocator's kernels of every version of the port, by a part of their
# names (alloc_active_set_kernel, then alloc_warp_kernel / alloc_block_kernel)
KERNEL_PART = "alloc_"


def alloc_inputs(seed, N, S, floor_scale=1.0):
    """chip_smoke.py's allocator data (floors x 0.1: its feasible kind)."""
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0, 1e14, (N, S))
    omega = rng.uniform(0, 100, (N, S))
    cap = rng.uniform(5e13, 2e14, N)
    floors = np.where(rng.random((N, S)) < 0.3,
                      rng.uniform(0, 2e13, (N, S)), 0.0)
    mask = rng.random((N, S)) < 0.9
    return psi, omega, floors * floor_scale, cap, mask


def to_dev(arrays, dev):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in arrays]


def event_us(fn, iters=50, warmup=5, repeats=5):
    times = []
    for _ in range(repeats):
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) * 1e3 / iters)
    return float(np.median(times))


def profiled_us(fn, iters=20):
    """(device µs of the allocator's kernels a call, their launches a call,
    device µs of every kernel a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = launches = total = 0.0
    for evt in prof.key_averages():
        if evt.device_type != DeviceType.CUDA:
            continue
        t = getattr(evt, "device_time_total", None)
        if t is None:
            t = getattr(evt, "cuda_time_total", 0.0)
        total += t / iters
        if KERNEL_PART in evt.key:
            us += t / iters
            launches += evt.count / iters
    return us, launches, total


def host_us(fn, calls=200):
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        fn()
        walls.append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    return float(np.median(walls)), float(np.percentile(walls, 10))


def main() -> None:
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--src", default=os.path.join(here, "src"))
    p.add_argument("--label", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        sys.exit("alloc_compare: no CUDA device")
    sys.path.insert(0, os.path.abspath(args.src))
    from repro_torch.core import allocator
    from repro_torch.kernels import _build, ops
    dev = torch.device("cuda", 0)
    _build.build_all()
    _build.load()

    cases = []
    for kind, scale, N, S in (("yardstick", 1.0, 1024, 64),
                              ("yardstick", 1.0, 16384, 128),
                              ("feasible", 0.1, 16384, 128)):
        psi, omega, floors, cap, mask = alloc_inputs(2, N, S, scale)
        d = to_dev([x.astype(np.float32) for x in (psi, omega, floors, cap)]
                   + [mask], dev)

        def call():
            return ops.alloc_active_set(*d)
        us, launches, _ = profiled_us(call)
        host, host_p10 = host_us(call)
        cases.append({"kind": kind, "shape": [N, S],
                      "event_us": event_us(call), "device_us": us,
                      "launches_per_call": launches, "wrapper_host_us": host,
                      "wrapper_host_us_p10": host_p10})

    # allocate_cluster as chip_smoke.py's phase allocate_cluster drives it
    N, S = 16384, 128
    rng = np.random.default_rng(5)
    psi_g, omega, fg, cap_g, mask = alloc_inputs(5, N, S)
    psi_c = rng.uniform(0, 4.0, (N, S))
    fc = np.where(rng.random((N, S)) < 0.3, rng.uniform(0, 0.5, (N, S)), 0.0)
    cap_c = rng.uniform(8.0, 64.0, N)
    dv = to_dev((psi_g, psi_c, omega, fg, fc, cap_g, cap_c, mask), dev)

    def cluster():
        return allocator.allocate_cluster(*dv, use_kernel=True)
    k_us, k_launches, call_us = profiled_us(cluster)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps({
        "label": args.label, "src": args.src, "device": smi, "kernels": cases,
        "allocate_cluster": {"shape": [N, S],
                             "call_event_us": event_us(cluster, iters=20),
                             "kernel_device_us": k_us,
                             "kernel_launches_per_call": k_launches,
                             "call_device_us": call_us}}), flush=True)


if __name__ == "__main__":
    main()
