#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (sm_90a) and nvcc

Five phases, one JSON line each; any failure ends the run with a non-zero
exit code:

  1. env               torch / CUDA versions, the card's name and power limit
  2. build             nvcc-compile every kernel from src/repro_torch/kernels/csrc
  3. kernels           each kernel against its plain torch version on the card
                       (event_step also bit-for-bit against the host numpy
                       core), with times: CUDA events, warm-up, >= 20 launches
  4. run_batch         the main path: Simulator.run_batch, HAF-Static, the
                       dense-urban fleet at n_nodes=480 (S = 1440 instances),
                       B = 32 replicas, default engine (the event_step kernel),
                       against the same workloads on engine="numpy"
  5. allocate_cluster  the second path: the fleet-wide allocator through the
                       alloc_active_set kernel at (N, S) = (16384, 128)
                       against the float64 host solver

Then a line {"kernels": [...]} (per kernel: route, source, the TPU kernel it
replaces, launches on its path, error, time, plain-version time, roofline
bound), the card's name and power limit as nvidia-smi prints them, and the
last line {"ok": true, "device": {...}}.

With no options the fleet is full size (S = 1440, B = 32) and each replica's
request stream is half the reference bench's, which keeps the run to a few
minutes; ``--requests 4960`` runs the whole stream.  The other options shrink
the run for a rehearsal.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time
import types

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke: torch.cuda.is_available() is False — this script "
             "measures the port on a GPU and does not run without one")

from repro_torch import obs
from repro_torch.core import allocator
from repro_torch.core.allocator_np import allocate_cluster_np
from repro_torch.kernels import _build, ops, ref
from repro_torch.sim import Simulator, make_scenario, workload_for
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement
from repro_torch.sim.event_core import NumpyBatchedEventCore

DEV = torch.device("cuda", 0)
INF = float("inf")

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 outside the tensor cores, and float64 at half that rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 33.5e12

# n_ai_requests of the reference's fleet-size bench cell
FULL_REQUESTS = 4960

STEP_KEYS = ("rem_g", "rem_c", "alloc_g", "alloc_c", "avail", "t", "t_ev",
             "live")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    """Mean device time per call over ``iters`` calls between
    two CUDA events.  A short device-side sleep is queued first so the host
    runs ahead and back-to-back launches are timed, not the enqueue."""
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
    return start.elapsed_time(end) / iters


def median_ms(fn, repeats: int = 5, **kw) -> float:
    return float(np.median([time_ms(fn, **kw) for _ in range(repeats)]))


# --------------------------------------------------------------------------- #
# inputs (numpy, from a seed)
# --------------------------------------------------------------------------- #
def step_inputs(kind: str, seed: int, B: int, S: int):
    rng = np.random.default_rng(seed)
    a = {
        "rem_g": np.where(rng.random((B, S)) < 0.7,
                          rng.uniform(1.0, 1e13, (B, S)), 0.0),
        "rem_c": np.where(rng.random((B, S)) < 0.7,
                          rng.uniform(1e-9, 2.0, (B, S)), 0.0),
        "alloc_g": rng.uniform(1e11, 1e14, (B, S)),
        "alloc_c": rng.uniform(0.1, 16.0, (B, S)),
        "avail": rng.random((B, S)) < 0.85,
        "t": rng.uniform(0.0, 50.0, B),
        "live": np.ones(B, bool),
    }
    a["t_ev"] = a["t"] + rng.uniform(0.0, 0.2, B)
    if kind == "stalled":
        a["alloc_g"][rng.random((B, S)) < 0.4] = 0.0
        a["alloc_c"][rng.random((B, S)) < 0.4] = 0.0
    elif kind == "unavailable":
        a["avail"] = rng.random((B, S)) < 0.2
    elif kind == "dead-rows":
        a["live"] = rng.random(B) < 0.5
        a["live"][0] = False
    elif kind == "all-inf":
        a["avail"][::2] = False
        a["t_ev"][0] = INF
    elif kind == "ties":
        for k in ("rem_g", "rem_c", "alloc_g", "alloc_c"):
            a[k][:, S // 2:] = a[k][:, :S - S // 2]
        a["avail"][:] = True
    elif kind == "heap-first":
        a["t_ev"] = a["t"] + 1e-7
    elif kind != "random":
        raise ValueError(kind)
    return a


def alloc_inputs(seed: int, N: int, S: int):
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0, 1e14, (N, S))
    omega = rng.uniform(0, 100, (N, S))
    cap = rng.uniform(5e13, 2e14, N)
    floors = np.where(rng.random((N, S)) < 0.3,
                      rng.uniform(0, 2e13, (N, S)), 0.0)
    mask = rng.random((N, S)) < 0.9
    return psi, omega, floors, cap, mask


def to_dev(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(DEV) for a in arrays]


def bits_equal(a: np.ndarray, b: np.ndarray) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


# --------------------------------------------------------------------------- #
# phase 3: kernels against their plain versions
# --------------------------------------------------------------------------- #
def check_event_step(kind: str, seed: int, B: int, S: int) -> float:
    """Kernel vs plain version on the card (torch.equal on all five
    outputs) and vs the host numpy core (bit patterns).  Returns the max
    abs error of the float outputs against the plain version (0.0)."""
    a = step_inputs(kind, seed, B, S)
    dev = to_dev([a[k] for k in STEP_KEYS])
    got = ops.event_step(*dev)
    want = ref.event_step_ref(*dev)
    torch.cuda.synchronize()
    names = ("rem_g", "rem_c", "started", "t_comp", "sid")
    for name, g, w in zip(names, got, want):
        if g.dtype != w.dtype or not torch.equal(g, w):
            raise AssertionError(
                f"event_step[{kind} B={B} S={S}]: {name} differs from the "
                "plain version")
    stub = types.SimpleNamespace(
        B=B, S=S, alloc_g=a["alloc_g"].copy(), alloc_c=a["alloc_c"].copy(),
        head_rem_g=a["rem_g"].copy(), head_rem_c=a["rem_c"].copy(),
        head_mask=a["avail"].copy(), reconfig_until=np.zeros((B, S)),
        head_started=np.zeros((B, S), bool))
    tc, sid = NumpyBatchedEventCore().step(stub, a["t"].copy(),
                                           a["t_ev"].copy(), a["live"].copy())
    host = (stub.head_rem_g, stub.head_rem_c, stub.head_started, tc,
            sid.astype(np.int32))
    for name, g, h in zip(names, got, host):
        if not bits_equal(g.cpu().numpy(), h):
            raise AssertionError(
                f"event_step[{kind} B={B} S={S}]: {name} is not bit-for-bit "
                "the host numpy core's")
    err = 0.0
    for g, w in zip(got, want):
        if g.dtype == torch.float64:
            fin = torch.isfinite(w)
            if bool(fin.any()):
                err = max(err, float((g[fin] - w[fin]).abs().max()))
    return err


def check_alloc(seed: int, N: int, S: int):
    """Kernel vs plain f32 version on the card: ``rtol=1e-4,
    atol=cap*1e-5`` (f32 sums taken in another order), ``feasible`` equal.
    Returns (max abs err, max err relative to the row's capacity)."""
    psi, omega, floors, cap, mask = alloc_inputs(seed, N, S)
    dev = to_dev([x.astype(np.float32) for x in (psi, omega, floors, cap)]
                 + [mask])
    al, fe, pin = ops.alloc_active_set(*dev)
    r_al, r_fe, _ = ref.alloc_active_set_ref(*dev)
    torch.cuda.synchronize()
    if not torch.equal(fe, r_fe):
        raise AssertionError(f"alloc_active_set[{N}x{S}]: feasible differs")
    cap_col = dev[3][:, None]
    diff = (al - r_al).abs()
    bound = 1e-4 * r_al.abs() + 1e-5 * cap_col
    if not bool((diff <= bound).all()) or not bool(torch.isfinite(al).all()):
        raise AssertionError(
            f"alloc_active_set[{N}x{S}]: outside rtol=1e-4, atol=cap*1e-5 "
            f"(max abs {float(diff.max()):.3e})")
    if bool((pin & ~dev[4]).any()) or bool((al[~dev[4]] != 0).any()):
        raise AssertionError(f"alloc_active_set[{N}x{S}]: masked lanes leak")
    over = al.sum(1) - dev[3] * (1 + 1e-4)
    if bool((over > 0).any()):
        raise AssertionError(f"alloc_active_set[{N}x{S}]: over capacity")
    return float(diff.max()), float((diff / cap_col).max())


def event_step_bound_ms(B: int, S: int):
    # each input read once, each output written once
    bytes_ = B * S * (4 * 8 + 1) + B * (8 + 8 + 1) \
        + B * S * (2 * 8 + 1) + B * (8 + 4)
    # per lane: 4 divisions, 2 products, ~8 adds / subtracts / mins (f64)
    flops = B * S * 14
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F64_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations", bytes_


def alloc_bound_ms(N: int, S: int, rounds: torch.Tensor):
    bytes_ = N * S * (3 * 4 + 1) + N * 4 + N * S * (4 + 1) + N
    # per lane: ~8 set-up operations, then ~7 per fixed-point round — and
    # the rounds are what THIS data needed, row by row
    flops = S * (8 * N + 7 * int(rounds.sum()))
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else \
        "operations", bytes_


def phase_kernels(args):
    B, S = args.batch, 3 * args.nodes
    errs = [check_event_step("random", 0, B, S)]
    n_cases = 1
    for kind in ("random", "stalled", "unavailable", "dead-rows", "all-inf",
                 "ties", "heap-first"):
        for (b, s) in ((5, 1), (5, 7), (4, 37), (3, 128), (5, 200),
                       (2, 1441)):
            errs.append(check_event_step(kind, 1, b, s))
            n_cases += 1
    dev = to_dev([step_inputs("random", 0, B, S)[k] for k in STEP_KEYS])
    es_ms = median_ms(lambda: ops.event_step(*dev))
    es_plain = median_ms(lambda: ref.event_step_ref(*dev), iters=20)
    es_bound, es_by, es_bytes = event_step_bound_ms(B, S)
    event = {"name": "event_step", "shape": [B, S], "cases": n_cases,
             "max_abs_err": max(errs), "bitwise_vs_host_numpy": True,
             "ms": es_ms, "plain_ms": es_plain, "bound_ms": es_bound,
             "bound_by": es_by, "bytes": es_bytes}

    alloc_shapes = [(1024, 64), (args.alloc_n, 128)]
    alloc = []
    for (N, S_) in alloc_shapes + [(7, 1), (5, 37), (3, 1440), (2, 3000)]:
        abs_err, cap_rel = check_alloc(2, N, S_)
        alloc.append({"shape": [N, S_], "max_abs_err": abs_err,
                      "max_err_over_cap": cap_rel})
    for rec, (N, S_) in zip(alloc, alloc_shapes):
        psi, omega, floors, cap, mask = alloc_inputs(2, N, S_)
        d = to_dev([x.astype(np.float32)
                    for x in (psi, omega, floors, cap)] + [mask])
        rounds = ref.alloc_active_set_rounds(*d)
        bound, by, nbytes = alloc_bound_ms(N, S_, rounds)
        rec.update(ms=median_ms(lambda: ops.alloc_active_set(*d)),
                   plain_ms=median_ms(
                       lambda: ref.alloc_active_set_ref(*d), iters=20,
                       repeats=3),
                   bound_ms=bound, bound_by=by, bytes=nbytes,
                   mean_rounds=float(rounds.double().mean()),
                   max_rounds=int(rounds.max()))
    emit("kernels", event_step=event, alloc_active_set=alloc,
         timing="CUDA events, 5 warm-up + 50 launches (plain: 20), median "
                "of 5 repeats, inputs L2-warm")
    return event, alloc[1]


# --------------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------------- #
def fingerprint(res):
    summary = {k: None if isinstance(v, float) and math.isnan(v) else v
               for k, v in res.summary().items()}
    return (summary, res.n_events, res.infeasible_events,
            sorted(res.dropped), res.truncated,
            [(r.rid, r.target_sid) for r in res.requests],
            [(t, a.sid, a.src, a.dst) for t, a in res.migrations])


def phase_run_batch(args):
    sc = make_scenario("dense-urban", seed=0, n_nodes=args.nodes)
    S = len(sc["instances"])
    B = args.batch
    workloads = [workload_for(sc, seed=1 + s,
                              n_ai_requests=args.requests)[0]
                 for s in range(B)]
    sim = Simulator(sc)                      # engine=None, device="cuda"

    def haf_static(**kw):
        return sim.run_batch(workloads, lambda b: StaticPlacement(),
                             lambda b: DeadlineAwareAllocation(), **kw)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dev_res = haf_static()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    launches = ops.launch_counts()["event_step"]

    t0 = time.perf_counter()
    host_res = haf_static(engine="numpy")
    host_wall = time.perf_counter() - t0

    if dev_res[0].engine != "cuda" or host_res[0].engine != "numpy":
        raise AssertionError("run_batch did not use the engines asked for")
    events = sum(r.n_events for r in dev_res)
    ticks = max(r.n_events for r in dev_res)
    # every tick is one launch: B replicas move one event each per tick, and
    # the last tick finds every replica drained
    if not ticks <= launches <= ticks + 1:
        raise AssertionError(
            f"event_step launches ({launches}) do not match the run's "
            f"ticks ({ticks})")
    bitwise = True
    for b, (d, h) in enumerate(zip(dev_res, host_res)):
        if fingerprint(d) != fingerprint(h):
            raise AssertionError(f"replica {b}: discrete outcomes differ "
                                 "between the cuda and numpy engines")
        fd = np.array([r.finish for r in d.requests])
        fh = np.array([r.finish for r in h.requests])
        if not np.allclose(fd, fh, rtol=0, atol=1e-9):
            raise AssertionError(
                f"replica {b}: finish times differ by "
                f"{np.abs(fd - fh).max():.3e} > 1e-9")
        bitwise = bitwise and bits_equal(fd, fh)
        if d.truncated or not all(math.isfinite(x) for x in fd):
            raise AssertionError(f"replica {b}: truncated or non-finite")
    overall = [r.summary()["overall"] for r in dev_res]
    if not all(0.0 < x <= 1.0 for x in overall):
        raise AssertionError(f"fulfillment out of range: {overall}")

    # the h2d / kernel / d2h split, from one profiled run
    before = ops.launch_counts()["event_step"]
    prof_res = haf_static(obs=obs.ObsConfig(profile=True))
    phases = prof_res[0].profile["phases"]
    prof_launches = ops.launch_counts()["event_step"] - before
    if phases["core.kernel"]["count"] != prof_launches \
            or phases["engine.step"]["count"] != prof_launches:
        raise AssertionError("profiled run: ticks and launches disagree")
    if [fingerprint(r) for r in prof_res] != [fingerprint(r) for r in dev_res]:
        raise AssertionError("profiled run changed the outcome")
    split = {k: {"total_s": phases[k]["total_s"],
                 "mean_us": phases[k]["mean_us"]}
             for k in ("core.h2d", "core.kernel", "core.d2h", "engine.step",
                       "engine.events", "allocator.solve", "run")
             if k in phases}
    emit("run_batch", family="dense-urban", n_nodes=args.nodes, S=S, B=B,
         n_ai_requests=args.requests,
         cut=(f"n_ai_requests {FULL_REQUESTS} -> {args.requests} (run time); "
              "S and B full" if args.requests < FULL_REQUESTS else None),
         requests_per_replica=len(workloads[0]), method="haf-static",
         ticks=launches, events=events,
         cuda={"wall_s": dev_wall, "events_per_s": events / dev_wall},
         numpy={"wall_s": host_wall, "events_per_s": events / host_wall},
         fingerprints_equal=True, finish_atol=1e-9,
         finish_bitwise_equal=bitwise,
         mean_overall_fulfillment=float(np.mean(overall)),
         profiled_split=split)
    return launches


# --------------------------------------------------------------------------- #
# phase 5: the second path
# --------------------------------------------------------------------------- #
def phase_allocate_cluster(args):
    N, S = args.alloc_n, 128
    rng = np.random.default_rng(5)
    psi_g, omega, fg, cap_g, mask = alloc_inputs(5, N, S)
    psi_c = rng.uniform(0, 4.0, (N, S))
    fc = np.where(rng.random((N, S)) < 0.3, rng.uniform(0, 0.5, (N, S)), 0.0)
    cap_c = rng.uniform(8.0, 64.0, N)
    host = (psi_g, psi_c, omega, fg, fc, cap_g, cap_c, mask)
    dev = to_dev(host)

    ops.reset_launch_counts()
    g, c = allocator.allocate_cluster(*dev, use_kernel=True)
    torch.cuda.synchronize()
    launches = ops.launch_counts()["alloc_active_set"]
    if launches != 2:
        raise AssertionError(f"allocate_cluster launched {launches} kernels, "
                             "expected 2 (GPU and CPU problem)")
    g_default, _ = allocator.allocate_cluster(*dev)    # None -> the kernel
    if not torch.equal(g_default.alloc, g.alloc):
        raise AssertionError("allocate_cluster default path is not the kernel")

    t0 = time.perf_counter()
    g_np, c_np, feas_np = allocate_cluster_np(*host)
    host_s = time.perf_counter() - t0
    errs = {}
    for name, got, want, cap in (("gpu", g, g_np, cap_g),
                                 ("cpu", c, c_np, cap_c)):
        a = got.alloc.double().cpu().numpy()
        diff = np.abs(a - want)
        if not (diff <= 1e-4 * np.abs(want) + 1e-5 * cap[:, None]).all():
            raise AssertionError(
                f"allocate_cluster {name}: outside rtol=1e-4, atol=cap*1e-5 "
                f"of the host solver (max abs {diff.max():.3e})")
        errs[name] = {"max_abs_err": float(diff.max()),
                      "max_err_over_cap": float((diff / cap[:, None]).max())}
    feas = (g.feasible & c.feasible).cpu().numpy()
    if not np.array_equal(feas, feas_np):
        raise AssertionError("allocate_cluster: feasible differs from host")
    ms = median_ms(lambda: allocator.allocate_cluster(*dev, use_kernel=True),
                   iters=20)
    emit("allocate_cluster", N=N, S=S, launches=launches, errors=errs,
         feasible_equal=True, call_ms=ms, host_numpy_s=host_s,
         tolerance="rtol=1e-4, atol=cap*1e-5 vs float64 allocate_cluster_np")
    return launches


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=480,
                   help="dense-urban fleet size (S = 3 * nodes)")
    p.add_argument("--batch", type=int, default=32, help="replicas B")
    p.add_argument("--requests", type=int, default=FULL_REQUESTS // 2,
                   help="n_ai_requests per replica (default: half the "
                        f"reference bench's {FULL_REQUESTS}, which keeps the "
                        "three run_batch passes to a few minutes on a slow "
                        "host; S and B are never cut)")
    p.add_argument("--alloc-n", type=int, default=16384,
                   help="node rows of the fleet-wide allocator solve")
    args = p.parse_args()

    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=kind, capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=smi)

    t0 = time.perf_counter()
    libs = _build.load()
    emit("build", seconds=time.perf_counter() - t0, nvcc=_build.find_nvcc(),
         flags=" ".join(_build.NVCC_FLAGS), libraries=sorted(libs),
         build_dir=os.path.relpath(_build.BUILD_DIR, HERE))

    event, alloc = phase_kernels(args)
    event_launches = phase_run_batch(args)
    alloc_launches = phase_allocate_cluster(args)

    def row(name, rec, launches, replaces, tolerance):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": None,
                "shape": rec["shape"], "tolerance": tolerance}

    print(json.dumps({"kernels": [
        row("event_step", event, event_launches,
            "src/repro/kernels/event_step.py:34",
            "bit-for-bit (torch.equal on all five outputs)"),
        row("alloc_active_set", alloc, alloc_launches,
            "src/repro/kernels/alloc_active_set.py:31",
            "rtol=1e-4, atol=capacity*1e-5 (f32 sums in another order; "
            "capacity up to 2e14), feasible equal"),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
