#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port starts and is right on the GPU.

    python3 chip_smoke.py            # needs one NVIDIA GPU (sm_90a) and nvcc

Twelve phases, one JSON line each (phases 2 and 3 two, phase 7 five, phase
8 four, phase 9 three); any failure ends the run with a non-zero exit code:

  1. env               torch / CUDA versions, the card's name and power limit
  2. build             nvcc-compile every kernel from src/repro_torch/kernels/csrc,
                       with each source's flags, registers, spills and shared
                       memory as ptxas reports them (the run fails on a
                       spill), and the tensor-core and asynchronous-copy
                       instructions in the SASS of flash_attention,
                       ssd_scan and alloc_active_set (cuobjdump; the run
                       fails if a bf16 kernel has no HGMMA, or the
                       allocator's warp-route kernel no bulk copy, UBLKCP)
  3. kernels           each kernel against its plain torch version on the card
                       (event_step also bit-for-bit against the host numpy
                       core, at shapes that take a one-CTA cluster, a row end
                       inside a warp and a strided rest past the lanes held
                       in registers; alloc_active_set on two kinds of data at
                       shapes that end in a partial tile, have odd rows, and
                       sit on either side of its two routes' border), with
                       times: CUDA events, warm-up, >= 20 launches, and
                       torch.profiler's device time and launches a call (the
                       launches from the trace's host-side launch records)
  4. run_batch         the main path: Simulator.run_batch, HAF-Static, the
                       dense-urban fleet at n_nodes=480 (S = 1440 instances),
                       B = 32 replicas, default engine (the event_step kernel),
                       against the same workloads on engine="numpy"
  4b. haf              the paper's method on the same path: the critic's
                       training data harvested through run_batch on the cuda
                       engine (bitwise the numpy engine's), the critic trained
                       on the card (held-out loss below the untrained one's,
                       torch forward within 1e-5 of the host forward_np,
                       save -> load keeps fingerprint and bytes), HAF
                       (qwen3-32b-sim stand-in + that critic) on the paper
                       scenario at rho 1.0, B = 32, cuda against numpy as in
                       phase 4 with >= 1 migration, and spot-churn at B = 8
                       cuda against numpy (forced migrations included); the
                       five baselines' SLO fulfilment beside HAF's comes
                       from phase eval's Table III
  4b'. examples        examples/torch, each script's main() in-process on
                       the card: quickstart whole (its allocation within
                       rtol 1e-4, atol capacity*1e-5 of the same call on the
                       host; results on the card), haf_serving at 300
                       requests with phase haf's critic (static and HAF
                       summaries equal to the numpy engine's, P1; a launch a
                       tick, and one, a run) and train_100m at 6 steps with a
                       failure at step 3 (restarts == [3])
  4c. eval             the experiment harness: the critic of phase haf saved
                       into a fresh artifact store ($REPRO_ARTIFACTS), then
                       experiments/paper_table3.toml, unchanged, through
                       python -m repro_torch.eval (400 requests a replica,
                       seeds 0..7, two spawn workers) on the default engine
                       (cuda: six run_batch groups of B = 8) and with
                       --engine numpy, into fresh reports: rows equal,
                       nothing failed, truncated, resumed, retried or
                       degraded, HAF above every baseline; HAF's group
                       in-process through eval.sweep.run_batch_jobs with its
                       event_step launches counted (= ticks + 1) and its
                       traced finish times within 1e-9 of the numpy
                       group's; the other two spec files validated,
                       trace_sweep.toml run on one seed and the first 500
                       rows of its trace (one-replica run_batch groups,
                       streamed, traced, profiled) and a trace read back by
                       python -m repro_torch.obs summary; the serving
                       launcher repro_torch.launch.serve with the saved
                       critic (its main() in-process: one-replica run_batch,
                       event_step launches = ticks + 1); and a spawn
                       worker's start-up
  5. allocate_cluster  the second path: the fleet-wide allocator through the
                       alloc_active_set kernel at (N, S) = (16384, 128)
                       against the float64 host solver, with the call's
                       device time by torch.profiler
  6. serve             the model zoo's serving path, build_model -> init ->
                       prefill -> pad_cache -> greedy decode_step, for every
                       config of configs/: qwen2-0.5b, whisper-medium and
                       llava-next-mistral-7b (impl="flash": flash_attention),
                       mamba2-130m (impl="pallas": ssd_scan), zamba2-2.7b
                       under both (9 flash launches, or 54 ssd_scan calls,
                       a prefill), deepseek-v2-lite-16b (impl="flash": MLA
                       reaches no kernel, 0 launches asserted) and
                       deepseek-v3-671b (impl="xla", 4 of 61 layers), each
                       at full width: float32 parity with impl="xla" (caches
                       too) at S = 512 and 300 where the path has a kernel,
                       prefill + decode == forward,
                       then 4 requests of 512 tokens (llava: after 576 patch
                       embeddings; whisper: beside 1500 encoder frames)
                       served in the config's bf16, kernel launches a
                       prefill asserted per model; rmsnorm launches a
                       prefill reported (a kernel lowering sends every
                       norm to it; two a layer and the final one asserted
                       for qwen2 and llava, 65; none under impl="xla");
                       causal_conv_silu launches asserted, three a Mamba2
                       mixer under a kernel lowering
  7. train             the training path (impl="xla": no kernel launches,
                       asserted): qwen2-0.5b at full width and depth in bf16
                       (S = 512, global batch 8, remat "dots"), 24 steps with
                       checkpoints every 8 and an injected failure at step
                       13 (restarts == [13], the loss falls, the latest
                       checkpoint is step 24 and a cold restore gives the
                       final parameters and AdamW state bit for bit), its
                       step time, tokens/s, peak memory, the idle share of a
                       profiled step and the model-FLOP share of 989 TFLOP/s;
                       mamba2-130m at full width with int8 gradient
                       compression (the loss falls); python -m
                       repro_torch.launch.train --steps 4 in-process for
                       every config of configs/ (the default 100m preset,
                       float32: finite losses); card float32 against host
                       float64 at the 100m width and 2 layers for qwen2,
                       mamba2 and deepseek-v3 (MTP gradients non-zero), and
                       one AdamW step card against host; and impl="flash"
                       refusing to be differentiated
  8. mesh              four spawned ranks share the card as a 2x2 (data x
                       model) mesh over the cpu:gloo,cuda:hoststaged backend
                       (gloo's CUDA functional collectives crash in torch
                       2.11): qwen2-0.5b at full width, 2 layers, float32,
                       5 steps against one rank (losses within 1e-5, the
                       parameters within 1e-4 of the tree's largest
                       magnitude); qwen2-0.5b full in bf16, 8 steps with
                       checkpoints every 4 and a failure at step 5
                       (restarts == [5], the loss falls, the final checkpoint
                       restored in one process bit for bit; each rank's share
                       of the parameter and moment bytes, ms a step, peak
                       memory a rank); the impl="flash" prefill of 4 x 512
                       tokens in float32 on the mesh (24 flash launches a
                       rank, logits within 1e-4 of the one-card prefill)
  9. dryrun            qwen2-0.5b at phase train's shape traced by
                       repro_torch.launch.dryrun on a 1x1 fake mesh: its
                       counted FLOPs and argument bytes equal to the same
                       count over the real step on the card, the bound
                       max(FLOPs / 989.4 T, bytes / 3.35 T) against the
                       step's ms; then python -m repro_torch.launch.dryrun on
                       qwen2-0.5b and mamba2-130m on the 16x16 mesh, a
                       subprocess a cell, all started beside phase build (a
                       cell needs no card and one host core) and collected
                       before phase kernels, so no timed phase shares the
                       host with them

Phase 3 also holds flash_attention, ssd_scan and rmsnorm against their plain
versions (flash_attention and ssd_scan at zamba2's shapes too: head dim 80,
d_state 64; flash_attention at llava's prefill, head dim 128; rmsnorm with
a bf16 weight read bit for bit as its float32 widening) and times them beside
PyTorch's own call for the same function (rmsnorm also at llava's norms,
[1368 | 8192 | 32768, 4096] bf16 with the bf16 weight), and
causal_conv_silu against the float32 composite at C 7168, 5120, 1536 and
128, timed at zamba2-7b's (4, 4096, 7168) and (4, 4096, 128) beside its
bytes bound and the eager composite
(flash_attention in bf16, its tensor-core design, and in float32, its
CUDA-core design; ssd_scan in bf16, its tensor-core design, held
both to the sequential recurrence and to ssd_scan_chunked_ref with the
kernel's rounding points, and in float32, its CUDA-core design).  Then a line
{"kernels": [...]} (per kernel: route, source, the TPU kernel it replaces,
launches on its path — flash's with the mesh prefill's four ranks —, error,
time, plain-version time, roofline bound and the bound's share of the time,
library time and the kernel's ratio to it), the
card's name and power limit as nvidia-smi prints them, and the last line
{"ok": true, "device": {...}}.

With no options the fleet is full size (S = 1440, B = 32) and each replica's
request stream is an eighth of the reference bench's, which keeps the
script's run time well inside its limit on a slow host; ``--requests 4960``
runs the whole stream.  Phase haf runs 700 of paper_table3's 5000 requests a
replica (``--haf-requests``), a cut harvest (``--harvest-bulk``,
``--harvest-probe``) and the reference's 2000 training epochs
(``--critic-epochs``); phase eval runs paper_table3 at 400 requests a
replica on seeds 0..7.  The other options shrink the run for a rehearsal; the served models always run at their configs' full
width, and at full depth but where a model does not fit one card (phase
serve's SERVE says which depths are cut).  ``--only model_kernels`` builds
the kernels and runs the build report and phase model_kernels alone: run it
from ``git archive`` copies of two trees in one session (A, B, B, A) to
compare their model kernels on one card.  ``--only serve`` builds the
kernels and runs phase serve alone.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib.util
import io
import json
import math
import os
import pathlib
import re
import shutil
import subprocess
import sys
import tempfile
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
from repro_torch.configs import get_config
from repro_torch.core import allocator
from repro_torch.core.allocator_np import allocate_cluster_np
from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.alloc_active_set import alloc_active_set_geometry
from repro_torch.kernels.event_step import event_step_geometry
from repro_torch.kernels.ssd_scan import FOLD_CHUNKS
from repro_torch.models.api import build_model
from repro_torch.models.common import rms_norm, tree_leaves, tree_map
from repro_torch.core import HAFPlacement, datagen, make_agent
from repro_torch.core import critic as critic_mod
from repro_torch.eval import sweep
from repro_torch.exp import ExperimentSpec, expand_experiment
from repro_torch.exp.artifacts import read_manifest, save_critic
from repro_torch.launch import serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.train import make_pipeline, preset_config
from repro_torch.configs import ARCH_NAMES
from repro_torch.data import DataPipeline
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression
from repro_torch.distributed.failure import FailureInjector
from repro_torch.models.api import Model
from repro_torch.train.loop import (TrainConfig, batch_to_device,
                                    make_train_step, train, value_and_grad)
from repro_torch.train.optimizer import adamw_init, adamw_update
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             make_scenario, paper_scenario, workload_for)
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement
from repro_torch.sim.event_core import NumpyBatchedEventCore

DEV = torch.device("cuda", 0)
SMS = torch.cuda.get_device_properties(0).multi_processor_count
INF = float("inf")

# published peaks of one H100 SXM (NVIDIA data sheet): HBM3 bandwidth,
# float32 outside the tensor cores, float64 at half that rate, and the dense
# bf16 tensor-core rate
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 33.5e12
BF16_TC_FLOPS = 989e12

# the device kernels of each serving kernel, by a part of their names
# (flash: the tile of one swizzle row, d <= 64, and the designs of d = 80
# and d = 128; ssd_scan: the pass kernel runs past FOLD_CHUNKS chunks only)
SERVE_KERNEL_NAMES = {"flash_attention": ("flash_tc_kernel",
                                          "flash_tc80_kernel",
                                          "flash_tc128_kernel",
                                          "flash_tc224_kernel"),
                      "ssd_scan": ("ssd_state_kernel", "ssd_pass_kernel",
                                   "ssd_out_kernel")}
SERVE_B, SERVE_S, SERVE_STEPS, RAGGED_S = 4, 512, 32, 300
SEED = 0                     # of the served models' weights and prompts

# n_ai_requests of the reference's fleet-size bench cell
FULL_REQUESTS = 4960
# n_ai_requests of the paper's comparison (experiments/paper_table3.toml)
HAF_FULL_REQUESTS = 5000
CHURN_B = 8                  # replicas of the spot-churn check

STEP_KEYS = ("rem_g", "rem_c", "alloc_g", "alloc_c", "avail", "t", "t_ev",
             "live")


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# --------------------------------------------------------------------------- #
# phase 2: what the compiler made of each kernel
# --------------------------------------------------------------------------- #
# SASS opcodes counted in flash_attention's library: tensor-core products and
# asynchronous global -> shared copies (and TMA stores, counted beside them)
TENSOR_CORE_OPS = ("HGMMA", "HMMA")
ASYNC_COPY_OPS = ("UTMALDG", "UBLKCP", "LDGSTS")
TMA_STORE_OPS = ("UTMASTG",)


def find_cuobjdump() -> str:
    """``cuobjdump`` from the toolkit that holds ``nvcc``, or from Triton's
    bundled copy; raises if there is none (the SASS check does not skip)."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.path.dirname(_build.find_nvcc()), "cuobjdump"),
             "/usr/local/cuda/bin/cuobjdump"]
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__),
                                  "backends", "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for cand in cands:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("cuobjdump not found (PATH, next to nvcc, "
                       "/usr/local/cuda/bin, triton/backends/nvidia/bin)")


def short_names(mangled):
    """Demangled kernel names without their argument lists, where
    ``c++filt`` is there; the mangled names otherwise."""
    filt = shutil.which("c++filt")
    if not filt or not mangled:
        return list(mangled)
    out = subprocess.run([filt], input="\n".join(mangled), text=True,
                         capture_output=True, check=True).stdout.splitlines()
    return [n.replace("(anonymous namespace)::", "").removeprefix("void ")
            .split("(")[0] for n in out]


def ptxas_report(name: str):
    """Per kernel function of ``csrc/<name>.cu``: registers, spill bytes and
    static shared memory, from the ``-Xptxas -v`` lines of its build log."""
    log = (_build.BUILD_DIR / f"{name}.nvcc.log").read_text()
    funcs = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            funcs.append({"function": m.group(1)})
            continue
        if not funcs:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            funcs[-1]["spill_stores"] = int(m.group(1))
            funcs[-1]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            funcs[-1]["registers"] = int(m.group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            funcs[-1]["static_smem"] = int(sm.group(1)) if sm else 0
    for f, short in zip(funcs, short_names([f["function"] for f in funcs])):
        f["function"] = short
    return funcs


def sass_counts(lib) -> dict:
    """``{kernel: {opcode: count}}`` of the tensor-core and asynchronous-copy
    instructions in a library's SASS (``cuobjdump -sass``)."""
    sass = subprocess.run([find_cuobjdump(), "-sass", str(lib)], check=True,
                          capture_output=True, text=True).stdout
    per, fn = {}, None
    ops_ = TENSOR_CORE_OPS + ASYNC_COPY_OPS + TMA_STORE_OPS
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            per[fn] = dict.fromkeys(ops_, 0)
            continue
        if fn is not None:
            for op in ops_:
                if re.search(r"\b" + op + r"(\.|\s|$)", line):
                    per[fn][op] += 1
    return dict(zip(short_names(list(per)), per.values()))


# the bf16 tensor-core kernels of each library, by a part of their names
TC_KERNELS = {"flash_attention": ("flash_tc_kernel", "flash_tc80_kernel",
                                  "flash_tc128_kernel"),
              "ssd_scan": ("ssd_state_kernel", "ssd_out_kernel")}
# the kernels fed by 1-D bulk copies (cp.async.bulk -> UBLKCP in the SASS)
BULK_KERNELS = {"alloc_active_set": ("alloc_warp_kernel",)}


def phase_build(libs) -> None:
    ptxas = {name: ptxas_report(name) for name in sorted(libs)}
    spills = [f"{name}:{f['function']}" for name, funcs in ptxas.items()
              for f in funcs if f.get("spill_stores") or f.get("spill_loads")]
    if spills:
        raise AssertionError(f"register spills in {spills}")
    # ptxas's notes that it serialised a kernel's wgmma (a product issued in
    # a branch, or too few registers for the accumulators): reported for
    # every library, fatal for flash_attention, whose kernels have none
    notes = {name: [line.strip() for line in (
        _build.BUILD_DIR / f"{name}.nvcc.log").read_text().splitlines()
        if "Potential Performance Loss" in line] for name in sorted(libs)}
    if notes.get("flash_attention"):
        raise AssertionError(f"ptxas serialised flash_attention's wgmma: "
                             f"{notes['flash_attention']}")
    report = {}
    for lib, kernels in TC_KERNELS.items():
        sass = sass_counts(libs[lib])
        for part in kernels:
            tc = {k: c for k, c in sass.items() if part in k}
            if not tc:
                raise AssertionError(f"{lib}: no {part} in the library's SASS "
                                     f"({sorted(sass)})")
            for k, c in tc.items():
                if not sum(c[op] for op in TENSOR_CORE_OPS) \
                        or not sum(c[op] for op in ASYNC_COPY_OPS):
                    raise AssertionError(
                        f"{k}: no tensor-core or no asynchronous-copy "
                        f"instruction in its SASS: {c}")
        totals = {op: sum(c[op] for c in sass.values())
                  for op in TENSOR_CORE_OPS + ASYNC_COPY_OPS
                  + TMA_STORE_OPS}
        report[f"{lib}_sass"] = {"per_kernel": sass, "library_total": totals}
    for lib, kernels in BULK_KERNELS.items():
        sass = sass_counts(libs[lib])
        for part in kernels:
            found = {k: c for k, c in sass.items() if part in k}
            if not found:
                raise AssertionError(f"{lib}: no {part} in the library's SASS "
                                     f"({sorted(sass)})")
            for k, c in found.items():
                if not c["UBLKCP"]:
                    raise AssertionError(f"{k}: no bulk copy (UBLKCP) in its "
                                         f"SASS: {c}")
        report[f"{lib}_sass"] = {"per_kernel": sass}
    emit("build_report", ptxas=ptxas, spills=False,
         performance_notes=notes, cuobjdump=find_cuobjdump(), **report)


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


def trace(fn, iters: int = 1):
    """``(wall ms per call, events)`` of ``iters`` calls of ``fn`` under
    torch.profiler: the host clock around the calls, which the profiler
    slows, and the trace's events (host-side API records and device-side
    kernel records).  A throw-away ``spin_kernel`` is launched first: on the
    card a trace has missed the device record of the first kernel of its
    window far more often than any other."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / iters
    return wall, prof.events()


def kernel_records(events):
    """The device-side kernel records of a trace, the spin kernel left out."""
    from torch.autograd import DeviceType
    return [e for e in events if e.device_type == DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and "spin_kernel" not in e.name]


def device_times(fn, iters: int = 1):
    """``(wall ms, {kernel: device µs}, {kernel: launches})`` per call of
    ``fn`` over ``iters`` calls, from the device-side records of a trace
    (which may miss some, see profiled)."""
    wall, events = trace(fn, iters)
    per, calls = {}, {}
    for e in kernel_records(events):
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / iters
        calls[e.name] = calls.get(e.name, 0) + 1 / iters
    return wall, per, calls


# the host-side API records of a kernel launch (CUDA runtime and driver)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel",
               "cuLaunchKernel", "cuLaunchCooperativeKernel")


def launch_records(events):
    """The trace's kernel launches in the order the host made them, from the
    host-side API records (one per correlation id): each as the name of the
    kernel whose device-side record has the same correlation id, or None
    where the trace holds no device-side record of that launch."""
    from torch.autograd import DeviceType
    kernel = {e.id: e.name for e in kernel_records(events)}
    seen, out = set(), []
    for e in sorted(events, key=lambda e: e.time_range.start):
        if e.device_type == DeviceType.CPU and e.name.startswith(LAUNCH_APIS) \
                and e.id not in seen:
            seen.add(e.id)
            out.append(kernel.get(e.id))
    return out


PROFILE_TRACES = 3


def profiled(fn, parts, iters: int = 20):
    """``({part: device µs}, {part: launches}, dropped)`` per call of
    ``fn``; fails unless each of ``parts`` (a substring of kernel names) is
    launched exactly once a call.  Launches are counted from the host-side
    launch records of one trace, which a call makes in a fixed order: a
    launch whose device-side record the trace lacks takes the kernel that
    the same place in the order has in the other calls.  ``dropped`` counts
    those launches; a part's device µs is its mean over its traced records
    times its launches a call.  A trace that lacks the device-side record of
    one place in the order in every call names no kernel for it (the card's
    profiler has lost all of a kernel's records in a trace): it is taken
    again, ``PROFILE_TRACES`` traces at most."""
    fn()
    for _ in range(PROFILE_TRACES):
        _, events = trace(fn, iters)
        recs = launch_records(events)
        if not recs or (recs[0] is not None
                        and "spin_kernel" not in recs[0]):
            raise AssertionError(f"profiled {parts}: the trace does not "
                                 f"open with the spin kernel's launch: "
                                 f"{recs[:1]}")
        recs = recs[1:]
        if not recs or len(recs) % iters:
            raise AssertionError(f"profiled {parts}: {len(recs)} launch "
                                 f"records in {iters} calls, not the same "
                                 "number a call")
        width = len(recs) // iters
        order = []
        for j in range(width):
            names = {recs[i * width + j] for i in range(iters)} - {None}
            if len(names) > 1:
                raise AssertionError(f"profiled {parts}: launch {j} of a "
                                     f"call is of kernels {sorted(names)} "
                                     f"over {iters} calls, not of one")
            if not names:
                print(f"profiled {parts}: no device record of launch {j} "
                      f"in {iters} calls; tracing again", file=sys.stderr,
                      flush=True)
                break
            order.append(names.pop())
        else:
            break
    else:
        raise AssertionError(f"profiled {parts}: a launch of each call has "
                             f"no device record in {PROFILE_TRACES} traces of "
                             f"{iters} calls")
    launches = {part: sum(part in k for k in order) for part in parts}
    if any(n != 1 for n in launches.values()):
        raise AssertionError(f"profiled launches per call of {parts}: "
                             f"{launches}, expected one each (order "
                             f"{order})")
    us = {}
    for part in parts:
        times = [e.time_range.elapsed_us() for e in kernel_records(events)
                 if part in e.name]
        if len(times) > iters:
            raise AssertionError(f"profiled {part}: {len(times)} device "
                                 f"records for {iters} launches")
        us[part] = sum(times) / len(times)
    return us, launches, sum(k is None for k in recs)


def host_us(fn, calls: int = 200):
    """``(median, 10th percentile)`` host µs of one call of ``fn``, wall
    clock around the call with no synchronisation (what the caller's thread
    spends to enqueue it; the percentile is less moved by a busy host)."""
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


# kinds of allocator data: "yardstick" (the kernel table's timed row from
# the first port of this kernel on; at S = 128 nearly every row's floors
# exceed its capacity and are rescaled) and "feasible" (the same draws with
# floors x 0.1: most rows keep theirs)
ALLOC_KINDS = {"yardstick": 1.0, "feasible": 0.1}


def alloc_inputs(seed: int, N: int, S: int, kind: str = "yardstick"):
    rng = np.random.default_rng(seed)
    psi = rng.uniform(0, 1e14, (N, S))
    omega = rng.uniform(0, 100, (N, S))
    cap = rng.uniform(5e13, 2e14, N)
    floors = np.where(rng.random((N, S)) < 0.3,
                      rng.uniform(0, 2e13, (N, S)), 0.0)
    mask = rng.random((N, S)) < 0.9
    return psi, omega, floors * ALLOC_KINDS[kind], cap, mask


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


def alloc_dev(seed: int, N: int, S: int, kind: str = "yardstick"):
    """The allocator's five inputs on the card, f32 and bool."""
    psi, omega, floors, cap, mask = alloc_inputs(seed, N, S, kind)
    return to_dev([x.astype(np.float32) for x in (psi, omega, floors, cap)]
                  + [mask])


def check_alloc(seed: int, N: int, S: int, kind: str = "yardstick"):
    """Kernel vs plain f32 version on the card: ``rtol=1e-4,
    atol=cap*1e-5`` (f32 sums taken in another order), ``feasible`` equal.
    Returns (max abs err, max err relative to the row's capacity)."""
    dev = alloc_dev(seed, N, S, kind)
    al, fe, pin = ops.alloc_active_set(*dev)
    r_al, r_fe, _ = ref.alloc_active_set_ref(*dev)
    torch.cuda.synchronize()
    if al.dtype != torch.float32 or fe.dtype != torch.bool \
            or pin.dtype != torch.bool:
        raise AssertionError(f"alloc_active_set[{N}x{S}]: output dtypes "
                             f"{al.dtype}, {fe.dtype}, {pin.dtype}")
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


# shapes of the event_step checks: small rows, then one whose row takes a
# one-CTA cluster (B = 140 > 132 SMs), one whose row ends inside a warp of
# an 8-CTA cluster, and one longer than the 8 x 1024 lanes a cluster holds
# in registers (the strided rest)
EVENT_SHAPES = ((5, 1), (5, 7), (4, 37), (3, 128), (5, 200), (2, 1441),
                (140, 1440), (3, 1537), (1, 20000))


def phase_kernels(args):
    B, S = args.batch, 3 * args.nodes
    errs = [check_event_step("random", 0, B, S)]
    n_cases = 1
    for kind in ("random", "stalled", "unavailable", "dead-rows", "all-inf",
                 "ties", "heap-first"):
        for (b, s) in EVENT_SHAPES:
            errs.append(check_event_step(kind, 1, b, s))
            n_cases += 1
    dev = to_dev([step_inputs("random", 0, B, S)[k] for k in STEP_KEYS])
    es_ms = median_ms(lambda: ops.event_step(*dev))
    es_prof, es_launches, es_dropped = profiled(
        lambda: ops.event_step(*dev), ("event_step",))
    es_plain = median_ms(lambda: ref.event_step_ref(*dev), iters=20)
    es_bound, es_by, es_bytes = event_step_bound_ms(B, S)
    geom = {f"{b}x{s}": event_step_geometry(b, s, SMS)._asdict()
            for b, s in ((B, S),) + EVENT_SHAPES[-3:]}
    event = {"name": "event_step", "shape": [B, S], "cases": n_cases,
             "geometry": geom,
             "max_abs_err": max(errs), "bitwise_vs_host_numpy": True,
             "ms": es_ms, "profiler_device_us": es_prof,
             "cuda_launches_per_call": sum(es_launches.values()),
             "trace_dropped_device_records": es_dropped,
             "plain_ms": es_plain, "bound_ms": es_bound,
             "bound_by": es_by, "bytes": es_bytes}

    alloc = phase_alloc_kernel(args)
    emit("kernels", event_step=event, alloc_active_set=alloc,
         timing="CUDA events, 5 warm-up + 50 launches (plain: 20), median "
                "of 5 repeats, inputs L2-warm; device µs from torch.profiler "
                "over 20 calls; wrapper host µs: median of 200 calls, wall "
                "clock around each, not synchronised")
    return event, alloc


# shapes of the alloc_active_set checks beside the two timed ones: rows of
# one and of 37 lanes (a lone partial tile), N not a multiple of the tile
# ((1023, 128): tiles of 4 rows and a last one of 3; (4097, 60)), odd S
# (2049 x 37: tiles of 16 rows, one row left), the warp route's widest row
# (1024) and the first long row (1025), and the long-row route at 1440 and
# 3000 lanes
ALLOC_SHAPES = ((7, 1), (5, 37), (1023, 128), (4097, 60), (2049, 37),
                (512, 1024), (64, 1025), (3, 1440), (2, 3000))


def phase_alloc_kernel(args):
    """alloc_active_set against its plain version at every checked shape and
    data kind, then timed at the two yardstick shapes and on the feasible
    kind at the large one.  Returns the phase's record, whose top level is
    the timed row of the kernel table: (alloc_n, 128) on yardstick data."""
    timed = [("yardstick", 1024, 64), ("yardstick", args.alloc_n, 128),
             ("feasible", args.alloc_n, 128)]
    checked = []
    for kind in ALLOC_KINDS:
        for (N, S) in [(n, s) for _, n, s in timed[:2]] + list(ALLOC_SHAPES):
            abs_err, cap_rel = check_alloc(2, N, S, kind)
            checked.append({"shape": [N, S], "kind": kind,
                            "route": alloc_active_set_geometry(N, S,
                                                               SMS).route,
                            "max_abs_err": abs_err,
                            "max_err_over_cap": cap_rel})
    recs = []
    for kind, N, S in timed:
        d = alloc_dev(2, N, S, kind)
        geom = alloc_active_set_geometry(N, S, SMS)
        if geom.route != "warp":
            raise AssertionError(f"alloc_active_set[{N}x{S}]: timed shape "
                                 f"on the {geom.route} route")
        rounds = ref.alloc_active_set_rounds(*d)
        bound, by, nbytes = alloc_bound_ms(N, S, rounds)
        dev_us, launches, dropped = profiled(
            lambda: ops.alloc_active_set(*d), ("alloc_warp_kernel",))
        ms = median_ms(lambda: ops.alloc_active_set(*d))
        dev_us = dev_us["alloc_warp_kernel"]
        host, host_p10 = host_us(lambda: ops.alloc_active_set(*d))
        recs.append({
            "shape": [N, S], "kind": kind, "route": geom.route,
            "geometry": geom._asdict(), "ms": ms,
            "profiler_device_us": dev_us,
            "cuda_launches_per_call": launches["alloc_warp_kernel"],
            "trace_dropped_device_records": dropped,
            "wrapper_host_us": host, "wrapper_host_us_p10": host_p10,
            "plain_ms": median_ms(lambda: ref.alloc_active_set_ref(*d),
                                  iters=20, repeats=3),
            "bound_ms": bound, "bound_by": by, "bytes": nbytes,
            "bound_share": bound / ms,
            "device_bound_share": bound / (dev_us / 1e3),
            "mean_rounds": float(rounds.double().mean()),
            "max_rounds": int(rounds.max()),
            "feasible_rows": float(ref.alloc_active_set_ref(*d)[1]
                                   .double().mean())})
    return {**recs[1], "max_abs_err": max(c["max_abs_err"] for c in checked),
            "cases": len(checked), "timed": recs, "checked": checked,
            "tolerance": "rtol=1e-4, atol=capacity*1e-5 vs "
                         "ref.alloc_active_set_ref, feasible equal, no "
                         "masked lane leaking, no row over capacity"}


# --------------------------------------------------------------------------- #
# phase 3 (continued): the model kernels against their plain versions
# --------------------------------------------------------------------------- #
# tests/test_kernels.py's shapes, then the serving slice's (B = 4 prompts of
# 512 tokens, and the ragged 300-token prompt), then a length no tile size
# divides and a single row; then zamba2's head dim 80 (32 heads, GQA 1:1, at
# 512, 300 and 77) and llava's 576 patches + 512 tokens (GQA 32:8 x 128);
# then the rest of the shapes phase serve gives the kernel: whisper's decoder
# (16 heads of 64, GQA 1:1) at 512 and 300, llava's ragged prompt (576 +
# 300), and the 511-token float32 prefill of each model's prefill + decode
# == forward check, and last the mesh prefill's shard on each rank of phase
# mesh's 2×2 (batch over data, qwen2's 14 query and 2 KV heads over model).
# The SSD shapes end with zamba2's geometry (80 heads of
# 64, d_state 64), then the 511-token prefills (the wrapper halves the chunk
# to 1) of mamba2 and zamba2
FLASH_SHAPES = [(2, 128, 4, 4, 64), (2, 256, 8, 2, 64), (1, 256, 4, 1, 32),
                (1, 512, 2, 2, 128), (3, 64, 6, 3, 16),
                (4, 512, 14, 2, 64), (4, 300, 14, 2, 64),
                (1, 77, 4, 2, 32), (2, 1, 2, 1, 16),
                (4, 512, 32, 32, 80), (4, 300, 32, 32, 80), (1, 77, 2, 2, 80),
                (4, 1088, 32, 8, 128),
                (4, 512, 16, 16, 64), (4, 300, 16, 16, 64),
                (4, 876, 32, 8, 128),
                (4, 511, 14, 2, 64), (4, 511, 32, 32, 80),
                (4, 511, 16, 16, 64), (4, 1087, 32, 8, 128),
                (SERVE_B // 2, SERVE_S, 14 // 2, 2 // 2, 64),
                # head dim 80's edges: one row, one and two whole 64-key
                # tiles, a key past them, a GQA group of two over 11 tiles
                (2, 1, 2, 1, 80), (1, 64, 2, 2, 80), (1, 128, 2, 2, 80),
                (1, 129, 2, 2, 80), (2, 700, 4, 2, 80),
                # head dim 128's: one row, one and two whole 128-row blocks
                # (the second half-filled), a key past them, a GQA group of
                # four over nine 128-key tiles
                (2, 1, 4, 1, 128), (1, 64, 4, 1, 128), (1, 128, 4, 1, 128),
                (1, 129, 4, 1, 128), (2, 700, 8, 2, 128),
                # head dim 224's (zamba2-7b's shared attention): one row, a
                # 128-row block whose second warpgroup holds no row, a key
                # past two tiles, a GQA group of two, and the cell's ragged
                # shortest and largest prefills
                (2, 1, 2, 1, 224), (1, 64, 2, 2, 224), (1, 129, 2, 2, 224),
                (2, 333, 8, 2, 224), (4, 949, 32, 32, 224),
                (4, 4096, 32, 32, 224)]
SSD_SHAPES = [(2, 128, 4, 1, 32, 64, 32), (1, 256, 8, 2, 64, 128, 64),
              (2, 64, 2, 1, 16, 32, 64), (1, 96, 3, 1, 32, 16, 32),
              (4, 512, 24, 1, 64, 128, 256), (4, 300, 24, 1, 64, 128, 300),
              (4, 512, 80, 1, 64, 64, 256), (4, 300, 80, 1, 64, 64, 300),
              (4, 511, 24, 1, 64, 128, 1), (4, 511, 80, 1, 64, 64, 1)]
# zamba2-2.7b's serving shapes: 32 heads of 80 (GQA 1:1) in its shared
# attention; 80 SSD heads of 64 with d_state 64 and one group; llava's
# prefill, 576 patches + 512 tokens over 32 heads of 128 (GQA 32:8);
# zamba2-7b's at the largest call of its benchmark cell (zamba2-7b.prefill,
# 4 prompts of 4096 positions): 32 heads of 224 (MHA), 112 SSD heads of 64
# in two groups of d_state 64
FLASH_ZAMBA2 = (SERVE_B, SERVE_S, 32, 32, 80)
FLASH_LLAVA = (SERVE_B, 576 + SERVE_S, 32, 8, 128)
SSD_ZAMBA2 = (SERVE_B, SERVE_S, 80, 1, 64, 64, 256)
FLASH_ZAMBA2_7B = (4, 4096, 32, 32, 224)
SSD_ZAMBA2_7B = (4, 4096, 112, 2, 64, 64, 256)
# tests/test_kernels.py's shapes, qwen2's width (the timed case, 2048 rows
# of 896), a tail that is not a whole vector and rows that start unaligned
# (999), the longest row the kernel takes (65536, the strided path), then
# llava's norms (d 4096) at a longdoc prompt of 8192 positions and of 32768
RMS_TIMED = ((2048, 896), torch.bfloat16)
RMS_SHAPES = [((4, 64, 256), torch.float32), ((4, 64, 256), torch.bfloat16),
              ((128, 512), torch.float32), ((128, 512), torch.bfloat16),
              ((3, 5, 7, 64), torch.float32), ((3, 5, 7, 64), torch.bfloat16),
              RMS_TIMED, ((2048, 896), torch.float32),
              ((5, 999), torch.bfloat16), ((2, 65536), torch.float32),
              ((8192, 4096), torch.bfloat16), ((32768, 4096), torch.bfloat16)]
# the grouped norm: zamba2-7b's gate norm (a 949-position call of four rows,
# d_inner 7168 in two groups), a float32 one, and three groups of 16
RMS_GROUPED = [((4, 949, 7168), 2, torch.bfloat16),
               ((3, 5, 7168), 2, torch.float32), ((6, 48), 3, torch.float32)]
# the model path's norm at llava's width, timed with its bf16 weight: chat's
# shortest prompt (576 patches + 792 tokens) and two longdoc prompts
RMS_LLAVA_ROWS = (1368, 8192, 32768)
# causal_conv_silu (Mamba2's convolution, K = 4): zamba2-7b's x (7168) and
# B / C (128) channels, zamba2-2.7b's d_inner (5120), mamba2-130m's (1536),
# at one to three positions (under K), a strip edge (64) either side, the
# cell's shortest prompt (949) and its longest; timed at the cell's largest
# call, x and B / C
CONV_SHAPES = [(B, S, C) for C in (7168, 5120, 1536, 128)
               for B, S in ((1, 1), (4, 3), (1, 63), (4, 65), (4, 949),
                            (1, 4095), (4, 4096))]
CONV_TIMED = ((4, 4096, 7168), (4, 4096, 128))
# against the float32 composite of the same inputs: float32 at 1e-5, bf16
# within one output rounding (half a bf16 ulp is at most 2^-8 of the value)
CONV_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-6)}
# the reference's tolerances (tests/test_kernels.py)
MODEL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
SSD_TOL = 1e-4
# bf16 ssd_scan cases beside the timed serving shape (SSD_TIMED): mamba2's
# ragged prompt as one chunk of 300, chunks of 64 at S = 512 (eight hi / lo
# rounded states passed on), two B / C groups, and p, n that are not
# multiples of 16 (p = 20 is not even a multiple of 8: the wrapper pads it);
# then the NT = 64 tiles (n <= 64 with an even count of heads a group) past
# two chunks, where the pass kernel runs: chunks of 64, two groups, n = 48,
# and 511 chunks of one
SSD_TIMED = (SERVE_B, SERVE_S, 24, 1, 64, 128, 256)
SSD_BF16_SHAPES = [SSD_TIMED, (SERVE_B, RAGGED_S, 24, 1, 64, 128, RAGGED_S),
                   (2, 512, 8, 1, 64, 128, 64), (1, 256, 8, 2, 64, 128, 64),
                   (1, 192, 3, 1, 20, 36, 64), (2, 96, 4, 2, 40, 24, 32),
                   SSD_ZAMBA2, (SERVE_B, RAGGED_S, 80, 1, 64, 64, RAGGED_S),
                   (2, 512, 8, 1, 64, 64, 64), (1, 256, 8, 2, 64, 64, 64),
                   (1, 200, 4, 1, 32, 48, 64), (4, 511, 80, 1, 64, 64, 1),
                   SSD_ZAMBA2_7B, (4, 949, 112, 2, 64, 64, 949)]
# the bf16 bar against the sequential recurrence (the reference's), and the
# tolerance against ssd_scan_chunked_ref(bf16_points=True), which rounds
# where the kernel rounds: they differ by float32 summation order, ex2.approx
# and the final bf16 rounding of y, one bf16 ulp (<= 2^-8 relative)
SSD_BF16_TOL = 2e-2
SSD_POINTS_TOL = 1e-2


def normal(rng, shape, dtype=torch.float32):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32)) \
        .to(DEV).to(dtype)


def flash_inputs(seed, B, S, H, KV, d, dtype):
    rng = np.random.default_rng(seed)
    return (normal(rng, (B, S, H, d), dtype), normal(rng, (B, S, KV, d), dtype),
            normal(rng, (B, S, KV, d), dtype))


def ssd_inputs(seed, b, s, h, g, p, n, dtype=torch.float32):
    rng = np.random.default_rng(seed)
    x = normal(rng, (b, s, h, p), dtype)
    dt = torch.from_numpy(rng.uniform(0.01, 0.2, (b, s, h)).astype(
        np.float32)).to(DEV).to(dtype)
    A = torch.from_numpy(-rng.uniform(0.5, 1.5, h).astype(np.float32)) \
        .to(DEV).to(dtype)
    return x, dt, A, normal(rng, (b, s, g, n), dtype), \
        normal(rng, (b, s, g, n), dtype)


def assert_close(name, got, want, rtol, atol):
    """|got - want| <= atol + rtol * |want| everywhere, all finite; returns
    the max abs error."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if not bool(torch.isfinite(got).all()) \
            or not bool((diff <= atol + rtol * want.abs()).all()):
        raise AssertionError(f"{name}: outside rtol={rtol}, atol={atol} of "
                             f"the plain version (max abs "
                             f"{float(diff.max()):.3e})")
    return float(diff.max())


def bar_share(got, want, rtol, atol) -> float:
    """The largest |got - want| / (atol + rtol |want|): how much of its
    tolerance a check used (1.0 at the edge)."""
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


def flash_bound(B, S, H, KV, d, elem):
    bytes_ = B * S * (2 * H + 2 * KV) * d * elem        # q, k, v in; o out
    flops = 4 * B * H * d * (S * (S + 1) // 2)          # causal q.k and p.v
    return bytes_, flops, BF16_TC_FLOPS if elem == 2 else F32_FLOPS


def ssd_bound(b, s, h, g, p, n, chunk, elem):
    # x, y, dt, A, B, C and the final state, all in the inputs' dtype
    bytes_ = (2 * b * s * h * p + b * s * h + h + 2 * b * s * g * n
              + b * h * p * n) * elem
    flops = 0
    for c0 in range(0, s, chunk):
        l = min(chunk, s - c0)
        tri = l * (l + 1) // 2
        # (C B^T) on and below the diagonal, its product with x, the carried
        # state's contribution and the state update
        flops += 2 * tri * (n + p) + 2 * l * n * p * 2
    return bytes_, flops * b * h, BF16_TC_FLOPS if elem == 2 else F32_FLOPS


def rms_bound(rows, d, elem, w_elem=4):
    return rows * d * 2 * elem + d * w_elem, 4 * rows * d, F32_FLOPS


def conv_bound(B, S, C, K, elem, w_elem):
    # x in, y out, the weights and bias once; K multiply-adds, the bias and
    # the SiLU's exp, add and divide an element
    bytes_ = 2 * B * S * C * elem + (K + 1) * C * w_elem
    return bytes_, (2 * K + 4) * B * S * C, F32_FLOPS


def bound_of(bytes_, flops, peak):
    t_bytes, t_ops = bytes_ / HBM_BYTES_PER_S, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": bytes_, "flops": flops, "peak_flops": peak}


def flash_record(shape, errs, plain_iters: int = 20):
    """flash_attention at one causal shape: bf16 (tensor cores) and float32
    (CUDA cores) times beside the plain version and sdpa, the bf16 kernel's
    device time by torch.profiler, the bf16 bound, and the largest errors
    the shape loop found at that shape."""
    q, k, v = flash_inputs(0, *shape, torch.bfloat16)
    q32, k32, v32 = flash_inputs(0, *shape, torch.float32)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    err = errs[shape]
    # one device kernel a call: flash_tc_kernel<d>, flash_tc80_kernel or
    # flash_tc128_kernel
    prof, _, dropped = profiled(lambda: ops.flash_attention(q, k, v),
                                ("flash_tc",))
    return {
        "shape": list(shape), "dtype": "bfloat16",
        "max_abs_err": max(err.values()),
        "max_abs_err_f32": err[torch.float32],
        "max_abs_err_bf16": err[torch.bfloat16],
        "profiler_device_us": prof["flash_tc"],
        "trace_dropped_device_records": dropped,
        "ms": median_ms(lambda: ops.flash_attention(q, k, v)),
        "ms_f32": median_ms(lambda: ops.flash_attention(q32, k32, v32)),
        "plain_ms": median_ms(lambda: ref.attention_ref(
            q.float(), k.float(), v.float()).to(q.dtype), iters=plain_iters),
        "library_ms": median_ms(
            lambda: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True)),
        **bound_of(*flash_bound(*shape, 2))}


def ssd_kernel_names(S: int, chunk: int):
    """The bf16 route's device kernels at ``S`` and ``chunk`` (which
    ``ops.ssd_scan`` halves until it divides ``S``): the pass kernel only
    past ``FOLD_CHUNKS`` chunks."""
    while S % chunk:
        chunk //= 2
    return tuple(k for k in SERVE_KERNEL_NAMES["ssd_scan"]
                 if k != "ssd_pass_kernel" or S // chunk > FOLD_CHUNKS)


def ssd_record(shape, errs):
    """ssd_scan at one shape: its CUDA launches a call and device time by
    kernel (bf16), bf16 and float32 times beside the plain version, the
    bf16 bound, and the largest errors the shape loops found at that
    shape."""
    args = ssd_inputs(0, *shape[:6], torch.bfloat16)
    args32 = ssd_inputs(0, *shape[:6])
    prof, launches, dropped = profiled(
        lambda: ops.ssd_scan(*args, chunk=shape[6]),
        ssd_kernel_names(shape[1], shape[6]))
    err = errs[shape]
    return {
        "shape": list(shape), "dtype": "bfloat16",
        "max_abs_err": max(err["f32"], err["bf16"]),
        "max_abs_err_f32": err["f32"], "max_abs_err_bf16": err["bf16"],
        "max_abs_err_bf16_vs_chunked_points": err["points"],
        "bf16_y_share_of_bar": err["share"],
        "cuda_launches_per_call": sum(launches.values()),
        "trace_dropped_device_records": dropped,
        "profiler_device_us": prof,
        "ms": median_ms(lambda: ops.ssd_scan(*args, chunk=shape[6])),
        "ms_f32": median_ms(lambda: ops.ssd_scan(*args32, chunk=shape[6])),
        "plain_ms": median_ms(lambda: ref.ssd_scan_sequential_ref(*args),
                              iters=3, warmup=1, repeats=3),
        "library_ms": None,
        **bound_of(*ssd_bound(*shape, 2))}


def phase_model_kernels():
    recs = {}

    # flash_attention: f32 at rtol=atol=1e-5, bf16 at rtol=atol=2e-2
    errs, n = {}, 0                      # {shape: {dtype: max abs err}}
    for shape in FLASH_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for causal in (True, False):
                q, k, v = flash_inputs(n, *shape, dtype)
                got = ops.flash_attention(q, k, v, causal=causal)
                want = ref.attention_ref(q.float(), k.float(), v.float(),
                                         causal=causal)
                torch.cuda.synchronize()
                tol = MODEL_TOL[dtype]
                at = errs.setdefault(shape, {}).setdefault(dtype, 0.0)
                errs[shape][dtype] = max(at, assert_close(
                    f"flash_attention{shape} {dtype} causal={causal}", got,
                    want, tol, tol))
                n += 1
    worst = {dtype: max(e[dtype] for e in errs.values())
             for dtype in (torch.float32, torch.bfloat16)}
    recs["flash_attention"] = {
        **flash_record((SERVE_B, SERVE_S, 14, 2, 64), errs), "cases": n,
        "max_abs_err": max(worst.values()),
        "max_abs_err_f32": worst[torch.float32],
        "max_abs_err_bf16": worst[torch.bfloat16],
        "tolerance": "f32 rtol=atol=1e-5, bf16 rtol=atol=2e-2, vs "
                     "attention_ref on the same (widened) inputs",
        "design": "bf16: wgmma (tensor cores) fed by TMA; float32 (ms_f32, "
                  "f32 inputs): FMAs on the CUDA cores",
        "library": "F.scaled_dot_product_attention(is_causal=True, "
                   "enable_gqa=True) on [B,H,S,d] views",
        "zamba2": flash_record(FLASH_ZAMBA2, errs),
        # the plain version holds 0.6 GB of float32 scores a call, 8.6 GB
        # at zamba2-7b's
        "llava": flash_record(FLASH_LLAVA, errs, plain_iters=5),
        "zamba2_7b": flash_record(FLASH_ZAMBA2_7B, errs, plain_iters=3)}

    # ssd_scan: float32 (the CUDA-core kernel) at 1e-4 against the sequential
    # recurrence; bf16 (the tensor-core kernels) at 2e-2 against it and at
    # 1e-2 against the chunked form with the kernel's rounding points
    errs = {shape: dict.fromkeys(("f32", "bf16", "points", "share"), 0.0)
            for shape in SSD_SHAPES + SSD_BF16_SHAPES}
    n = 0
    for shape in SSD_SHAPES:
        x, dt, A, B, C = ssd_inputs(n, *shape[:6])
        y, st = ops.ssd_scan(x, dt, A, B, C, chunk=shape[6])
        y_r, st_r = ref.ssd_scan_sequential_ref(x, dt, A, B, C)
        torch.cuda.synchronize()
        errs[shape]["f32"] = max(
            assert_close(f"ssd_scan{shape} y", y, y_r, SSD_TOL, SSD_TOL),
            assert_close(f"ssd_scan{shape} state", st, st_r, SSD_TOL,
                         SSD_TOL))
        n += 1
    shares = []
    for shape in SSD_BF16_SHAPES:
        args = ssd_inputs(n, *shape[:6], torch.bfloat16)
        y, st = ops.ssd_scan(*args, chunk=shape[6])
        y_r, st_r = ref.ssd_scan_sequential_ref(*args)
        y_p, st_p = ref.ssd_scan_chunked_ref(*args, chunk=shape[6],
                                             bf16_points=True)
        # the cheaper design, one bf16 rounding at each point: measured, not
        # run on the card
        y_1, _ = ref.ssd_scan_chunked_ref(*args, chunk=shape[6],
                                          bf16_points=True, bf16_pairs=False)
        torch.cuda.synchronize()
        at = errs[shape]
        at["share"] = bar_share(y, y_r, SSD_BF16_TOL, SSD_BF16_TOL)
        shares.append({"shape": list(shape), "kernel": at["share"],
                       "single_rounding_emulation": bar_share(
                           y_1, y_r, SSD_BF16_TOL, SSD_BF16_TOL),
                       "points": bar_share(y, y_p, SSD_POINTS_TOL,
                                           SSD_POINTS_TOL)})
        at["bf16"] = max(
            assert_close(f"ssd_scan{shape} bf16 y", y, y_r, SSD_BF16_TOL,
                         SSD_BF16_TOL),
            assert_close(f"ssd_scan{shape} bf16 state", st, st_r,
                         SSD_BF16_TOL, SSD_BF16_TOL))
        at["points"] = max(
            assert_close(f"ssd_scan{shape} bf16 y vs chunked_ref"
                         "(bf16_points)", y, y_p, SSD_POINTS_TOL,
                         SSD_POINTS_TOL),
            assert_close(f"ssd_scan{shape} bf16 state vs chunked_ref"
                         "(bf16_points)", st, st_p, SSD_POINTS_TOL,
                         SSD_POINTS_TOL))
        n += 1
    worst = {key: max(e[key] for e in errs.values())
             for key in ("f32", "bf16", "points", "share")}
    recs["ssd_scan"] = {
        **ssd_record(SSD_TIMED, errs), "cases": n,
        "max_abs_err": max(worst["f32"], worst["bf16"]),
        "max_abs_err_f32": worst["f32"], "max_abs_err_bf16": worst["bf16"],
        "max_abs_err_bf16_vs_chunked_points": worst["points"],
        "bf16_y_share_of_bar": worst["share"],
        "bf16_y_share_of_points_tolerance": max(
            sh["points"] for sh in shares),
        "bf16_y_share_of_bar_by_shape": shares,
        "tolerance": "f32 rtol=atol=1e-4 vs ssd_scan_sequential_ref (y and "
                     "final state), bf16 rtol=atol=2e-2 vs it and 1e-2 vs "
                     "ssd_scan_chunked_ref(bf16_points=True)",
        "design": "bf16: two launches (a third, the state pass, past two "
                  "chunks), wgmma (tensor cores) fed by TMA, chunks in "
                  "parallel; float32 (ms_f32, f32 inputs): FMAs on "
                  "the CUDA cores, one block per (b, h)",
        "library": None,
        "zamba2": ssd_record(SSD_ZAMBA2, errs),
        "zamba2_7b": ssd_record(SSD_ZAMBA2_7B, errs)}

    # rmsnorm: f32 at 1e-5, bf16 at 2e-2, float32 weight; a bf16 weight
    # read as it is stored gives the bits of its float32 widening
    errs, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    for shape, dtype in RMS_SHAPES:
        rng = np.random.default_rng(n)
        x, w = normal(rng, shape, dtype), normal(rng, shape[-1:])
        got = ops.rmsnorm(x, w)
        want = ref.rmsnorm_ref(x, w)
        torch.cuda.synchronize()
        tol = MODEL_TOL[dtype]
        errs[dtype] = max(errs[dtype], assert_close(
            f"rmsnorm{shape} {dtype}", got, want, tol, tol))
        w_bf = w.to(torch.bfloat16)
        if not torch.equal(ops.rmsnorm(x, w_bf), ops.rmsnorm(x, w_bf.float())):
            raise AssertionError(f"rmsnorm{shape} {dtype}: the bf16 weight's "
                                 "read differs from its float32 widening")
        n += 1
    # grouped (Mamba2's gate norm at zamba2-7b's: two groups of 3584 over
    # d_inner 7168), each group against its own plain norm
    for shape, groups, dtype in RMS_GROUPED:
        rng = np.random.default_rng(n)
        x, w = normal(rng, shape, dtype), normal(rng, shape[-1:])
        got = ops.rmsnorm(x, w, groups=groups)
        G = shape[-1] // groups
        want = ref.rmsnorm_ref(x.reshape(*shape[:-1], groups, G),
                               w.reshape(groups, G)).reshape(shape)
        torch.cuda.synchronize()
        tol = MODEL_TOL[dtype]
        errs[dtype] = max(errs[dtype], assert_close(
            f"rmsnorm{shape} groups={groups} {dtype}", got, want, tol, tol))
        n += 1
    rng = np.random.default_rng(0)
    (rows, d), dtype = RMS_TIMED
    x, w = normal(rng, (rows, d), dtype), normal(rng, (d,))
    w_x = w.to(x.dtype)
    recs["rmsnorm"] = {
        "shape": [rows, d], "dtype": "bfloat16", "cases": n,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16],
        "tolerance": "f32 rtol=atol=1e-5, bf16 rtol=atol=2e-2 vs rmsnorm_ref",
        "ms": median_ms(lambda: ops.rmsnorm(x, w)),
        "plain_ms": median_ms(lambda: ref.rmsnorm_ref(x, w), iters=20),
        "library": "F.rms_norm with the weight cast to bf16 beforehand",
        "library_ms": median_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w_x, 1e-5)),
        **bound_of(*rms_bound(rows, d, 2)),
        "llava": [rms_llava_record(rows) for rows in RMS_LLAVA_ROWS]}

    # causal_conv_silu against the float32 composite of the same inputs
    errs, n = {torch.float32: 0.0, torch.bfloat16: 0.0}, 0
    for shape in CONV_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, w, b = conv_inputs(n, *shape, dtype)
            got = ops.causal_conv_silu(x, w, b)
            want = ref.causal_conv_silu_ref(x.float(), w.float(), b.float())
            torch.cuda.synchronize()
            errs[dtype] = max(errs[dtype], assert_close(
                f"causal_conv_silu{shape} {dtype}", got, want,
                *CONV_TOL[dtype]))
            n += 1
    recs["causal_conv_silu"] = {
        **conv_record(CONV_TIMED[0]), "cases": n,
        "max_abs_err": max(errs.values()),
        "max_abs_err_f32": errs[torch.float32],
        "max_abs_err_bf16": errs[torch.bfloat16],
        "tolerance": "vs causal_conv_silu_ref of the inputs widened to "
                     "float32: f32 rtol=atol=1e-5, bf16 rtol=2^-8 atol=1e-6 "
                     "(one output rounding)",
        "library": None,
        "bc": conv_record(CONV_TIMED[1])}
    emit("model_kernels", **recs,
         timing="CUDA events, 5 warm-up + 50 calls (plain: 20, ssd "
                "plain: 3), median of 5 repeats, inputs L2-warm")
    return recs


def conv_inputs(seed, B, S, C, dtype):
    """x [B,S,C], w [4,C] and a nonzero bias, as the models hold them."""
    rng = np.random.default_rng(seed)
    return (normal(rng, (B, S, C), dtype),
            (0.5 * normal(rng, (4, C))).to(dtype),
            (0.1 * normal(rng, (C,))).to(dtype))


def conv_record(shape):
    """causal_conv_silu at one bf16 shape: its time by events and on the
    device, beside its bytes bound and the eager composite the models ran
    before (``F.silu(ref.causal_conv_ref(...))``, 15 passes a call)."""
    x, w, b = conv_inputs(0, *shape, torch.bfloat16)
    ms = median_ms(lambda: ops.causal_conv_silu(x, w, b))
    device_us, _, _ = profiled(lambda: ops.causal_conv_silu(x, w, b),
                               ("causal_conv_silu",))
    rec = {"shape": list(shape), "dtype": "bfloat16", "ms": ms,
           "profiler_device_us": device_us["causal_conv_silu"],
           "plain_ms": median_ms(lambda: torch.nn.functional.silu(
               ref.causal_conv_ref(x, w, b)), iters=20),
           "library_ms": None,
           **bound_of(*conv_bound(*shape, 4, 2, 2))}
    rec["bound_share"] = rec["bound_ms"] / ms
    rec["device_bound_share"] = (rec["bound_ms"] * 1e3
                                 / device_us["causal_conv_silu"])
    return rec


def rms_llava_record(rows, d=4096):
    """The kernel as llava's norms launch it: ``[rows, 4096]`` bf16 with
    the bf16 weight, beside the bytes it must move and the eager composite
    the models ran before (``ref.rmsnorm_ref``); the host µs of one norm on
    the model path (``common.rms_norm``, the kernel) and of the composite."""
    rng = np.random.default_rng(rows)
    x = normal(rng, (rows, d), torch.bfloat16)
    w = normal(rng, (d,), torch.bfloat16)
    ms = median_ms(lambda: ops.rmsnorm(x, w))
    device_us, _, _ = profiled(lambda: ops.rmsnorm(x, w), ("rmsnorm",))
    rec = {"shape": [rows, d], "dtype": "bfloat16", "weight": "bfloat16",
           "ms": ms, "profiler_device_us": device_us["rmsnorm"],
           "plain_ms": median_ms(lambda: ref.rmsnorm_ref(x, w), iters=20),
           "library_ms": median_ms(lambda: torch.nn.functional.rms_norm(
               x, (d,), w, 1e-5)),
           "model_path_host_us": host_us(
               lambda: rms_norm(x, w, impl="flash"))[0],
           "composite_host_us": host_us(lambda: ref.rmsnorm_ref(x, w))[0],
           **bound_of(*rms_bound(rows, d, 2, 2))}
    rec["bound_share"] = rec["bound_ms"] / ms
    rec["device_bound_share"] = rec["bound_ms"] * 1e3 / device_us["rmsnorm"]
    return rec


# --------------------------------------------------------------------------- #
# phase 4: the main path
# --------------------------------------------------------------------------- #
def fingerprint(res):
    summary = {k: None if isinstance(v, float) and math.isnan(v) else v
               for k, v in res.summary().items()}
    return (summary, res.n_events, res.infeasible_events,
            sorted(res.dropped), res.truncated,
            [(r.rid, r.target_sid) for r in res.requests],
            [(t, a.sid, a.src, a.dst, a.forced) for t, a in res.migrations])


def hold_engines(dev_res, host_res, what: str) -> bool:
    """The cuda run against the numpy run of the same block: discrete
    outcomes equal, finish times within 1e-9; returns whether the finish
    times are bitwise equal too."""
    if dev_res[0].engine != "cuda" or host_res[0].engine != "numpy":
        raise AssertionError(f"{what}: run_batch did not use the engines "
                             "asked for")
    bitwise = True
    for b, (d, h) in enumerate(zip(dev_res, host_res)):
        if fingerprint(d) != fingerprint(h):
            raise AssertionError(f"{what} replica {b}: discrete outcomes "
                                 "differ between the cuda and numpy engines")
        fd = np.array([r.finish for r in d.requests])
        fh = np.array([r.finish for r in h.requests])
        if not np.allclose(fd, fh, rtol=0, atol=1e-9):
            raise AssertionError(
                f"{what} replica {b}: finish times differ by "
                f"{np.abs(fd - fh).max():.3e} > 1e-9")
        bitwise = bitwise and bits_equal(fd, fh)
        if d.truncated or not all(math.isfinite(x) for x in fd):
            raise AssertionError(f"{what} replica {b}: truncated or "
                                 "non-finite")
    return bitwise


def check_ticks(res, launches: int, what: str) -> int:
    """Every tick is one launch: B replicas move one event each per tick,
    and the last tick may find every replica drained."""
    ticks = max(r.n_events for r in res)
    if not ticks <= launches <= ticks + 1:
        raise AssertionError(f"{what}: event_step launches ({launches}) do "
                             f"not match the run's ticks ({ticks})")
    return ticks


def profile_split(phases, keys) -> dict:
    return {k: {"total_s": phases[k]["total_s"], "count": phases[k]["count"],
                "mean_us": phases[k]["mean_us"]}
            for k in keys if k in phases}


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

    events = sum(r.n_events for r in dev_res)
    check_ticks(dev_res, launches, "run_batch")
    bitwise = hold_engines(dev_res, host_res, "run_batch")
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
    split = profile_split(phases, ("core.h2d", "core.kernel", "core.d2h",
                                   "engine.step", "engine.events",
                                   "allocator.solve", "run"))
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
# phase 4b: the paper's method on the main path — the epoch step of HAF
# --------------------------------------------------------------------------- #
def samples_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.dtype == y.dtype and bits_equal(x, y)
        for sa, sb in zip(a, b) for x, y in zip(sa, sb))


def masked_l2(pred: np.ndarray, r: np.ndarray, m: np.ndarray) -> float:
    """Eq. 10 on a fixed set: the training loss's own masked L2."""
    return float(np.sum((pred - r) ** 2 * m) / max(float(np.sum(m)), 1.0))


def phase_haf(args):
    """Harvest → train on the card → HAF critic-gated on the cuda engine
    against the numpy engine → spot churn.  The five baselines run in
    phase eval, through the method registry, on the same scenario."""
    phase_t0 = time.perf_counter()
    sc = make_scenario("paper", seed=0)
    cut = {"bulk_requests": args.harvest_bulk,
           "probe_requests": args.harvest_probe}

    # 1. the critic's training data, harvested through run_batch blocks of
    # random and scripted migrations on both engines
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    samples = datagen.harvest(sc, engine="cuda", **cut)
    torch.cuda.synchronize()
    harvest_cuda_s = time.perf_counter() - t0
    harvest_launches = ops.launch_counts()["event_step"]
    t0 = time.perf_counter()
    host_samples = datagen.harvest(sc, engine="numpy", **cut)
    harvest_numpy_s = time.perf_counter() - t0
    if not samples_equal(samples, host_samples):
        raise AssertionError("harvest: the cuda engine's samples are not "
                             "bitwise the numpy engine's")
    if harvest_launches == 0:
        raise AssertionError("harvest: the cuda engine launched no kernel")

    # 2. the critic, trained on the card on a fixed 80 / 20 split
    n = len(samples)
    order = np.random.default_rng(0).permutation(n)
    n_train = int(0.8 * n)
    train = [samples[i] for i in order[:n_train]]
    held = critic_mod.stack_samples([samples[i] for i in order[n_train:]])
    fit = critic_mod.stack_samples(train)
    hyper = {"hidden": 64, "batch": 256, "epochs": args.critic_epochs,
             "seed": 0, "lr": 1e-3}
    t0 = time.perf_counter()
    critic = critic_mod.train_critic(train, device="cuda", **hyper)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    steps = args.critic_epochs * -(-n_train // hyper["batch"])
    untrained = critic_mod.Critic(critic_mod.init_params(0, hyper["hidden"]))
    with torch.no_grad():
        net = critic_mod.CriticNet.from_params(critic.params, device=DEV)
        pred_dev = net(torch.from_numpy(held[0]).to(DEV))
    pred_dev = pred_dev.double().cpu().numpy()
    pred_np = critic_mod.forward_np(critic.params_np, held[0])
    fwd_err = float(np.abs(pred_dev - pred_np).max())
    if fwd_err > 1e-5:
        raise AssertionError(f"critic: the torch forward is {fwd_err:.3e} "
                             "from forward_np (> 1e-5)")
    loss = {
        "train": masked_l2(critic_mod.forward_np(critic.params_np, fit[0]),
                           fit[1], fit[2]),
        "held_out": masked_l2(pred_np, held[1], held[2]),
        "held_out_untrained": masked_l2(
            critic_mod.forward_np(untrained.params_np, held[0]),
            held[1], held[2])}
    if not loss["held_out"] < loss["held_out_untrained"]:
        raise AssertionError(f"critic: held-out loss did not fall: {loss}")
    out_dir = os.path.join(HERE, "build", "haf")       # git-ignored
    path = os.path.join(out_dir, "critic.json")
    save_critic(critic, path, families=("paper",),
                data_hash=datagen.samples_fingerprint(samples),
                meta={**hyper, "n_samples": n_train, "device": "cuda"})
    loaded = critic_mod.load_critic_cached(
        path, expect_fingerprint=read_manifest(path)["fingerprint"])
    resaved = os.path.join(out_dir, "critic_resaved.json")
    loaded.save(resaved)
    with open(path, "rb") as a, open(resaved, "rb") as b:
        same_bytes = a.read() == b.read()
    if loaded.fingerprint() != critic.fingerprint() or not same_bytes:
        raise AssertionError("critic: save -> load did not keep the "
                             "fingerprint and the file's bytes")

    # 3. HAF (qwen3-32b-sim stand-in + that critic) on B seeds of the paper
    # scenario at rho 1.0, on the cuda engine against the numpy engine
    B = args.batch
    workloads = [workload_for(sc, seed=s, n_ai_requests=args.haf_requests,
                              rho=1.0)[0] for s in range(B)]
    sim = Simulator(sc)                      # engine=None, device="cuda"

    def haf(**kw):
        return sim.run_batch(
            workloads, lambda b: HAFPlacement(make_agent("qwen3-32b-sim"),
                                              critic=critic),
            lambda b: DeadlineAwareAllocation(), **kw)

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dev_res = haf()
    torch.cuda.synchronize()
    dev_wall = time.perf_counter() - t0
    launches = ops.launch_counts()["event_step"]
    t0 = time.perf_counter()
    host_res = haf(engine="numpy")
    host_wall = time.perf_counter() - t0
    ticks = check_ticks(dev_res, launches, "haf")
    bitwise = hold_engines(dev_res, host_res, "haf")
    migrations = [len(r.migrations) for r in dev_res]
    if sum(migrations) < 1:
        raise AssertionError("haf: no replica migrated anything")
    overall = [r.summary()["overall"] for r in dev_res]
    if not all(0.0 < x <= 1.0 for x in overall):
        raise AssertionError(f"haf: fulfillment out of range: {overall}")
    events = sum(r.n_events for r in dev_res)
    before = ops.launch_counts()["event_step"]
    prof_res = haf(obs=obs.ObsConfig(profile=True))
    if ops.launch_counts()["event_step"] - before != launches \
            or [fingerprint(r) for r in prof_res] != \
            [fingerprint(r) for r in dev_res]:
        raise AssertionError("haf: the profiled run changed the outcome")
    phases = prof_res[0].profile["phases"]
    split = profile_split(phases, (
        "epoch.decide", "engine.step", "engine.events", "allocator.solve",
        "core.h2d", "core.kernel", "core.d2h", "run"))

    # 4. spot churn: preemptions force migrations the critic-gated HAF must
    # make on both engines alike
    churn_sc = make_scenario("spot-churn", seed=0,
                             n_ai_requests=args.haf_requests)
    churn_wl = [workload_for(churn_sc, seed=s,
                             n_ai_requests=args.haf_requests)[0]
                for s in range(CHURN_B)]
    churn_sim = Simulator(churn_sc)

    def churn(**kw):
        return churn_sim.run_batch(
            churn_wl, lambda b: HAFPlacement(make_agent("qwen3-32b-sim"),
                                             critic=critic),
            lambda b: DeadlineAwareAllocation(), **kw)

    ops.reset_launch_counts()
    churn_dev = churn()
    churn_launches = ops.launch_counts()["event_step"]
    churn_host = churn(engine="numpy")
    check_ticks(churn_dev, churn_launches, "spot-churn")
    churn_bitwise = hold_engines(churn_dev, churn_host, "spot-churn")

    emit("haf", wall_s=time.perf_counter() - phase_t0, family="paper",
         S=len(sc["instances"]), B=B,
         n_ai_requests=args.haf_requests, rho=1.0,
         cut={"n_ai_requests": (
                  f"{HAF_FULL_REQUESTS} (experiments/paper_table3.toml) -> "
                  f"{args.haf_requests} (run time); S, B and the scenario "
                  "full" if args.haf_requests < HAF_FULL_REQUESTS else None),
              "harvest": (f"bulk_requests 2500 -> {args.harvest_bulk}, "
                          f"probe_requests 1500 -> {args.harvest_probe}"),
              "critic_epochs": (f"2000 -> {args.critic_epochs}"
                                if args.critic_epochs < 2000 else None)},
         harvest={"samples": n, "cuda_s": harvest_cuda_s,
                  "numpy_s": harvest_numpy_s,
                  "event_step_launches": harvest_launches,
                  "samples_bitwise_equal": True,
                  "fingerprint": datagen.samples_fingerprint(samples)},
         critic={**hyper, "n_train": n_train, "n_held_out": n - n_train,
                 "steps": steps, "wall_s": train_s,
                 "steps_per_s": steps / train_s, "loss": loss,
                 "torch_vs_forward_np_max_abs": fwd_err,
                 "fingerprint": critic.fingerprint(),
                 "save_load_bytes_equal": same_bytes},
         method="haf(qwen3-32b-sim + critic)", ticks=ticks,
         launches=launches, events=events,
         cuda={"wall_s": dev_wall, "events_per_s": events / dev_wall},
         numpy={"wall_s": host_wall, "events_per_s": events / host_wall},
         fingerprints_equal=True, finish_atol=1e-9,
         finish_bitwise_equal=bitwise,
         mean_overall_fulfillment=float(np.mean(overall)),
         migrations_per_replica=float(np.mean(migrations)),
         profiled_split=split,
         epoch_decide_share=(phases["epoch.decide"]["total_s"]
                             / phases["run"]["total_s"]),
         spot_churn={"B": CHURN_B, "launches": churn_launches,
                     "fingerprints_equal": True,
                     "finish_bitwise_equal": churn_bitwise,
                     "mig_forced": sum(r.summary()["mig_forced"]
                                       for r in churn_dev),
                     "migrations": sum(len(r.migrations)
                                       for r in churn_dev),
                     "mean_overall_fulfillment": float(np.mean(
                         [r.summary()["overall"] for r in churn_dev]))})
    return launches, critic


# --------------------------------------------------------------------------- #
# phase 4b': the port's examples, each main() in-process on the card
# --------------------------------------------------------------------------- #
EXAMPLES = os.path.join(HERE, "examples", "torch")
EXAMPLE_REQUESTS = 300       # haf_serving's stream (3000 in the script)
EXAMPLE_TRAIN = ["--steps", "6", "--fail-at", "3"]   # 300 steps in the script


def load_example(name: str) -> types.ModuleType:
    path = os.path.join(EXAMPLES, f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def same_summary(a: dict, b: dict) -> bool:
    """Equal summaries; an absent class's NaN equals NaN."""
    nan = lambda v: isinstance(v, float) and math.isnan(v)
    return a.keys() == b.keys() and all(
        a[k] == b[k] or (nan(a[k]) and nan(b[k])) for k in a)


def quiet_main(mod, argv):
    """``mod.main(argv)`` with its prints kept out of this script's output,
    and the card's seconds for it."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        out = mod.main(argv)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def phase_examples(critic):
    """examples/torch on the card: quickstart whole (its allocation against
    the same call on the host), haf_serving with phase haf's critic (static
    and HAF summaries against the numpy engine, P1; its event_step launches
    counted) and train_100m at a few steps with an injected failure."""
    t_phase = time.perf_counter()
    qs_mod = load_example("quickstart")
    qs, qs_s = quiet_main(qs_mod, [])
    host = qs_mod.allocate("cpu")
    on_card = [qs["alloc"], qs["floored"], qs["loss"], qs["grad_norm"],
               qs["logits"]]
    if any(t.device.type != "cuda" for t in on_card):
        raise AssertionError("quickstart: a result is not on the card")
    alloc_err = float((qs["alloc"].cpu() - host.alloc).abs().max())
    torch.testing.assert_close(qs["alloc"].cpu(), host.alloc, rtol=1e-4,
                               atol=qs_mod.CAPACITY * 1e-5)
    if not (torch.equal(qs["floored"].cpu(), host.floored)
            and bool(qs["feasible"]) == bool(host.feasible)
            and bool(torch.isfinite(qs["loss"]))
            and bool(torch.isfinite(qs["logits"]).all())):
        raise AssertionError("quickstart: floors, feasibility or the model "
                             "step disagree")

    work = tempfile.mkdtemp(prefix="chip_smoke_examples_")
    try:
        path = os.path.join(work, "critic.json")
        critic.save(path)
        ops.reset_launch_counts()
        hs, hs_s = quiet_main(load_example("haf_serving"),
                              ["--requests", str(EXAMPLE_REQUESTS),
                               "--critic", path])
        launches = ops.launch_counts()["event_step"]
    finally:
        shutil.rmtree(work)
    sc = paper_scenario()
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=EXAMPLE_REQUESTS, seed=0),
        sc["work_models"])
    host_sim = Simulator(sc, epoch_interval=5.0, engine="numpy")
    static = host_sim.run(reqs, StaticPlacement(), DeadlineAwareAllocation())
    haf = host_sim.run(reqs, HAFPlacement(make_agent("qwen3-32b-sim"),
                                          critic=critic),
                       DeadlineAwareAllocation())
    if hs["critic_trained"] or hs["critic"] != critic.fingerprint():
        raise AssertionError("haf_serving did not read phase haf's critic")
    if not (same_summary(hs["static"], static.summary())
            and same_summary(hs["haf"], haf.summary())):
        raise AssertionError(f"haf_serving on cuda != numpy:\n{hs['static']}"
                             f"\n{static.summary()}\n{hs['haf']}\n"
                             f"{haf.summary()}")
    if hs["events"] != [static.n_events, haf.n_events] \
            or launches != sum(hs["events"]) + 2:
        raise AssertionError(f"haf_serving: {launches} event_step launches "
                             f"for ticks {hs['events']} (want a launch a "
                             "tick, and one, a run)")

    tr, tr_s = quiet_main(load_example("train_100m"), EXAMPLE_TRAIN)
    if tr["restarts"] != [3] or not all(math.isfinite(x)
                                        for x in tr["loss"]) \
            or any(p.device.type != "cuda" for p in tr["params"]):
        raise AssertionError(f"train_100m: restarts {tr['restarts']}, "
                             f"losses {tr['loss']}")
    emit("examples", seconds=time.perf_counter() - t_phase,
         quickstart={"seconds": qs_s, "alloc_max_abs_diff_vs_host":
                     alloc_err, "decision": qs["decision"],
                     "loss": float(qs["loss"])},
         haf_serving={"seconds": hs_s, "requests": EXAMPLE_REQUESTS,
                      "ticks": hs["events"], "event_step_launches": launches,
                      "static_overall": hs["static"]["overall"],
                      "haf_overall": hs["haf"]["overall"],
                      "migrations": len(hs["migrations"]),
                      "summaries_equal_numpy": True},
         train_100m={"seconds": tr_s, "argv": EXAMPLE_TRAIN,
                     "params_m": tr["params_m"], "restarts": tr["restarts"],
                     "loss_first": tr["loss"][0], "loss_last": tr["loss"][-1]},
         nvidia_smi=nvidia_smi_line())
    return launches


# --------------------------------------------------------------------------- #
# phase 4c: the experiment harness — the paper's spec files on the card
# --------------------------------------------------------------------------- #
TABLE3 = "experiments/paper_table3.toml"
EVAL_SEEDS, N_EVAL_SEEDS, EVAL_BATCH, EVAL_WORKERS = "0..7", 8, 8, 2
# n_ai_requests a replica of paper_table3 (its file says 5000), of the
# trace replay (a prefix of trace_sweep's 2000 rows) and of the serving
# launcher's run: cut for run time, each run's shapes left whole
EVAL_REQUESTS, TRACE_REQUESTS, SERVE_REQUESTS = 400, 250, 300
# row columns that say how and how fast a row ran, not what it computed
HOW = ("wall_s", "engine_wall_s", "events_per_sec", "engine", "batch", "b",
       "profile", "trace_counts", "trace_path")

# one spawn worker's start-up as the sweep pays it: import the sweep's
# modules (torch, the simulator, the policies), start CUDA and find the
# built kernels; run by ``python -c``, so no main file is re-imported
SPAWN_PROBE = """
import concurrent.futures as cf, multiprocessing as mp, time, torch
from repro_torch.eval import sweep
from repro_torch.kernels import _build
t0 = time.perf_counter()
with cf.ProcessPoolExecutor(1, mp_context=mp.get_context("spawn")) as pool:
    pool.submit(sweep.SweepSpec).result()
    pool.submit(torch.cuda.init).result()
    pool.submit(_build.build_all).result()
print(time.perf_counter() - t0)
"""


def run_python(*argv, env):
    """``python argv`` from the checkout's root; its stdout and wall s.  A
    non-zero exit fails the phase with the command's output."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, *map(str, argv)], cwd=HERE,
                          env=env, capture_output=True, text=True,
                          timeout=900)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(
            f"python {' '.join(map(str, argv))[:300]} exited "
            f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
            f"{proc.stderr[-6000:]}")
    return proc.stdout, wall


def results(rows):
    """Rows keyed (method, scenario, seed), without the how-it-ran columns."""
    return {(r["method"], r["scenario"], r["seed"]):
            {k: v for k, v in r.items() if k not in HOW} for r in rows}


def hold_report(report, engine, n_runs, critic=None):
    """A whole report of ``engine`` rows: nothing failed, truncated,
    resumed, retried job by job or degraded, and the critic resolved."""
    prov = report["provenance"]
    rows = report["runs"]
    if (report["n_runs"], report["n_failed"], report["n_truncated"],
            prov["resumed_rows"]) != (n_runs, 0, 0, 0):
        raise AssertionError(
            f"{engine} report: runs {report['n_runs']} (want {n_runs}), "
            f"failed {report['n_failed']}, truncated "
            f"{report['n_truncated']}, resumed {prov['resumed_rows']}")
    bad = [(r["method"], r["seed"]) for r in rows
           if r["engine"] != engine or r.get("batch_fallback")
           or r.get("critic_degraded")]
    if bad:
        raise AssertionError(f"{engine} report: rows not run as asked "
                             f"(engine, batch fallback or critic): {bad}")
    if critic is not None:
        art = prov["artifacts"].get("@critic?", {})
        if art.get("missing") or art.get("fingerprint") != \
                critic.fingerprint():
            raise AssertionError(f"{engine} report: the critic did not "
                                 f"resolve to phase haf's: {art}")


def sweep_rates(report, wall):
    """Events, the command's wall s and events/s, and the engine's: the
    sum of the groups' block walls (a row carries its block's)."""
    rows = report["runs"]
    events = sum(r["n_events"] for r in rows)
    groups = {r["method"]: r["engine_wall_s"] for r in rows
              if r.get("b", 0) == 0}
    engine_s = sum(groups.values())
    return {"events": events, "command_wall_s": wall,
            "events_per_s": events / wall, "engine_wall_s": engine_s,
            "engine_events_per_s": events / engine_s,
            "report_wall_s": report["provenance"]["wall_s"],
            "group_engine_wall_s": groups}


def completions(path):
    """(b, rid, class, deadline met) and finish time of every completion
    in a trace."""
    data = obs.load_jsonl(path)
    recs = [e for e in data["events"] if e["kind"] == "completion"]
    return ([(e["b"], e["rid"], e["cls"], e["ok"]) for e in recs],
            np.array([e["t"] for e in recs]), data["header"])


def phase_eval(critic):
    """paper_table3.toml through ``python -m repro_torch.eval`` on the card
    (the default engine) and on the host, one of its groups in-process with
    its launches counted, the other two spec files, the obs CLI and the
    serving launcher."""
    phase_t0 = time.perf_counter()
    os.makedirs(os.path.join(HERE, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="eval-", dir=os.path.join(HERE, "build"))
    store = os.path.join(work, "store")
    critic_path = os.path.join(store, "critic.json")
    save_critic(critic, critic_path, families=("paper",),
                meta={"trained_by": "chip_smoke.py phase haf"})
    os.environ["REPRO_ARTIFACTS"] = store
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"))

    # 1. spawn workers' start-up
    out, _ = run_python("-c", SPAWN_PROBE, env=env)
    spawn_s = float(out.strip().splitlines()[-1])

    # 2. Table III on the card (no --engine: the spec's default, cuda) and
    # on the host, each into a fresh report
    cut = ["--requests", EVAL_REQUESTS, "--seeds", EVAL_SEEDS,
           "--batch", EVAL_BATCH, "--workers", EVAL_WORKERS, "--no-resume"]
    reports, rates = {}, {}
    for engine, extra in (("cuda", []), ("numpy", ["--engine", "numpy"])):
        path = os.path.join(work, f"table3_{engine}.json")
        _, wall = run_python("-m", "repro_torch.eval", "--spec", TABLE3, *cut,
                             *extra, "--out", path, env=env)
        with open(path) as f:
            reports[engine] = json.load(f)
        n_methods = len(reports[engine]["provenance"]["spec"]["methods"])
        hold_report(reports[engine], engine, n_methods * N_EVAL_SEEDS,
                    critic)
        rates[engine] = sweep_rates(reports[engine], wall)
    dev, host = reports["cuda"], reports["numpy"]
    if dev["provenance"]["backend"]["device"] != \
            torch.cuda.get_device_name(0):
        raise AssertionError(f"cuda report: backend "
                             f"{dev['provenance']['backend']}")
    if {r["batch"] for r in dev["runs"]} != {EVAL_BATCH}:
        raise AssertionError("cuda report: rows not in groups of "
                             f"{EVAL_BATCH}")
    if results(dev["runs"]) != results(host["runs"]):
        diff = [k for k, v in results(dev["runs"]).items()
                if results(host["runs"]).get(k) != v]
        raise AssertionError(f"Table III: cuda rows differ from numpy rows "
                             f"at {diff[:6]}")
    slo = {c["method"]: c["overall"]["mean"] for c in dev["aggregate"]}
    if slo != {c["method"]: c["overall"]["mean"] for c in host["aggregate"]}:
        raise AssertionError("Table III: per-method mean SLO differs")
    if not all(slo["HAF"] > v for m, v in slo.items() if m != "HAF"):
        raise AssertionError(f"Table III: HAF not above every baseline: "
                             f"{slo}")

    # 3. one group in-process through the sweep's own entry point: HAF,
    # B = 8, traced, with its event_step launches counted, against the
    # same group on the host engine
    spec = ExperimentSpec.from_file(os.path.join(HERE, TABLE3)).replace(
        n_ai_requests=EVAL_REQUESTS, seeds=tuple(range(N_EVAL_SEEDS)),
        batch=EVAL_BATCH)
    _, jobs, _ = expand_experiment(spec)
    haf_jobs = [j for j in jobs if j["method"] == "haf"]

    def group(engine):
        return sweep.run_batch_jobs([dict(
            j, engine=engine, trace=True, profile=engine == "cuda",
            trace_dir=os.path.join(work, f"traces_{engine}"))
            for j in haf_jobs])

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    dev_rows = group("cuda")
    torch.cuda.synchronize()
    group_wall = time.perf_counter() - t0
    launches = ops.launch_counts()["event_step"]
    host_rows = group("numpy")
    ticks = check_ticks([types.SimpleNamespace(n_events=r["n_events"])
                         for r in dev_rows], launches, "eval group")
    kernel_calls = dev_rows[0]["profile"]["phases"]["core.kernel"]["count"]
    if kernel_calls != launches:
        raise AssertionError(f"eval group: profiled core.kernel calls "
                             f"{kernel_calls} != launches {launches}")
    want = {k: v for k, v in results(dev["runs"]).items() if k[0] == "HAF"}
    if results(dev_rows) != want or results(host_rows) != want:
        raise AssertionError("eval group: in-process HAF rows differ from "
                             "the reports' HAF rows")
    ids_d, fin_d, head_d = completions(dev_rows[0]["trace_path"])
    ids_h, fin_h, head_h = completions(host_rows[0]["trace_path"])
    if ids_d != ids_h or head_d["counts"] != head_h["counts"]:
        raise AssertionError("eval group: traces' completions differ")
    finish_err = float(np.abs(fin_d - fin_h).max()) if len(fin_d) else 0.0
    if not finish_err <= 1e-9:
        raise AssertionError(f"eval group: finish times differ by "
                             f"{finish_err:.3e} > 1e-9")

    # 4. the other spec files: both validate unchanged; trace_sweep runs
    # seed 0 on the card, streamed, traced and profiled, and the obs CLI
    # reads one of its traces back
    for name in ("load_sweep", "trace_sweep"):
        out, _ = run_python("-m", "repro_torch.eval", "--spec",
                            f"experiments/{name}.toml", "--validate",
                            "--out", os.path.join(work, f"{name}.json"),
                            env=env)
        if "nothing run" not in out or " cuda " not in out:
            raise AssertionError(f"{name}: --validate said\n{out}")
    trace_out = os.path.join(work, "trace_sweep.json")
    _, trace_wall = run_python(
        "-m", "repro_torch.eval", "--spec", "experiments/trace_sweep.toml",
        "--seeds", "0,", "--requests", TRACE_REQUESTS, "--trace",
        "--profile", "--no-resume",
        "--out", trace_out, env=env)
    with open(trace_out) as f:
        trace_report = json.load(f)
    n_trace = len(trace_report["provenance"]["spec"]["methods"]) \
        * len(trace_report["provenance"]["spec"]["scenarios"])
    hold_report(trace_report, "cuda", n_trace, critic)
    for r in trace_report["runs"]:
        phases = r["profile"]["phases"]
        if "batch" in r or phases["core.kernel"]["count"] != \
                r["n_events"] + 1:
            raise AssertionError(f"trace_sweep {r['method']} @ "
                                 f"{r['scenario']}: not a one-replica "
                                 "kernel run (a launch a tick, and one)")
    first = trace_report["runs"][0]
    summary, _ = run_python("-m", "repro_torch.obs", "summary",
                            first["trace_path"], env=env)
    m = re.search(r"^\s+completion\s+(\d+)$", summary, re.M)
    if not m or int(m.group(1)) != first["trace_counts"]["completion"]:
        raise AssertionError(f"obs summary disagrees with the row's "
                             f"trace counts:\n{summary}")

    # 5. the serving launcher on the card with the saved critic: its
    # main() in-process, so that its event_step launches are counted
    buf = io.StringIO()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        res = serve.main(["--requests", str(SERVE_REQUESTS),
                          "--critic-path", critic_path])
    torch.cuda.synchronize()
    serve_wall = time.perf_counter() - t0
    serve_launches = ops.launch_counts()["event_step"]
    out = buf.getvalue()
    served = json.loads(out[out.index("{"):out.index("}", out.index("{")) + 1])
    if res.engine != "cuda" or res.truncated \
            or serve_launches != res.n_events + 1:
        raise AssertionError(f"serve: engine {res.engine}, truncated "
                             f"{res.truncated}, event_step launches "
                             f"{serve_launches} for {res.n_events} ticks "
                             "(want ticks + 1)")
    if not 0.0 < served["overall"] <= 1.0:
        raise AssertionError(f"serve: summary out of range: {served}")

    emit("eval", wall_s=time.perf_counter() - phase_t0,
         spec=TABLE3, n_ai_requests=EVAL_REQUESTS, seeds=EVAL_SEEDS,
         batch=EVAL_BATCH, workers=EVAL_WORKERS,
         cut=(f"n_ai_requests {HAF_FULL_REQUESTS} -> {EVAL_REQUESTS}, "
              "seeds [0] -> 0..7, workers 4 -> 2 (run time); trace_sweep "
              f"seeds [0, 1] -> 0, its 2000 rows -> {TRACE_REQUESTS}"),
         runs=dev["n_runs"], rows_equal=True, finish_atol=1e-9,
         spawn_worker_start_s=spawn_s, cuda=rates["cuda"],
         numpy=rates["numpy"],
         slo={m: v for m, v in sorted(slo.items())},
         group={"method": "HAF", "B": EVAL_BATCH, "ticks": ticks,
                "launches": launches, "wall_s": group_wall,
                "finish_max_abs_diff": finish_err,
                "finish_bitwise_equal": bits_equal(fin_d, fin_h),
                "completions": len(fin_d),
                "trace_ring_dropped": head_d["n_dropped"]},
         trace_sweep={"runs": trace_report["n_runs"], "wall_s": trace_wall,
                      "events": sum(r["n_events"]
                                    for r in trace_report["runs"]),
                      "slo": {c["method"] + " @ " + c["scenario"]:
                              c["overall"]["mean"]
                              for c in trace_report["aggregate"]}},
         serve={"requests": SERVE_REQUESTS, "wall_s": serve_wall,
                "engine": res.engine, "ticks": res.n_events,
                "launches": serve_launches,
                "events_per_s": res.n_events / serve_wall,
                "overall": served["overall"],
                "mig_total": served["mig_total"]},
         nvidia_smi=nvidia_smi_line())
    shutil.rmtree(work)          # reports and traces: ~100 MB a run
    return launches, serve_launches


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
    def call():
        return allocator.allocate_cluster(*dev, use_kernel=True)
    ms = median_ms(call, iters=20)
    # device time of one call: its two kernel launches and everything the
    # call runs on the card (the float64 inputs' casts to float32 included).
    # The trace of this call can miss a few of its ~160 kernels, so the
    # kernel's time is its mean per traced launch times the launches the
    # wrapper counted above, and the trace's own count is reported
    call()
    _, per, calls = device_times(call, 20)
    kern = [k for k in per if "alloc_warp_kernel" in k]
    traced = sum(calls[k] for k in kern)
    per_launch = sum(per[k] for k in kern) / traced
    emit("allocate_cluster", N=N, S=S, launches=launches, errors=errs,
         feasible_equal=True, call_ms=ms,
         profiled={"kernel_device_us_per_launch": per_launch,
                   "kernel_device_us": per_launch * launches,
                   "kernel_launches_in_trace": traced,
                   "call_device_us_in_trace": sum(per.values()),
                   "by_kernel_us": per},
         host_numpy_s=host_s,
         inputs="float64 (cast to float32 inside each solve)",
         tolerance="rtol=1e-4, atol=cap*1e-5 vs float64 allocate_cluster_np")
    return launches


# --------------------------------------------------------------------------- #
# phase 6: the serving path of the model zoo
# --------------------------------------------------------------------------- #
# Float32 parity of a kernel lowering with impl="xla", relative to the
# largest |logit| (and of every cache tensor to its own scale).
PARITY_TOL = 1e-4
CONTRACT_TOL = 2e-3          # prefill + decode == forward, tests/test_models
# The reference's initialisation takes the fan-in of an attention
# projection [D, H, hd] as H (qwen2: 14, not D = 896), so untrained
# attention scores reach a standard deviation of ~60: the softmax is an
# argmax, and deep stacks of such layers turn float32 rounding into O(1)
# changes of the logits.  check_parity shows it with no kernel involved:
# impl="xla" in float32 against the same eager path in float64 (whose
# scores, softmax, norms and RoPE the reference's code still rounds to
# float32), on the untempered weights and on the tempered ones (ROADMAP
# Queue C P3).  The served weights therefore scale those projections by 1/8
# after init -- GQA wq and wk, MLA's query projection (wq or wq_b) and wkv_b
# -- which brings the scores to O(1), as in a trained model.
QK_TEMPER = 0.125


def temper(params) -> None:
    """Scale, in place, every attention projection whose fan-in the
    reference takes as the head count (see QK_TEMPER): GQA ``wq`` / ``wk``
    (dense, VLM, the hybrid's shared blocks, whisper's self, cross and
    encoder attention) and MLA's ``wq`` / ``wq_b`` and ``wkv_b``; a model
    without attention is left as it is."""
    if isinstance(params, list):
        for p in params:
            temper(p)
        return
    if not isinstance(params, dict):
        return
    if "wkv_b" in params:
        keys = ("wq_b" if "wq_b" in params else "wq", "wkv_b")
    elif "wq" in params and "wk" in params:
        keys = ("wq", "wk")
    else:
        keys = ()
    for key in keys:
        params[key].mul_(QK_TEMPER)
    for key, v in params.items():
        if key not in keys:
            temper(v)


@dataclasses.dataclass(frozen=True)
class Served:
    """One model of phase serve.  ``kernels`` are the kernels its prefill
    runs besides ``rmsnorm`` (none: the composite path); ``parity_layers`` /
    ``serve_layers`` cut the depth of the
    float32 parity check / the bf16 serving where the full depth does not
    fit (0: full depth); ``f64`` says whether the float64 rounding check
    fits beside the float32 copy; ``steps`` greedy decode steps."""
    name: str
    impl: str
    kernels: tuple
    parity_layers: int = 0
    serve_layers: int = 0
    f64: bool = True
    steps: int = SERVE_STEPS


# the serving slice: each config of configs/ with the impl that reaches its
# kernel (MLA reaches none, as in the reference; a hybrid's kernel lowerings
# reach both of its kernels).  Depth cuts: zamba2-7b's float32 parity at 12
# of 81 layers (two applications, one of each shared block); llava's float32
# parity at 4 of 32 layers (two float32 copies of 7.2 B parameters do not fit
# beside the float64 check); deepseek-v2-lite's at 2 of 27 (its dense layer
# and one MoE layer); deepseek-v3 at 2 of 61 for parity (one dense and one
# MoE layer of 256 experts: 57 GB in float32) and 4 of 61 for serving (3
# dense + 1 MoE, 34 GB in bf16: 61 layers do not fit one card), without its
# MTP block (read only by the training loss).
HYBRID_KERNELS = ("flash_attention", "ssd_scan")
SERVE = (Served("qwen2-0.5b", "flash", ("flash_attention",)),
         Served("mamba2-130m", "pallas", ("ssd_scan",)),
         Served("zamba2-2.7b", "flash", HYBRID_KERNELS),
         Served("zamba2-2.7b", "pallas", HYBRID_KERNELS),
         Served("zamba2-7b", "flash", HYBRID_KERNELS, parity_layers=12,
                steps=8),
         Served("whisper-medium", "flash", ("flash_attention",)),
         Served("llava-next-mistral-7b", "flash", ("flash_attention",),
                parity_layers=4, steps=16),
         Served("deepseek-v2-lite-16b", "flash", ("flash_attention",),
                parity_layers=2, steps=8),
         Served("deepseek-v3-671b", "xla", (), parity_layers=2,
                serve_layers=4, f64=False, steps=8))


def cut(cfg, layers: int):
    """``cfg`` at ``layers`` layers (0: as it is); a MoE config keeps one
    dense layer per leading-dense group it had, at most ``layers - 1``; a
    published hybrid its applications before ``layers``."""
    if not layers:
        return cfg
    kw = {"num_layers": layers, "mtp": False}
    if cfg.hybrid is not None and cfg.hybrid.published:
        kw["hybrid"] = dataclasses.replace(cfg.hybrid, layer_ids=tuple(
            i for i in cfg.hybrid.layer_ids if i < layers))
    if cfg.moe is not None and cfg.moe.first_dense_layers:
        kw["moe"] = dataclasses.replace(
            cfg.moe, first_dense_layers=min(cfg.moe.first_dense_layers,
                                            layers - 1))
    return dataclasses.replace(cfg, **kw)


def kernel_launches(cfg, kernels) -> dict:
    """Launches of each of ``kernels`` in one prefill: ``flash_attention``
    one per causal self-attention (a layer; the hybrid's shared-block
    applications; the decoder's layers of an encoder-decoder), none for
    MLA; ``ssd_scan`` one per Mamba2 layer."""
    out = {}
    for kernel in kernels:
        if cfg.mla is not None:
            out[kernel] = 0
        elif cfg.family == "hybrid" and kernel == "flash_attention":
            out[kernel] = len(cfg.hybrid.app_ids(cfg.num_layers))
        else:
            out[kernel] = cfg.num_layers
    return out


def conv_launches(cfg, impl: str) -> int:
    """``causal_conv_silu`` launches in one prefill: three a Mamba2 mixer
    (x, B and C) under a kernel lowering, none under ``impl="xla"``."""
    mixers = cfg.num_layers if cfg.family in ("ssm", "hybrid") else 0
    return 0 if impl == "xla" else 3 * mixers


def seeded(seed: int) -> torch.Generator:
    return torch.Generator(device=DEV).manual_seed(seed)


def prompts(seed: int, B: int, S: int, vocab: int) -> torch.Tensor:
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(0, vocab, (B, S))).to(DEV)


def batch_for(cfg, seed: int, B: int, S: int) -> dict:
    """A prompt of ``S`` tokens, with the family's precomputed embeddings:
    whisper's encoder frames, llava's 576 patch embeddings before the
    tokens (standard normal, in the config's compute dtype)."""
    out = {"tokens": prompts(seed, B, S, cfg.vocab_size)}
    rng = np.random.default_rng(seed + 7)
    dtype = getattr(torch, cfg.compute_dtype)
    if cfg.encdec is not None:
        out["frames"] = normal(rng, (B, cfg.encdec.encoder_frames,
                                     cfg.d_model), dtype)
    if cfg.vlm is not None:
        out["patch_embeds"] = normal(rng, (B, cfg.vlm.num_patches,
                                           cfg.d_model), dtype)
    return out


def prefix(cfg) -> int:
    """Positions before the tokens: a VLM's patches."""
    return cfg.vlm.num_patches if cfg.vlm is not None else 0


def max_rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over max |b|."""
    a, b = a.float(), b.float()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def greedy(model, params, batch, steps: int, vocab: int):
    """prefill -> pad_cache -> ``steps`` greedy decode steps.  Returns the
    generated tokens [B, steps], the prefill seconds, the mean decode
    seconds per step, and whether every logit was finite."""
    B, S = batch["tokens"].shape
    S += prefix(model.cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, cache = model.prefill(params, batch)
    torch.cuda.synchronize()
    t_prefill = time.perf_counter() - t0
    finite = torch.isfinite(logits).all()
    cache = model.pad_cache(cache, S + steps)
    out = []
    t0 = time.perf_counter()
    for i in range(steps):
        nxt = logits[:, -1, :vocab].argmax(-1, keepdim=True)
        out.append(nxt)
        logits, cache = model.decode_step(params, cache,
                                          {"tokens": nxt, "pos": S + i})
        finite = finite & torch.isfinite(logits).all()
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t0) / steps
    return torch.cat(out, dim=1).cpu(), t_prefill, t_decode, bool(finite)


def check_parity(sv: Served, cfg, seed):
    """Float32, same parameters: the kernel lowering's last-position
    prefill logits and every cache tensor against impl="xla" (at S = 512
    and the ragged 300; None under impl="xla", the composite path itself;
    every kernel lowering launches the rmsnorm kernel, MLA's too), and
    prefill + decode == forward for the kernel lowering; before the weights
    are tempered, how far float32 rounding alone moves the untempered model
    (impl="xla" against float64)."""
    cfg32 = dataclasses.replace(cut(cfg, sv.parity_layers),
                                param_dtype="float32",
                                compute_dtype="float32")
    kernel = sv.impl != "xla"
    mk = build_model(cfg32, impl=sv.impl)
    mx = build_model(cfg32, impl="xla") if kernel else mk
    params = mk.init(seeded(seed))
    rec = {"num_layers": cfg32.num_layers}
    has_attention = cfg.family != "ssm"
    if has_attention and sv.f64:
        # reported, not asserted: how far rounding alone moves this model
        tok = batch_for(cfg32, seed + SERVE_S, SERVE_B, SERVE_S)
        m64 = build_model(dataclasses.replace(
            cfg32, param_dtype="float64", compute_dtype="float64"),
            impl="xla")
        p64 = tree_map(torch.Tensor.double, params)      # the same values
        tok64 = {k: v.double() if v.is_floating_point() else v
                 for k, v in tok.items()}
        lx = mx.prefill(params, tok)[0]
        if kernel:
            rec["untempered_logits_rel_err"] = max_rel(
                mk.prefill(params, tok)[0], lx)
        rec["untempered_xla_f32_vs_f64_rel_err"] = max_rel(
            lx, m64.prefill(p64, tok64)[0])
        temper(params)
        temper(p64)
        rec["tempered_xla_f32_vs_f64_rel_err"] = max_rel(
            mx.prefill(params, tok)[0], m64.prefill(p64, tok64)[0])
        del m64, p64, lx
        torch.cuda.empty_cache()
    else:
        temper(params)
    for S in (SERVE_S, RAGGED_S) if kernel else ():
        batch = batch_for(cfg32, seed + S, SERVE_B, S)
        lk, ck = mk.prefill(params, batch)
        lx, cx = mx.prefill(params, batch)
        rel = max_rel(lk, lx)
        cache_rel = max(max_rel(a, b) for a, b in zip(tree_leaves(ck),
                                                      tree_leaves(cx)))
        if not rel <= PARITY_TOL or not cache_rel <= PARITY_TOL:
            raise AssertionError(
                f"{sv.name} impl={sv.impl} S={S}: prefill logits differ from "
                f"impl='xla' by {rel:.3e} (caches {cache_rel:.3e}) of their "
                f"scale > {PARITY_TOL}")
        rec[f"S{S}"] = {"logits_rel_err": rel, "cache_rel_err": cache_rel,
                        "logit_scale": float(lx.float().abs().max())}
        del lk, ck, lx, cx
    if not kernel:
        rec.update({f"S{S}": None for S in (SERVE_S, RAGGED_S)},
                   no_parity="no kernel on this path")
    if cfg32.moe is None:
        rec["prefill_decode_vs_forward_max_abs"] = contract(
            sv, mk, params, SERVE_S, seed, assert_=True)
    else:
        # Capacity drops make the reference's MoE dispatch non-causal
        # (ROADMAP Queue C R6): slots are given k-major over the whole
        # sequence, so a later token's first choice can push out an earlier
        # token's second, and forward over S tokens is not prefill over S - 1
        # then one decode step.  At the config's capacity factor the
        # contract's error is reported; it is held with a factor of E / k,
        # at which no assignment is dropped (C >= S), on a prompt of
        # MOE_CONTRACT_S tokens (deepseek-v3's 256 experts: C = S slots
        # each of [B, E, C, D] float32 would take 15 GB at S = 512).
        rec["prefill_decode_vs_forward_max_abs_at_config_capacity"] = \
            contract(sv, mk, params, SERVE_S, seed, assert_=False)
        m = cfg32.moe
        mk_all = build_model(dataclasses.replace(cfg32, moe=dataclasses.replace(
            m, capacity_factor=m.num_experts / m.top_k)), impl=sv.impl)
        rec["contract_capacity_factor"] = m.num_experts / m.top_k
        rec["contract_prompt"] = MOE_CONTRACT_S
        rec["prefill_decode_vs_forward_max_abs"] = contract(
            sv, mk_all, params, MOE_CONTRACT_S, seed, assert_=True)
    rec["tolerance"] = (f"logits and caches within {PARITY_TOL} of their "
                        f"scale; contract rtol=atol={CONTRACT_TOL}")
    del mk, mx, params
    torch.cuda.empty_cache()
    return rec


# prompt of the MoE models' prefill + decode == forward check (see
# check_parity)
MOE_CONTRACT_S = 64


def contract(sv: Served, model, params, S: int, seed: int,
             assert_: bool) -> float:
    """prefill(S - 1 tokens) + one decode step against forward(S tokens):
    the largest |difference| of the two last positions' logits, held to
    CONTRACT_TOL (rtol and atol) where ``assert_``."""
    batch = batch_for(model.cfg, seed, SERVE_B, S)
    tok = batch["tokens"]
    P = prefix(model.cfg)
    full = model.forward(params, batch)
    lp, cache = model.prefill(params, dict(batch, tokens=tok[:, :-1]))
    cache = model.pad_cache(cache, P + S + 4)
    ld, _ = model.decode_step(params, cache, {"tokens": tok[:, -1:],
                                              "pos": P + S - 1})
    errs = []
    for got, want in ((lp[:, 0], full[:, -2]), (ld[:, 0], full[:, -1])):
        diff = (got - want).abs()
        if assert_ and not bool(
                (diff <= CONTRACT_TOL * (1 + want.abs())).all()):
            raise AssertionError(
                f"{sv.name} impl={sv.impl}: prefill + decode != forward (max "
                f"abs {float(diff.max()):.3e} > {CONTRACT_TOL} rtol/atol)")
        errs.append(float(diff.max()))
    return max(errs)


def serve_one(sv: Served):
    cfg = get_config(sv.name)
    parity = check_parity(sv, cfg, SEED)

    # the config's own bf16: B = 4 requests of 512 tokens (llava: after its
    # 576 patches), greedy steps
    scfg = cut(cfg, sv.serve_layers)
    want = kernel_launches(scfg, sv.kernels)
    torch.cuda.reset_peak_memory_stats()
    same_path = sv.impl == "xla"        # the composite path, no kernel
    mk = build_model(scfg, impl=sv.impl)
    mx = mk if same_path else build_model(scfg, impl="xla")
    params = mk.init(seeded(SEED))
    temper(params)
    param_bytes = sum(t.numel() * t.element_size()
                      for t in tree_leaves(params))
    batch = batch_for(scfg, SEED, SERVE_B, SERVE_S)
    mk.prefill(params, batch)                        # warm-up, not counted

    ops.reset_launch_counts()
    gen_k, t_pre, t_dec, finite = greedy(mk, params, batch, sv.steps,
                                         cfg.vocab_size)
    counts = ops.launch_counts()
    got = {k: counts[k] for k in sv.kernels}
    if got != want:
        raise AssertionError(
            f"{sv.name} impl={sv.impl}: {got} launches in one prefill and "
            f"{sv.steps} decode steps, expected {want}")
    # a kernel lowering sends every norm of a prefill or decode step to the
    # rmsnorm kernel and each Mamba2 convolution of a prefill to
    # causal_conv_silu; impl="xla" launches nothing
    convs = conv_launches(scfg, sv.impl)
    if any(c for k, c in counts.items()
           if k not in sv.kernels + ("rmsnorm", "causal_conv_silu")) \
            or bool(counts["rmsnorm"]) == same_path \
            or counts["causal_conv_silu"] != convs:
        raise AssertionError(f"{sv.name} impl={sv.impl}: other kernels "
                             f"launched, or rmsnorm where it should not be "
                             f"or not where it should, or not {convs} "
                             f"causal_conv_silu launches: {counts}")
    if not finite:
        raise AssertionError(f"{sv.name}: non-finite logits while serving")
    if not bool(((gen_k >= 0) & (gen_k < cfg.vocab_size)).all()):
        raise AssertionError(f"{sv.name}: a generated token is outside the "
                             "vocabulary")
    # the composite path beside it, where it is another path
    if same_path:
        gen_x, tx_pre, tx_dec = gen_k, t_pre, t_dec
    else:
        gen_x, tx_pre, tx_dec, _ = greedy(mx, params, batch, sv.steps,
                                          cfg.vocab_size)

    # prefill wall time, median of 5, and one profiled prefill: device
    # busy time, the serving kernel's share of it, and the idle share
    def prefill_ms(model):
        walls = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model.prefill(params, batch)
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(walls))
    pre_med = prefill_ms(mk)
    pre_med_x = pre_med if same_path else prefill_ms(mx)
    wall, per, calls = device_times(lambda: mk.prefill(params, batch))
    busy = sum(per.values()) / 1e3
    names = tuple(n for k in sv.kernels for n in SERVE_KERNEL_NAMES[k])
    kern = sum(t for k, t in per.items() if any(part in k for part in names))
    profile_rec = {"wall_ms": wall, "device_busy_ms": busy,
                   "kernel_device_ms": kern / 1e3,
                   "kernel_device_launches": {
                       part: sum(c for k, c in calls.items() if part in k)
                       for part in names},
                   "device_idle_share": 1.0 - busy / wall if per else None,
                   "note": "one prefill under torch.profiler (its host "
                           "overhead included in wall_ms)"}

    ops.reset_launch_counts()
    rag = batch_for(scfg, SEED + 1, SERVE_B, RAGGED_S)
    lk, _ = mk.prefill(params, rag)
    norms = ops.launch_counts()["rmsnorm"]
    lx = lk if same_path else mx.prefill(params, rag)[0]
    if {k: ops.launch_counts()[k] for k in sv.kernels} != want \
            or ops.launch_counts()["causal_conv_silu"] != convs:
        raise AssertionError(f"{sv.name}: ragged prefill missed a kernel")
    if scfg.family in ("dense", "vlm") and not same_path \
            and norms != 2 * scfg.num_layers + 1:
        raise AssertionError(f"{sv.name}: {norms} rmsnorm launches in a "
                             f"prefill, expected two a layer and the final")
    rec = {
        "model": sv.name, "impl": sv.impl, "kernels": list(sv.kernels),
        "num_layers": scfg.num_layers, "config_layers": cfg.num_layers,
        "d_model": cfg.d_model, "dtype": cfg.compute_dtype,
        "param_count": mk.param_count(), "param_bytes": param_bytes,
        "batch": SERVE_B, "prompt": SERVE_S, "prefix": prefix(scfg),
        "decode_steps": sv.steps, "launches": got, "f32_parity": parity,
        "rmsnorm_launches_per_prefill": norms,
        "causal_conv_silu_launches_per_prefill": convs,
        "prefill_ms": t_pre * 1e3, "prefill_ms_median5": pre_med,
        "prefill_profile": profile_rec,
        "prefill_tokens_per_s": SERVE_B * SERVE_S / t_pre,
        "decode_ms_per_step": t_dec * 1e3,
        "decode_tokens_per_s": SERVE_B / t_dec,
        "xla": {"same_path": same_path, "prefill_ms": tx_pre * 1e3,
                "prefill_ms_median5": pre_med_x,
                "decode_ms_per_step": tx_dec * 1e3},
        "greedy_top1_agreement_with_xla": float(
            (gen_k == gen_x).double().mean()),
        "first_divergence_step": int(
            (gen_k != gen_x).any(0).nonzero()[0]) if bool(
                (gen_k != gen_x).any()) else None,
        "ragged_bf16_logits_rel_err_vs_xla": max_rel(lk, lx),
        "peak_memory_bytes": torch.cuda.max_memory_allocated(),
    }
    emit("serve", **rec)
    del mk, mx, params, batch, rag, lk, lx
    torch.cuda.empty_cache()
    return rec


def phase_serve():
    """Every served model in turn, each freed before the next.  Returns
    ``{kernel: {"model/impl": launches a prefill}}`` and the records."""
    t0 = time.perf_counter()
    recs = [serve_one(sv) for sv in SERVE]
    by_kernel = {}
    for rec in recs:
        path = f"{rec['model']}/{rec['impl']}"
        for kernel, n in rec["launches"].items():
            by_kernel.setdefault(kernel, {})[path] = n
        by_kernel.setdefault("rmsnorm", {})[path] = \
            rec["rmsnorm_launches_per_prefill"]
        by_kernel.setdefault("causal_conv_silu", {})[path] = \
            rec["causal_conv_silu_launches_per_prefill"]
    emit("serve_summary", seconds=time.perf_counter() - t0,
         launches_by_path=by_kernel)
    return by_kernel


# --------------------------------------------------------------------------- #
# phase 7: the training path
# --------------------------------------------------------------------------- #
# qwen2-0.5b at full width and depth in its bf16: S = 512, global batch 8,
# 24 steps, checkpoints every 8, an injected failure at step 13
TRAIN_S, TRAIN_B = 512, 8
TRAIN_STEPS, TRAIN_EVERY, TRAIN_FAIL = 24, 8, 13
MAMBA_TRAIN_STEPS = 16
# The configs' weights are bf16 and AdamW casts them back after each step,
# as in the reference (no float32 master copy): under the TrainConfig
# default (20 warm-up steps to 3e-4) most steps of a 24-step run are under
# half a bf16 ulp of the weights (|w| ~ 0.03: half an ulp 1.2e-4) and are
# lost.  These runs take a peak of 3e-3 after 4 warm-up steps.
TRAIN_LR = dict(peak_lr=3e-3, warmup=4)
# The reference's initialisation (ROADMAP Queue C P3) makes the untrained
# 24-layer qwen2 chaotic: its gradient norm is ~2.5e15 on the card (~90 at 2
# layers), so clipped AdamW walks at random and the loss does not fall.  As
# in phase serve, the run starts from tempered weights (temper: wq, wk x
# 1/8; gradient norm ~14 at d 896): they go in as the step-0 checkpoint,
# which train() restores before its first step, as a run warm-started from
# given weights does.
LAUNCH_STEPS = 4             # the launcher's default preset, every config
TIMED_STEPS = 5
# card (float32, TF32 off) against the host's float64 path at the 100m
# width and 2 layers: relative loss, gradient leaves of their scale, one
# AdamW step (relative)
TRAIN_PARITY = ("qwen2-0.5b", "mamba2-130m", "deepseek-v3-671b")
TRAIN_PARITY_B, TRAIN_PARITY_S = 2, 256
LOSS_TOL, GRAD_TOL, ADAMW_TOL = 1e-5, 1e-4, 1e-6


def leaf_rel(got, want) -> float:
    """max |got - want| over max |want| (float64)."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max()
                 / want.abs().max().clamp_min(1e-30))


def train_parity(name: str) -> dict:
    """The card's float32 loss and gradients against the host's float64
    path on the same (tempered) weights and batch; one AdamW step on the
    card against the same step on the host."""
    cfg = dataclasses.replace(preset_config(name, "100m"), num_layers=2)
    cfg64 = dataclasses.replace(cfg, param_dtype="float64",
                                compute_dtype="float64")
    model = build_model(cfg)
    params = model.init(seeded(SEED))
    temper(params)
    host = tree_map(lambda t: t.detach().cpu().double(), params)
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=TRAIN_PARITY_S,
                        global_batch=TRAIN_PARITY_B)
    batch = pipe.next_batch()
    loss, gtree = value_and_grad(model, params, batch_to_device(batch, DEV))
    loss64, grads64 = value_and_grad(build_model(cfg64, device="cpu"), host,
                                     batch_to_device(batch, "cpu"))
    loss_err = abs(float(loss) - float(loss64)) / abs(float(loss64))
    grad_errs = [leaf_rel(g, w) for g, w in zip(tree_leaves(gtree),
                                                 tree_leaves(grads64))]
    if loss_err > LOSS_TOL or max(grad_errs) > GRAD_TOL:
        raise AssertionError(f"train parity {name}: loss {loss_err:.3g} "
                             f"(bar {LOSS_TOL}), worst gradient leaf "
                             f"{max(grad_errs):.3g} (bar {GRAD_TOL})")
    decay = model.decay_mask()
    lr = torch.tensor(1e-3)
    dev_p, dev_s = adamw_update(params, gtree, adamw_init(params),
                                lr=lr.to(DEV), decay=decay)
    cpu_p = tree_map(lambda t: t.detach().cpu(), params)
    cpu_g = tree_map(lambda t: t.detach().cpu(), gtree)
    host_p, host_s = adamw_update(cpu_p, cpu_g, adamw_init(cpu_p), lr=lr,
                                  decay=decay)
    adamw_err = max(leaf_rel(a, b) for x, y in ((dev_p, host_p),
                                                (dev_s.m, host_s.m),
                                                (dev_s.v, host_s.v))
                    for a, b in zip(tree_leaves(x), tree_leaves(y)))
    if adamw_err > ADAMW_TOL:
        raise AssertionError(f"train parity {name}: one AdamW step on the "
                             f"card {adamw_err:.3g} from the host's (bar "
                             f"{ADAMW_TOL})")
    mtp = None
    if cfg.mtp:
        mtp = max(float(g.abs().max()) for g in tree_leaves(gtree["mtp"]))
        if not mtp > 0:
            raise AssertionError(f"{name}: the MTP head has no gradient")
    return {"model": name, "layers": cfg.num_layers, "d_model": cfg.d_model,
            "batch": TRAIN_PARITY_B, "seq": TRAIN_PARITY_S,
            "loss": float(loss), "loss_rel_err_vs_f64": loss_err,
            "worst_grad_leaf_err_vs_f64": max(grad_errs),
            "adamw_card_vs_host_rel_err": adamw_err,
            "mtp_grad_max": mtp}


def train_full(name: str, steps: int, compress: bool, fail_at, ckpt_dir):
    """``train`` of ``name`` at the full preset (impl="xla", remat="dots",
    ``TRAIN_LR``) with the state of every checkpoint the loop writes kept
    aside on the card: returns the history, the wall seconds of the run, the
    seconds each save took, and the last saved state.  With a
    ``ckpt_dir``, the run starts from tempered weights saved there as step 0
    (see TRAIN_LR)."""
    cfg = preset_config(name, "full")
    model = Model(cfg, remat="dots")
    pipe = make_pipeline(cfg, TRAIN_S, TRAIN_B)
    tc = TrainConfig(steps=steps, checkpoint_every=TRAIN_EVERY,
                     checkpoint_dir=ckpt_dir, compress_grads=compress,
                     **TRAIN_LR)
    if ckpt_dir:
        params = model.init(seeded(SEED))
        temper(params)
        ckpt.save_checkpoint(ckpt_dir, 0, params,
                             opt_state=adamw_init(params),
                             extra={"pipeline": pipe.state_dict()})
        del params
    saved, save_s = {}, []
    real_save = ckpt.save_checkpoint

    def save(ckpt_dir, step, params, opt_state=None, extra=None):
        t0 = time.perf_counter()
        out = real_save(ckpt_dir, step, params, opt_state=opt_state,
                        extra=extra)
        save_s.append(time.perf_counter() - t0)
        saved.update(step=step, params=params, opt_state=opt_state)
        return out
    ckpt.save_checkpoint = save
    try:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        hist = train(model, pipe, tc, injector=FailureInjector(fail_at),
                     verbose=False)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        ckpt.save_checkpoint = real_save
    return model, pipe, tc, hist, wall, save_s, saved


def time_train_steps(model, tc, params, opt, pipe):
    """Median ms of ``TIMED_STEPS`` synchronised train steps from the given
    state, then one step under torch.profiler: its wall ms, device busy ms
    and idle share."""
    step = make_train_step(model, tc, tc.compress_grads)
    batch = batch_to_device(pipe.next_batch(), DEV)
    comp_state = compression.init_state(params) if tc.compress_grads \
        else None
    params, opt, comp_state, _ = step(params, opt, batch, comp_state)
    walls = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, comp_state, m = step(params, opt, batch, comp_state)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    state = {"p": params, "o": opt, "c": comp_state}

    def one():
        state["p"], state["o"], state["c"], _ = step(
            state["p"], state["o"], batch, state["c"])
    wall, per, calls = device_times(one)
    busy = sum(per.values()) / 1e3
    return {"step_ms_median": float(np.median(walls)),
            "step_ms_all": walls, "profiled_wall_ms": wall,
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall if per else None,
            "kernels_a_step": int(round(sum(calls.values()))),
            "note": "idle share of one step under torch.profiler (its host "
                    "overhead included in the wall)"}


def phase_train():
    """The training path: qwen2-0.5b at full width and depth with a
    restart; mamba2-130m with int8 compression; the launcher's default
    preset for every config; card against host float64; the kernel guard.
    Training is impl="xla": no kernel may launch in this phase."""
    t_phase = time.perf_counter()
    ops.reset_launch_counts()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    free_gb = shutil.disk_usage(tmp).free / 1e9
    try:
        # qwen2-0.5b: 24 steps, checkpoints every 8, a failure at step 13
        name = "qwen2-0.5b"
        model, pipe, tc, hist, wall, save_s, saved = train_full(
            name, TRAIN_STEPS, False, [TRAIN_FAIL], tmp)
        peak = torch.cuda.max_memory_allocated()
        ckpt_bytes = sum(f.stat().st_size for f in
                         pathlib.Path(tmp).rglob("*") if f.is_file())
        # a cold restore: a fresh template, the newest checkpoint
        fresh = model.init(seeded(SEED + 1))
        t0 = time.perf_counter()
        state, step, extra = ckpt.restore_checkpoint(
            tmp, {"params": fresh, "opt_state": adamw_init(fresh)})
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        got = tree_leaves([state["params"], state["opt_state"].m,
                           state["opt_state"].v, state["opt_state"].step])
        want = tree_leaves([saved["params"], saved["opt_state"].m,
                            saved["opt_state"].v, saved["opt_state"].step])
        restored_equal = len(got) == len(want) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, want))
        del saved, want, got, fresh
        cfg = model.cfg
        timing = time_train_steps(model, tc, state["params"],
                                  state["opt_state"], pipe)
        del state
        tokens = TRAIN_B * TRAIN_S
        step_s = timing["step_ms_median"] / 1e3
        model_flops = 3.0 * cfg.flops_per_token(context_len=TRAIN_S // 2) \
            * tokens
        emit("train_full", model=name, layers=cfg.num_layers,
             d_model=cfg.d_model, param_count=model.param_count(),
             dtype=cfg.param_dtype, impl="xla", remat="dots", seq=TRAIN_S,
             global_batch=TRAIN_B, steps=TRAIN_STEPS, **TRAIN_LR,
             restarts=hist["restarts"], steps_run=len(hist["loss"]),
             loss=hist["loss"], grad_norm=hist["grad_norm"],
             stragglers=hist["stragglers"],
             latest_step=ckpt.latest_step(tmp), restored_step=step,
             restored_extra=extra, cold_restore_bit_equal=restored_equal,
             train_wall_s=wall, checkpoint_save_s=save_s,
             cold_restore_s=restore_s,
             checkpoint_bytes_each=ckpt_bytes / (len(save_s) + 1),
             peak_memory_bytes=peak, disk_free_gb_before=free_gb, **timing,
             steps_per_s=1.0 / step_s, tokens_per_s=tokens / step_s,
             model_flops_per_step=model_flops,
             mfu_of_989_tflops_bf16=model_flops / step_s / BF16_TC_FLOPS)
        if hist["restarts"] != [TRAIN_FAIL]:
            raise AssertionError(f"{name}: restarts {hist['restarts']}, "
                                 f"expected [{TRAIN_FAIL}]")
        if not (hist["loss"][-1] < hist["loss"][0]) or \
                not np.isfinite(hist["loss"]).all():
            raise AssertionError(f"{name}: loss {hist['loss'][0]} -> "
                                 f"{hist['loss'][-1]}")
        if ckpt.latest_step(tmp) != TRAIN_STEPS or step != TRAIN_STEPS or \
                extra != {"pipeline": {"step": TRAIN_STEPS}}:
            raise AssertionError(f"{name}: latest checkpoint "
                                 f"{ckpt.latest_step(tmp)}, restored step "
                                 f"{step}, {extra}")
        if not restored_equal:
            raise AssertionError(f"{name}: the cold restore differs from "
                                 "the final state")
        del model, pipe
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()

        # mamba2-130m with int8 gradient compression: the loss falls
        model, pipe, tc, hist, wall, _, _ = train_full(
            "mamba2-130m", MAMBA_TRAIN_STEPS, True, [], None)
        emit("train_compressed", model="mamba2-130m",
             dtype=model.cfg.param_dtype,
             steps=len(hist["loss"]), **TRAIN_LR, loss=hist["loss"],
             grad_norm=hist["grad_norm"],
             train_wall_s=wall,
             peak_memory_bytes=torch.cuda.max_memory_allocated())
        if not (hist["loss"][-1] < hist["loss"][0]):
            raise AssertionError(f"mamba2 compressed: loss {hist['loss'][0]}"
                                 f" -> {hist['loss'][-1]}")
        del model, pipe
        torch.cuda.empty_cache()

        # the launcher's default preset (100m, float32), every config
        launched = {}
        for arch in ARCH_NAMES:
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(io.StringIO()):
                h = launch_train.main(["--arch", arch, "--steps",
                                       str(LAUNCH_STEPS)])
            if len(h["loss"]) != LAUNCH_STEPS or \
                    not np.isfinite(h["loss"]).all():
                raise AssertionError(f"launch.train {arch}: {h['loss']}")
            launched[arch] = {"loss": h["loss"],
                              "wall_s": time.perf_counter() - t0}
            torch.cuda.empty_cache()
        emit("train_launcher", preset="100m", steps=LAUNCH_STEPS,
             seq=TRAIN_S, global_batch=TRAIN_B, runs=launched)

        # card against host float64, TF32 off (as everywhere in this script)
        parity = [train_parity(name) for name in TRAIN_PARITY]
        emit("train_parity", tolerance={"loss_rel": LOSS_TOL,
                                        "grad_leaf_of_scale": GRAD_TOL,
                                        "adamw_rel": ADAMW_TOL},
             models=parity)

        # the kernel guard: impl="flash" refuses to be differentiated
        cfg = dataclasses.replace(preset_config("qwen2-0.5b", "100m"),
                                  num_layers=2)
        model = build_model(cfg, impl="flash")
        params = model.init(seeded(SEED))
        batch = batch_to_device(DataPipeline(
            vocab_size=cfg.vocab_size, seq_len=128,
            global_batch=2).next_batch(), DEV)
        try:
            value_and_grad(model, params, batch)
        except RuntimeError as err:
            if "no backward" not in str(err):
                raise
            guard = str(err)
        else:
            raise AssertionError("impl='flash' loss was differentiated "
                                 "through the kernel")
        counts = ops.launch_counts()
        if any(counts.values()):
            raise AssertionError(f"phase train launched kernels: {counts}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("train_summary", seconds=time.perf_counter() - t_phase,
         kernel_guard=guard, kernel_launches=counts)


# --------------------------------------------------------------------------- #
# phase mesh: four ranks share the card as a 2×2 (data × model) mesh
# --------------------------------------------------------------------------- #
MESH_WORLD, MESH_DIMS = 4, (2, 2)
# NCCL takes one rank a card, and gloo's CUDA functional collectives crash in
# torch 2.11 (ROADMAP F5): the ranks sharing the card stage collectives
# through host memory (repro_torch.distributed.hoststaged)
MESH_BACKEND = "cpu:gloo,cuda:hoststaged"
MESH_TIMEOUT_S = 600
# parity: qwen2-0.5b at full width, 2 layers, float32, 5 steps, against one
# rank on the card; the first step's gradients (before clipping and AdamW)
# leaf by leaf, each of its own largest magnitude; the loss of every step
# relative; the parameters after 5 steps of the parameters' largest
# magnitude.  Each leaf's worst parameter error of its own scale is
# reported, with the first step's gradients at that element: AdamW steps an
# element by its gradient over that gradient's RMS, so where an element's
# gradient is small beside its leaf's largest, the rounding of a sum taken
# in another order becomes a large share of its step (ROADMAP P10)
MESH_PARITY_LAYERS, MESH_PARITY_STEPS, MESH_PARITY_S, MESH_PARITY_B = \
    2, 5, 256, 4
MESH_LOSS_TOL, MESH_GRAD_TOL, MESH_PARAM_TOL = 1e-5, 1e-5, 1e-4
# the run: phase train's shape at full depth, 8 steps, a checkpoint every 4,
# a failure at step 5
MESH_STEPS, MESH_EVERY, MESH_FAIL = 8, 4, 5
MESH_SERVE_TOL = 1e-4


def mesh_parity_config():
    cfg = preset_config("qwen2-0.5b", "full")
    return dataclasses.replace(cfg, num_layers=MESH_PARITY_LAYERS,
                               param_dtype="float32",
                               compute_dtype="float32")


def mesh_parity_start(ckpt_dir: str) -> None:
    """The parity run's tempered weights as the step-0 checkpoint."""
    cfg = mesh_parity_config()
    model = Model(cfg, remat="dots")
    params = model.init(seeded(SEED))
    temper(params)
    ckpt.save_checkpoint(ckpt_dir, 0, params, opt_state=adamw_init(params),
                         extra={"pipeline": {"step": 0}})


def mesh_parity_run(mesh, ckpt_dir: str):
    """``train`` of the parity config from the step-0 checkpoint in
    ``ckpt_dir`` on ``mesh`` (None: one rank); returns the history and the
    final parameters gathered whole."""
    from repro_torch.distributed.placement import gather_full
    cfg = mesh_parity_config()
    model = Model(cfg, remat="dots")
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=MESH_PARITY_S,
                        global_batch=MESH_PARITY_B)
    tc = TrainConfig(steps=MESH_PARITY_STEPS, checkpoint_dir=ckpt_dir,
                     checkpoint_every=10 ** 6, **TRAIN_LR)
    out = {}
    hist = train(model, pipe, tc, mesh=mesh, verbose=False, final_state=out)
    return hist, gather_full(out["params"])


def mesh_parity_grads(mesh, ckpt_dir: str):
    """The parity run's first-step gradients (the step-0 checkpoint in
    ``ckpt_dir``, the first batch; before clipping and AdamW) on ``mesh``
    (None: one rank), redistributed to their parameters' placements and
    gathered whole, as host tensors."""
    from repro_torch.distributed import placement
    from repro_torch.launch.mesh import make_device_mesh
    cfg = mesh_parity_config()
    model = Model(cfg, remat="dots")
    state, _, _ = ckpt.restore_checkpoint(
        ckpt_dir, {"params": model.init(seeded(SEED))}, step=0)
    params = state["params"]
    batch = batch_to_device(DataPipeline(
        vocab_size=cfg.vocab_size, seq_len=MESH_PARITY_S,
        global_batch=MESH_PARITY_B).next_batch(), DEV)
    if mesh is not None:
        dmesh = make_device_mesh(mesh, "cuda")
        params = placement.place_params(params, model, dmesh)
        batch = placement.place_batch(batch, dmesh)
    _, grads = value_and_grad(model, params, batch)
    grads = placement.gather_full(placement.redistribute_like(grads, params))
    return [g.detach().cpu() for g in tree_leaves(grads)]


def leaf_names(tree, path: str = "") -> list:
    """The leaves' paths, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{path}[{i}]")]
    return [path or "/"]


def mesh_serve_config():
    return dataclasses.replace(get_config("qwen2-0.5b"),
                               param_dtype="float32",
                               compute_dtype="float32")


def mesh_serve_inputs(model):
    params = model.init(seeded(SEED))
    temper(params)
    cfg = model.cfg
    return params, {"tokens": prompts(SEED, SERVE_B, SERVE_S,
                                      cfg.vocab_size)}


def local_bytes(tree) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tree_leaves(tree))


def mesh_worker(rank: int, port: int, out_dir: str) -> None:
    """One rank of phase mesh: the parity run, the full-depth run with a
    failure, the flash prefill; rank 0 writes the report."""
    import datetime
    import faulthandler
    from repro_torch.distributed import placement
    faulthandler.enable()
    from repro_torch.launch.mesh import MeshShape, make_device_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    import repro_torch.distributed.hoststaged  # noqa: F401 — the backend
    torch.distributed.init_process_group(
        MESH_BACKEND, init_method=f"tcp://localhost:{port}",
        rank=rank,
        world_size=MESH_WORLD,
        timeout=datetime.timedelta(seconds=MESH_TIMEOUT_S))
    try:
        _build.load()
        shape = MeshShape(("data", "model"), MESH_DIMS)
        report = {"rank": rank}
        # 1. parity against one rank: the first step's gradients, the run
        grads = mesh_parity_grads(shape, os.path.join(out_dir, "parity_mesh"))
        if rank == 0:
            torch.save(grads, os.path.join(out_dir, "parity_grads.pt"))
        del grads
        torch.cuda.empty_cache()
        hist, params = mesh_parity_run(shape,
                                       os.path.join(out_dir, "parity_mesh"))
        report["parity"] = {"loss": hist["loss"],
                            "grad_norm": hist["grad_norm"]}
        if rank == 0:
            torch.save([t.cpu() for t in tree_leaves(params)],
                       os.path.join(out_dir, "parity_params.pt"))
        del params
        torch.cuda.empty_cache()

        # 2. full depth in bf16 with a failure at MESH_FAIL
        ckpt_dir = os.path.join(out_dir, "ckpt")
        cfg = preset_config("qwen2-0.5b", "full")
        model = Model(cfg, remat="dots")
        pipe = make_pipeline(cfg, TRAIN_S, TRAIN_B)
        tc = TrainConfig(steps=MESH_STEPS, checkpoint_every=MESH_EVERY,
                         checkpoint_dir=ckpt_dir, **TRAIN_LR)
        torch.cuda.reset_peak_memory_stats()
        out = {}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hist = train(model, pipe, tc, mesh=shape, verbose=False,
                     injector=FailureInjector([MESH_FAIL]), final_state=out)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        state = [out["params"], out["opt"].m, out["opt"].v]
        whole = sum(t.numel() * t.element_size() for t in tree_leaves(state))
        full = placement.gather_full(out["params"])
        restored_equal = None
        if rank == 0:
            # the final checkpoint restored in one process, plain tensors
            template = {"params": model.init(seeded(SEED + 1))}
            got, step, _ = ckpt.restore_checkpoint(ckpt_dir, template)
            restored_equal = step == MESH_STEPS and all(
                a.dtype == b.dtype and torch.equal(a, b) for a, b in zip(
                    tree_leaves(got["params"]), tree_leaves(full)))
            del got, template
        report["run"] = {
            "loss": hist["loss"], "grad_norm": hist["grad_norm"],
            "restarts": hist["restarts"], "steps_run": len(hist["loss"]),
            "wall_s": wall, "ms_a_step_incl_restart": wall * 1e3
            / len(hist["loss"]),
            "param_moment_bytes_rank": local_bytes(state),
            "param_moment_bytes_whole": whole,
            "peak_memory_bytes_rank": torch.cuda.max_memory_allocated(),
            "restored_bit_equal": restored_equal}
        # ms a step: the median over the run's steps (a cold first step and
        # the one after the restore among them)
        walls = [t * 1e3 for t in out["step_s"]]
        report["run"]["step_ms_median"] = float(np.median(walls))
        report["run"]["step_ms_all"] = walls
        del out, state, full, model
        torch.cuda.empty_cache()

        # 3. the flash prefill on the mesh, float32
        model = build_model(mesh_serve_config(), impl="flash")
        params, batch = mesh_serve_inputs(model)
        mesh = make_device_mesh(shape, "cuda")
        pp = placement.place_params(params, model, mesh)
        bb = placement.place_batch(batch, mesh)
        del params
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        with torch.no_grad():
            logits, _ = model.prefill(pp, bb)
        launches = ops.launch_counts()["flash_attention"]
        logits = placement.gather_full(logits)
        if rank == 0:
            torch.save(logits.cpu(), os.path.join(out_dir, "logits.pt"))
        report["serve"] = {"flash_launches": launches}
        reports = [None] * MESH_WORLD
        torch.distributed.all_gather_object(reports, report)
        if rank == 0:
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(reports, f)
    finally:
        torch.distributed.destroy_process_group()


def free_port() -> int:
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def phase_mesh():
    """Four spawned ranks share the card as a 2×2 mesh (gloo: NCCL takes
    one rank a card): training parity against one rank, qwen2-0.5b at full
    depth with a failure and a cross restore, and the flash prefill."""
    import torch.multiprocessing as mp
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        # one rank on the card: the parity run and the prefill
        mesh_parity_start(os.path.join(tmp, "parity_one"))
        shutil.copytree(os.path.join(tmp, "parity_one"),
                        os.path.join(tmp, "parity_mesh"))
        grads1 = mesh_parity_grads(None, os.path.join(tmp, "parity_one"))
        torch.cuda.empty_cache()
        hist1, params1 = mesh_parity_run(None,
                                         os.path.join(tmp, "parity_one"))
        names = leaf_names(params1)
        params1 = [t.detach().cpu() for t in tree_leaves(params1)]
        torch.cuda.empty_cache()
        model = build_model(mesh_serve_config(), impl="flash")
        params, batch = mesh_serve_inputs(model)
        with torch.no_grad():
            logits1 = model.prefill(params, batch)[0].cpu()
        del params, model
        torch.cuda.empty_cache()
        # the run starts from tempered weights, as phase train's does
        cfg = preset_config("qwen2-0.5b", "full")
        model = Model(cfg, remat="dots")
        ckpt_dir = os.path.join(tmp, "ckpt")
        params = model.init(seeded(SEED))
        temper(params)
        ckpt.save_checkpoint(ckpt_dir, 0, params,
                             opt_state=adamw_init(params),
                             extra={"pipeline": make_pipeline(
                                 cfg, TRAIN_S, TRAIN_B).state_dict()})
        del params, model
        torch.cuda.empty_cache()

        t0 = time.perf_counter()
        mp.start_processes(mesh_worker, args=(free_port(), tmp),
                           nprocs=MESH_WORLD, start_method="spawn")
        spawn_s = time.perf_counter() - t0
        with open(os.path.join(tmp, "report.json")) as f:
            reports = json.load(f)
        r0 = reports[0]

        # 1. parity
        loss_err = max(abs(a - b) / abs(b) for a, b in
                       zip(r0["parity"]["loss"], hist1["loss"]))
        grads = torch.load(os.path.join(tmp, "parity_grads.pt"))
        grad_errs = [leaf_rel(g, w) for g, w in zip(grads, grads1)]
        worst_grad = int(np.argmax(grad_errs))
        got = torch.load(os.path.join(tmp, "parity_params.pt"))
        scale = max(float(w.abs().max()) for w in params1)
        tree_err = max(float((g.cpu() - w).abs().max()) for g, w in
                       zip(got, params1)) / scale
        leaf_errs = [leaf_rel(g, w) for g, w in zip(got, params1)]
        worst = int(np.argmax(leaf_errs))
        # the worst leaf's worst element: its first-step gradients, that
        # gradient against the leaf's largest, and their difference against
        # the leaf's gradient scale and against the element's own gradient
        diff = (got[worst].double() - params1[worst].double()).abs()
        at = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
        g_one, g_mesh = float(grads1[worst][at]), float(grads[worst][at])
        g_scale = float(grads1[worst].abs().max())
        element = {"leaf": names[worst], "index": [int(i) for i in at],
                   "param_abs_diff": float(diff[at]),
                   "param_own_scale": float(params1[worst].abs().max()),
                   "grad1_one_rank": g_one, "grad1_mesh": g_mesh,
                   "grad1_of_leaf_grad_scale": abs(g_one) / g_scale,
                   "grad1_diff_of_leaf_grad_scale":
                       abs(g_mesh - g_one) / g_scale,
                   "grad1_diff_of_own_grad": abs(g_mesh - g_one)
                       / max(abs(g_one), 1e-30)}
        emit("mesh_parity", model="qwen2-0.5b", layers=MESH_PARITY_LAYERS,
             dtype="float32", mesh=list(MESH_DIMS), ranks=MESH_WORLD,
             backend=MESH_BACKEND, steps=MESH_PARITY_STEPS, seq=MESH_PARITY_S,
             global_batch=MESH_PARITY_B, loss_mesh=r0["parity"]["loss"],
             loss_one_rank=hist1["loss"],
             grad_norm_mesh=r0["parity"]["grad_norm"],
             grad_norm_one_rank=hist1["grad_norm"],
             grad1_worst_leaf_err_of_own_scale=grad_errs[worst_grad],
             grad1_worst_leaf=names[worst_grad],
             loss_rel_err=loss_err, param_err_of_tree_scale=tree_err,
             worst_leaf_err_of_own_scale=leaf_errs[worst],
             worst_leaf_index=worst, worst_leaf_element=element,
             tolerance={"grad1_of_own_scale": MESH_GRAD_TOL,
                        "loss_rel": MESH_LOSS_TOL,
                        "param_of_tree_scale": MESH_PARAM_TOL})
        if len(grads) != len(grads1) or any(
                g.shape != w.shape for g, w in zip(grads, grads1)) or \
                grad_errs[worst_grad] > MESH_GRAD_TOL:
            raise AssertionError(f"mesh parity: first-step gradient of "
                                 f"{names[worst_grad]} "
                                 f"{grad_errs[worst_grad]:.3g} of its scale "
                                 f"(bar {MESH_GRAD_TOL})")
        if len(r0["parity"]["loss"]) != MESH_PARITY_STEPS or \
                loss_err > MESH_LOSS_TOL or tree_err > MESH_PARAM_TOL:
            raise AssertionError(f"mesh parity: loss {loss_err:.3g} (bar "
                                 f"{MESH_LOSS_TOL}), parameters {tree_err:.3g}"
                                 f" (bar {MESH_PARAM_TOL})")

        # 2. the run
        runs = [r["run"] for r in reports]
        run = runs[0]
        emit("mesh_train", model="qwen2-0.5b", layers=24, dtype="bfloat16",
             mesh=list(MESH_DIMS), ranks=MESH_WORLD, backend=MESH_BACKEND,
             seq=TRAIN_S, global_batch=TRAIN_B, steps=MESH_STEPS,
             checkpoint_every=MESH_EVERY, fail_at=MESH_FAIL, **TRAIN_LR,
             loss=run["loss"], grad_norm=run["grad_norm"],
             restarts=run["restarts"], steps_run=run["steps_run"],
             restored_bit_equal=run["restored_bit_equal"],
             step_ms_median=[r["step_ms_median"] for r in runs],
             step_ms_all_rank0=run["step_ms_all"],
             wall_s=[r["wall_s"] for r in runs],
             param_moment_bytes_rank=[r["param_moment_bytes_rank"]
                                      for r in runs],
             param_moment_bytes_whole=run["param_moment_bytes_whole"],
             rank_share=[r["param_moment_bytes_rank"]
                         / r["param_moment_bytes_whole"] for r in runs],
             peak_memory_bytes_rank=[r["peak_memory_bytes_rank"]
                                     for r in runs],
             replicated_leaves=len(spec_report_of_mesh()))
        if run["restarts"] != [MESH_FAIL]:
            raise AssertionError(f"mesh run: restarts {run['restarts']}, "
                                 f"expected [{MESH_FAIL}]")
        if not (run["loss"][-1] < run["loss"][0]) or \
                not np.isfinite(run["loss"]).all():
            raise AssertionError(f"mesh run: loss {run['loss'][0]} -> "
                                 f"{run['loss'][-1]}")
        if run["restored_bit_equal"] is not True:
            raise AssertionError("mesh run: the final checkpoint restored in "
                                 "one process differs from the gathered "
                                 "parameters")

        # 3. the flash prefill; its shard on each rank is among the shapes
        # phase model_kernels holds against attention_ref
        shard = (SERVE_B // MESH_DIMS[0], SERVE_S, 14 // MESH_DIMS[1],
                 2 // MESH_DIMS[1], 64)
        if shard not in FLASH_SHAPES:
            raise AssertionError(f"mesh prefill: the shard {shard} is not "
                                 f"in FLASH_SHAPES")
        logits = torch.load(os.path.join(tmp, "logits.pt"))
        serve_err = max_rel(logits, logits1)
        launches = [r["serve"]["flash_launches"] for r in reports]
        want = get_config("qwen2-0.5b").num_layers
        emit("mesh_serve", model="qwen2-0.5b", impl="flash", dtype="float32",
             batch=SERVE_B, seq=SERVE_S, mesh=list(MESH_DIMS),
             flash_launches_per_rank=launches, logits_rel_err=serve_err,
             tolerance=MESH_SERVE_TOL)
        if launches != [want] * MESH_WORLD:
            raise AssertionError(f"mesh prefill: flash launches {launches}, "
                                 f"expected {want} a rank")
        if serve_err > MESH_SERVE_TOL:
            raise AssertionError(f"mesh prefill: logits {serve_err:.3g} from "
                                 f"the one-card prefill (bar "
                                 f"{MESH_SERVE_TOL})")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit("mesh_summary", seconds=time.perf_counter() - t_phase,
         spawn_s=spawn_s)
    return sum(launches)


def spec_report_of_mesh():
    from repro_torch.distributed.sharding import spec_report
    from repro_torch.launch.mesh import MeshShape
    model = Model(preset_config("qwen2-0.5b", "full"), device="meta")
    return spec_report(model, MeshShape(("data", "model"), MESH_DIMS))


# --------------------------------------------------------------------------- #
# phase dryrun: the dry-run's count against the card, then the sweep
# --------------------------------------------------------------------------- #
DRYRUN_MESH, DRYRUN_ARCHS = "single", ("qwen2-0.5b", "mamba2-130m")
DRYRUN_TIMEOUT_S = 300


@contextlib.contextmanager
def dryrun_sweep():
    """The dry-run's CLI on a subset of cells, one subprocess a cell, all
    started together: a cell needs no card and one host core.  Yields the
    ``(process, out dir)`` of each and the start on the wall clock; on exit
    every process still running is killed and the out dirs removed."""
    from repro_torch.configs import cells_for
    env = dict(os.environ, PYTHONPATH=os.path.join(HERE, "src"),
               OMP_NUM_THREADS="1")
    t0 = time.time()
    procs = []
    try:
        for arch in DRYRUN_ARCHS:
            for cell in cells_for(arch):
                out = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
                with open(os.path.join(out, "stderr.txt"), "w") as err:
                    procs.append((subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.launch.dryrun",
                         "--mesh", DRYRUN_MESH, "--arch", arch, "--cell",
                         cell.name, "--out", out], env=env,
                        stdout=subprocess.DEVNULL, stderr=err), out))
        yield procs, t0
    finally:
        for proc, out in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            shutil.rmtree(out, ignore_errors=True)


def phase_dryrun():
    """The yardstick: qwen2-0.5b at phase train's shape traced on a 1×1
    fake mesh and counted over the real step on the card (FLOPs and
    argument bytes equal).  The dry-run's CLI on a subset of cells runs
    beside the kernels' build (:func:`dryrun_sweep`)."""
    from repro_torch.configs import ShapeCell
    from repro_torch.launch import dryrun, hlo_analysis
    from repro_torch.launch.mesh import MeshShape
    t_phase = time.perf_counter()
    cell = ShapeCell("train_phase", TRAIN_S, TRAIN_B, "train")
    rec = dryrun.lower_cell("qwen2-0.5b", cell,
                            MeshShape(("data", "model"), (1, 1)))
    cfg = preset_config("qwen2-0.5b", "full")
    model = Model(cfg, remat="dots")
    params = model.init(seeded(SEED))
    temper(params)
    opt = adamw_init(params)
    batch = {"tokens": prompts(SEED, TRAIN_B, TRAIN_S,
                               cfg.vocab_size).to(torch.int32)}
    card_args = local_bytes([params, opt.m, opt.v, opt.step, batch])
    step = make_train_step(model, TrainConfig(steps=1000), compress=False)
    with hlo_analysis.OpCounter() as counter:
        step(params, opt, batch, None)
    walls = []
    for _ in range(TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, _, m = step(params, opt, batch, None)
        float(m["loss"])
        walls.append((time.perf_counter() - t0) * 1e3)
    step_ms = float(np.median(walls))
    roof = rec["roofline"]
    bound_s = max(roof["flops"] / hlo_analysis.PEAK_FLOPS,
                  roof["hbm_bytes"] / hlo_analysis.HBM_BW)
    emit("dryrun_yardstick", model="qwen2-0.5b", layers=cfg.num_layers,
         dtype=cfg.param_dtype, seq=TRAIN_S, global_batch=TRAIN_B,
         remat="dots", trace_s=rec["compile_s"],
         model_flops=roof["model_flops"], counted_flops_trace=roof["flops"],
         counted_flops_card=counter.flops, counted_bytes_trace=roof[
             "hbm_bytes"], counted_bytes_card=counter.bytes,
         argument_bytes_trace=rec["memory"]["argument_size_in_bytes"],
         argument_bytes_card=card_args,
         bound_ms=bound_s * 1e3, bound_by="operations" if roof["flops"]
         / hlo_analysis.PEAK_FLOPS >= roof["hbm_bytes"]
         / hlo_analysis.HBM_BW else "bytes", step_ms_median=step_ms,
         step_ms_all=walls, bound_share_of_step=bound_s * 1e3 / step_ms,
         model_flops_share_of_step=roof["model_flops"]
         / hlo_analysis.PEAK_FLOPS * 1e3 / step_ms)
    if roof["flops"] != counter.flops:
        raise AssertionError(f"dry-run FLOPs {roof['flops']} != the card's "
                             f"{counter.flops}")
    if rec["memory"]["argument_size_in_bytes"] != card_args:
        raise AssertionError(f"dry-run argument bytes "
                             f"{rec['memory']['argument_size_in_bytes']} != "
                             f"the card's {card_args}")
    del params, opt, model
    torch.cuda.empty_cache()
    emit("dryrun_summary", seconds=time.perf_counter() - t_phase)


def collect_dryrun_sweep(running) -> None:
    """Wait for :func:`dryrun_sweep`'s subprocesses and report their cells;
    a process that fails or a cell in error fails the run."""
    procs, t0 = running
    t_wait = time.perf_counter()
    records = []
    for proc, out in procs:
        try:
            proc.wait(timeout=max(DRYRUN_TIMEOUT_S - (time.time() - t0), 1.0))
        except subprocess.TimeoutExpired:
            raise AssertionError(f"dry-run sweep: a cell ran past "
                                 f"{DRYRUN_TIMEOUT_S} s") from None
        if proc.returncode != 0:
            stderr = pathlib.Path(out, "stderr.txt").read_text()
            raise AssertionError(f"dry-run sweep failed:\n{stderr[-3000:]}")
        records += sorted(pathlib.Path(out).glob("dryrun_*.json"))
    sweep_s = max(f.stat().st_mtime for f in records) - t0
    cells = []
    for f in records:
        for r in json.loads(f.read_text()):
            if "error" in r:
                raise AssertionError(f"dry-run {r['arch']} {r['cell']}: "
                                     f"{r['error']}\n{r['traceback']}")
            rf = r["roofline"]
            cells.append({
                "arch": r["arch"], "cell": r["cell"], "mesh": r["mesh"],
                "torch": r["torch"], "trace_s": r["compile_s"],
                "gib_a_device": r["memory"]["total_per_device"] / 2**30,
                "t_compute_ms": rf["t_compute"] * 1e3,
                "t_memory_ms": rf["t_memory"] * 1e3,
                "t_collective_ms": rf["t_collective"] * 1e3,
                "coll_bytes": rf["coll_breakdown"],
                "bottleneck": rf["bottleneck"]})
    emit("dryrun_sweep", mesh=DRYRUN_MESH, archs=list(DRYRUN_ARCHS),
         processes=len(procs), seconds=sweep_s, beside="build",
         waited_s=time.perf_counter() - t_wait, cells=cells)


def sweep_alone() -> None:
    with dryrun_sweep() as cells:
        collect_dryrun_sweep(cells)


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--nodes", type=int, default=480,
                   help="dense-urban fleet size (S = 3 * nodes)")
    p.add_argument("--batch", type=int, default=32, help="replicas B")
    p.add_argument("--requests", type=int, default=FULL_REQUESTS // 8,
                   help="n_ai_requests per replica (default: an eighth of "
                        f"the reference bench's {FULL_REQUESTS}, which keeps "
                        "the three run_batch passes near a minute on a slow "
                        "host; S and B are never cut)")
    p.add_argument("--alloc-n", type=int, default=16384,
                   help="node rows of the fleet-wide allocator solve")
    p.add_argument("--haf-requests", type=int, default=700,
                   help="n_ai_requests per replica of phase haf (default: "
                        f"700 of paper_table3's {HAF_FULL_REQUESTS}, which "
                        "keeps the phase near three minutes; S, B and the "
                        "scenario are never cut)")
    p.add_argument("--harvest-bulk", type=int, default=800,
                   help="bulk_requests of the critic's harvest (default "
                        "2500 in the reference)")
    p.add_argument("--harvest-probe", type=int, default=500,
                   help="probe_requests of the critic's harvest (default "
                        "1500 in the reference)")
    p.add_argument("--critic-epochs", type=int, default=2000,
                   help="training epochs of the critic (the reference's "
                        "2000)")
    p.add_argument("--only", choices=("model_kernels", "serve", "train",
                                      "mesh", "dryrun"),
                   help="a rehearsal: phase env, then only this phase (no "
                        "kernels line, no ok line; kernels are built for "
                        "model_kernels, with the build report, serve and "
                        "mesh only)")
    args = p.parse_args()

    # float32 products in full float32 everywhere (the defaults for matmul,
    # not for cuDNN): the parity checks compare float32 lowerings at 1e-4
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    kind = torch.cuda.get_device_name(0)
    emit("env", torch=torch.__version__, cuda=torch.version.cuda,
         device=kind, capability=list(torch.cuda.get_device_capability(0)),
         nvidia_smi=smi)
    if args.only:
        if args.only in ("model_kernels", "serve", "mesh"):
            libs = _build.build_all()
            _build.load()
        if args.only == "model_kernels":
            phase_build(libs)
        {"model_kernels": phase_model_kernels, "serve": phase_serve,
         "train": phase_train, "mesh": phase_mesh,
         "dryrun": lambda: (sweep_alone(), phase_dryrun())}[args.only]()
        print(smi, flush=True)
        return

    t_run = t0 = time.perf_counter()
    # the dry-run sweep needs no card: it runs beside the build, and every
    # timed phase starts after it
    with dryrun_sweep() as cells:
        libs = _build.build_all()
        _build.load()
        emit("build", seconds=time.perf_counter() - t0,
             nvcc=_build.find_nvcc(),
             flags={name: " ".join(_build.nvcc_flags(name))
                    for name in libs},
             libraries=sorted(libs),
             build_dir=os.path.relpath(_build.BUILD_DIR, HERE),
             beside="the dry-run sweep")
        phase_build(libs)
        collect_dryrun_sweep(cells)

    event, alloc = phase_kernels(args)
    model_kernels = phase_model_kernels()
    event_launches = phase_run_batch(args)
    haf_launches, critic = phase_haf(args)
    example_launches = phase_examples(critic)
    eval_launches, serve_launches = phase_eval(critic)
    alloc_launches = phase_allocate_cluster(args)
    served = phase_serve()
    phase_train()
    mesh_launches = phase_mesh()
    phase_dryrun()
    emit("run", seconds=time.perf_counter() - t_run)

    def row(name, rec, launches, replaces, tolerance, path):
        lib_ms = rec.get("library_ms")
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": replaces, "launches": launches,
                "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
                "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
                "bound_by": rec["bound_by"], "library_ms": lib_ms,
                "bound_share": rec["bound_ms"] / rec["ms"],
                "library_ratio": rec["ms"] / lib_ms if lib_ms else None,
                "shape": rec["shape"], "tolerance": tolerance, "path": path}

    mk = model_kernels
    print(json.dumps({"kernels": [
        dict(row("event_step", event,
                 event_launches + haf_launches + example_launches
                 + eval_launches + serve_launches,
                 "src/repro/kernels/event_step.py:34",
                 "bit-for-bit (torch.equal on all five outputs)",
                 "Simulator.run_batch, one launch per tick: HAF-Static on "
                 "dense-urban (phase run_batch), HAF critic-gated on paper "
                 "(phase haf), the sweep harness's HAF group of "
                 "paper_table3 (phase eval, eval.sweep.run_batch_jobs), "
                 "examples/torch/haf_serving.py's static and HAF runs "
                 "(phase examples, one-replica blocks) and the serving "
                 "launcher's solo run (phase eval, a one-replica block)"),
             launches_by_path={"run_batch": event_launches,
                               "haf": haf_launches,
                               "examples": example_launches,
                               "eval": eval_launches,
                               "serve": serve_launches}),
        dict(row("alloc_active_set", alloc, alloc_launches,
                 "src/repro/kernels/alloc_active_set.py:31",
                 "rtol=1e-4, atol=capacity*1e-5 (f32 sums in another order; "
                 "capacity up to 2e14), feasible equal",
                 "allocate_cluster(use_kernel=True), GPU and CPU problem"),
             design_route=alloc["route"], geometry=alloc["geometry"],
             profiler_device_us=alloc["profiler_device_us"],
             device_bound_share=alloc["device_bound_share"],
             wrapper_host_us=alloc["wrapper_host_us"],
             wrapper_host_us_p10=alloc["wrapper_host_us_p10"]),
        dict(row("flash_attention", mk["flash_attention"],
                 sum(served["flash_attention"].values()) + mesh_launches,
                 "src/repro/kernels/flash_attention.py:29",
                 mk["flash_attention"]["tolerance"],
                 "impl='flash' prefills: one launch per causal "
                 "self-attention (qwen2-0.5b and llava per layer, the "
                 "zamba2s per shared-block application under either kernel "
                 "lowering, whisper per decoder layer; "
                 "deepseek's MLA none, as in the reference), and qwen2-0.5b's "
                 "prefill on the 2x2 mesh of phase mesh (each of 4 ranks "
                 "launches on its shard)"),
             launches_by_path={**served["flash_attention"],
                               "mesh_prefill": mesh_launches},
             at_zamba2=mk["flash_attention"]["zamba2"],
             at_llava=mk["flash_attention"]["llava"],
             at_zamba2_7b=mk["flash_attention"]["zamba2_7b"]),
        dict(row("ssd_scan", mk["ssd_scan"], sum(served["ssd_scan"].values()),
                 "src/repro/kernels/ssd_scan.py:25",
                 mk["ssd_scan"]["tolerance"],
                 "impl='pallas' prefills of mamba2-130m, and either kernel "
                 "lowering of the zamba2s: one call per Mamba2 layer"),
             launches_by_path=served["ssd_scan"],
             cuda_launches_per_call=mk["ssd_scan"][
                 "cuda_launches_per_call"],
             at_zamba2=mk["ssd_scan"]["zamba2"],
             at_zamba2_7b=mk["ssd_scan"]["zamba2_7b"]),
        dict(row("rmsnorm", mk["rmsnorm"],
                 sum(served["rmsnorm"].values()),
                 "src/repro/kernels/rmsnorm.py:20",
                 mk["rmsnorm"]["tolerance"],
                 "models.common.rms_norm: every norm of a kernel lowering "
                 "(impl 'flash' / 'pallas'), one launch each (the ragged "
                 "prefill of each served model counted)"),
             launches_by_path=served["rmsnorm"],
             at_llava=mk["rmsnorm"]["llava"]),
        dict(row("causal_conv_silu", mk["causal_conv_silu"],
                 sum(served["causal_conv_silu"].values()),
                 "none: the reference's static shifts "
                 "(src/repro/models/ssm.py:_causal_conv), fused by XLA",
                 mk["causal_conv_silu"]["tolerance"],
                 "models.ssm prefills of a kernel lowering: three launches "
                 "a Mamba2 mixer (x, B and C)"),
             launches_by_path=served["causal_conv_silu"],
             at_bc=mk["causal_conv_silu"]["bc"]),
    ]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
