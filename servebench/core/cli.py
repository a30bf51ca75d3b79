"""One run of one cell: set-up, the measured window, the per-layer reading
of a traced run, and the check against the reference.

    python3 servebench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The last line of standard output is the result as one JSON object; the
numbers the check compared, each beside its limit, are the last lines of
standard error and the last key of the result.  A run exits non-zero and
prints no result when the card is missing or too few cards are present, or
when JAX or the JAX package is loaded.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from servebench.core import guard, spec, trace as tr
from servebench.core.check import Judge, verdict
from servebench.core.counting import peaks
from servebench.core.traffic import Call, calls, first_pass, text_lengths
from servebench.core.weights import make_batch, make_params
from servebench.core.window import first_tokens, reserve, serve
from servebench.reference.plain import exact_float32

GIB = 2 ** 30


def process_start() -> float:
    """The process's start on the wall clock, from /proc (10 ms ticks)."""
    with open("/proc/self/stat") as f:
        ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        boot = next(int(line.split()[1]) for line in f
                    if line.startswith("btime"))
    return boot + ticks / os.sysconf("SC_CLK_TCK")


def log(message: str) -> None:
    print(f"servebench: {message}", file=sys.stderr, flush=True)


def sub_seed(seed: int, purpose: int) -> int:
    """A 63-bit seed of its own for each use of the run's seed."""
    state = np.random.SeedSequence([seed % 2 ** 64, purpose]).generate_state(2)
    return int(state[0]) << 31 ^ int(state[1])


WEIGHTS, PROMPTS = 2, 3     # sub_seed purposes (the order of passes: 1)


def sample(cell: spec.Cell, prefix: int, seed: int) -> List[int]:
    """Indices of the first pass's calls that the check keeps, by their
    rank in length (``"longest"``, ``"shortest"``, ``"median"``)."""
    first = first_pass(cell.traffic, prefix, seed)
    ranked = sorted(first, key=lambda c: (c.text, c.index))
    pick = {"longest": ranked[-1], "shortest": ranked[0],
            "median": ranked[len(ranked) // 2]}
    return sorted({pick[name].index for name in cell.checks["sample"]})


def percentile(values: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device: torch.device, numbers: Optional[Dict] = None,
             started: Optional[float] = None) -> Tuple[dict, List[dict]]:
    """One run on ``device``; returns (the result, the check's verdicts).
    ``numbers`` (tests only) replaces the configuration's sizes;
    ``started`` is when the process started (default: now)."""
    from repro_torch.models.api import build_model
    started = time.time() if started is None else started
    on_card = device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    sizes = numbers or cell.numbers
    cfg = spec.port_config(cell.config, numbers)
    entered = time.time()
    model = build_model(cfg, impl=cell.config["impl"], device=device)
    built = time.time()
    dtype = getattr(torch, cell.config["dtype"])
    params = make_params(model.param_defs(), sub_seed(seed, WEIGHTS), dtype,
                         device)
    sync()
    prefix = sizes.get("num_patches", 0)
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, PROMPTS))
    rows = cell.traffic["rows"]

    def make(call: Call) -> dict:
        return make_batch(gen, call.rows, call.text, call.prefix,
                          sizes["vocab_size"], sizes["d_model"], dtype,
                          device)

    made = time.time()
    # warm-up: one call of every length the traffic sends, through the
    # window's own path (cuBLAS picks a kernel a shape, and CUDA loads each
    # kernel's module at its first use)
    with torch.inference_mode():
        for text in sorted(set(text_lengths(cell.traffic, prefix))):
            first_tokens(model, params, make(Call(-1, rows, text, prefix)))
    setup_s = time.time() - started
    log(f"setup {setup_s:.2f} s: to the harness {entered - started:.2f} s, "
        f"model (device) {built - entered:.2f} s, weights "
        f"{made - built:.2f} s, warm-up {time.time() - made:.2f} s")

    keep = set(sample(cell, prefix, seed))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    tracer = tr.Tracer() if traced else None
    per_pass = cell.traffic["per_pass"]
    win = serve(model, params, calls(cell.traffic, prefix, seed), make,
                seconds, keep, sync, per_pass, tracer)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    log(f"window {win.seconds:.2f} s, {len(win.served)} calls")

    requests = sum(s.call.rows for s in win.served)
    failed = sum(s.call.rows - int(s.host[1].sum()) for s in win.served)
    ref = cell.reference()
    kind = torch.cuda.get_device_name(device) if on_card else "cpu"
    result = {"correct": False, "attempted": requests, "failed": failed}
    if traced:
        t = time.time()
        records = tracer.records()
        view = tr.view(records, [s.call for s in win.traced],
                       lambda r, s: ref.work(sizes, r, s),
                       peaks(kind) if on_card else {})
        metrics = {}
        for m in cell.per_layer:
            value = spec.load_reader(m["name"]).read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value),
                                      "unit": m["unit"]}
        device_info = {"busy_s": view.busy_s, "window_s": view.window_s}
        extra = {"breakdown": tr.breakdown(records)}
        log(f"trace read in {time.time() - t:.2f} s, "
            f"{len(records.device)} device records")
        del records, view
    else:
        ttft = [(s.end - s.start) * 1e3 for s in win.served
                for _ in range(s.call.rows)]
        values = {
            "prefill_tokens_per_s": sum(s.call.rows * s.call.positions
                                        for s in win.served) / win.seconds,
            "ttft_p95_ms": percentile(ttft, 95),
            "peak_mem_gib": peak / GIB,
            "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]),
                               "unit": m["unit"]} for m in cell.end_to_end}
        device_info, extra = {}, {}
    result["metrics"] = metrics
    result["device"] = {"platform": "gpu" if on_card else "cpu",
                        "kind": kind, "count": 1,
                        "memory_peak_bytes": peak, **device_info}
    result.update(extra)

    # the check, once the peak is read: each kept call's cache served again
    # on the same model, then the reference over its prompts; the window's
    # logits and that cache judged, and freed before the next call
    kept = [win.kept[i] for i in sorted(keep)]
    del win, tracer
    judge = Judge(cell.config["cache"])
    t = time.time()
    for k in kept:
        batch, cache = reserve(model, params, k, device)
        with exact_float32(), torch.inference_mode():
            got = ref.prefill(params, batch, sizes,
                              on_cache=judge.cache_hook(cache))
        judge.logits(k.logits.to(got.device), got)
        del batch, cache, got
    log(f"check {time.time() - t:.2f} s, {len(kept)} calls")
    verdicts = verdict(judge.numbers(), cell.checks["limits"])
    result["correct"] = failed == 0 and all(v["ok"] for v in verdicts)
    result["check"] = {v["name"]: {"value": _json_number(v["value"]),
                                   "limit": v["limit"]} for v in verdicts}
    return result, verdicts


def check_lines(verdicts: List[dict]) -> List[str]:
    """One line a compared number: its name, value, limit and verdict."""
    return [f"check {v['name']} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['ok'] else 'FAIL'}" for v in verdicts]


def _json_number(x):
    return float(x) if x is not None and math.isfinite(x) else None


def parse(argv=None) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(message: str, code: int) -> int:
    log(message)
    return code


def main(argv=None) -> int:
    started = process_start()
    log(f"imports {time.time() - started:.2f} s after the process started")
    args = parse(argv)
    bad = guard.reference_violations(spec.ROOT)
    if bad:
        return fail(f"a reference imports the program or JAX: {bad}", 3)
    cell = spec.load_cell(args.workload)
    import repro_torch.models.api  # noqa: F401  (the program, loaded here)
    found = guard.loaded()
    if found:
        return fail(f"loaded at the start: {found} (the benchmark and the "
                    f"port may not load JAX or the JAX package)", 3)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only", 2)
    if torch.cuda.device_count() < cell.chips:
        return fail(f"{args.workload} needs {cell.chips} cards, "
                    f"{torch.cuda.device_count()} present", 2)
    result, verdicts = run_cell(cell, args.seed, args.seconds,
                                bool(args.trace), torch.device("cuda", 0),
                                started=started)
    found = guard.loaded()
    if found:
        return fail(f"loaded after the window: {found} (the benchmark and "
                    f"the port may not load JAX or the JAX package)", 3)
    print("\n".join(check_lines(verdicts)), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0
