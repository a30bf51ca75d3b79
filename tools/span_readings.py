"""One traced run of a benchmark cell, read by the port's model-path spans.

    python3 tools/span_readings.py --workload llava.chat --seed 7 \
        [--seconds 30] [--out spans.llava.chat.json]

Runs the cell as ``python3 servebench/run.py --trace 1`` does (the same
set-up, window, traced first pass and check), then reads the ``repro.*``
spans of the traced pass through the profiler's launch links
(``servebench/core/spans.py``) and prints one JSON object: the run's own
result (its per-layer metrics and breakdown), the six span readings
(``rms_norm.us_per_token``, ``rope.us_per_token``,
``mlp_gate.us_per_token``, ``prefill.idle_share``, ``layer.launches``, and
``rms_norm.kernel_share``: the ``rmsnorm`` kernel's share of the norms'
device records, at least one a norm; for a Mamba2 model also
``ssm.conv.kernel_share``, the ``causal_conv_silu`` kernel's share of the
``repro.ssm.conv`` spans' records), ``idle_by_span`` and
``device_by_span``, the breakdown the harness gives with the spans kept
out of its host records, and each span's device
seconds split as the readers split kernels (GEMM, the port's kernels, the
rest), with the sums that check them against ``other_kernels.us_per_token``
and the busy seconds.  Where the cell runs a hybrid's Mamba2 mixers and
shared blocks it also reads ``ssm.us_per_token``, ``ssm.conv.us_per_token``,
``ssm.scan.us_per_token`` and ``shared.us_per_token`` (device µs a prompt
position of every record launched inside a ``repro.ssm``, a
``repro.ssm.conv``, an SSD scan's or a ``repro.shared`` span, at any depth)
and ``ssm.whole_scans`` (the scans a prefill that ran as one chunk of the
whole prompt, under ``repro.ssm.scan.whole``).  Needs the card.
"""
import argparse
import json
import os
import sys
from typing import Optional

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TRITON_CACHE_DIR", "triton")):
    os.environ[var] = os.path.join(ROOT, "build", "servebench", sub)

import torch  # noqa: E402

from servebench.core import cli, spans, spec, trace as tr  # noqa: E402


def traced_run(cell, seed: int, seconds: float):
    """``cli.run_cell`` traced, keeping the profile's spans and the view
    the readers read."""
    kept = {}
    tr_tracer, tr_view = tr.Tracer, tr.view

    class Tracer(tr_tracer):
        def records(self):
            kept["spans"] = spans.collect(
                self.prof.profiler.kineto_results.events())
            return super().records()

    def view(*args, **kwargs):
        kept["view"] = tr_view(*args, **kwargs)
        return kept["view"]

    tr.Tracer, tr.view = Tracer, view
    try:
        result, _ = cli.run_cell(cell, seed, seconds, True,
                                 torch.device("cuda", 0))
    finally:
        tr.Tracer, tr.view = tr_tracer, tr_view
    return result, kept["spans"], kept["view"]


def by_kind(st: spans.SpanTrace) -> dict:
    """Each span's device seconds and records, split as the readers split
    kernels by name."""
    gemm = spec.load_reader("gemm.peak_share").PATTERN
    not_other = spec.load_reader("other_kernels.us_per_token").NOT_OTHER
    kinds = {"gemm": lambda n: bool(gemm.search(n)),
             "port": lambda n: bool(not_other.search(n)
                                    and not gemm.search(n)),
             "other": lambda n: not not_other.search(n)}
    out = {}
    for kind, keep in kinds.items():
        seconds, counts = st.device_by_span(keep)
        for name in seconds:
            row = out.setdefault(name, {})
            row[f"{kind}_s"] = seconds[name]
            row["records"] = row.get("records", 0) + counts[name]
    return out


def kernel_share(st: spans.SpanTrace, span: str = "repro.rms_norm",
                 kernel: str = "rmsnorm") -> Optional[float]:
    """The ``kernel`` records (by name) among the device records that the
    ``span`` spans launched in the window (``device_by_span``'s
    attribution), counted over at least one a span: 1.0 where each norm is
    one launch of the kernel alone, 0 where the norms run as eager ops.
    None where those spans launched nothing in the window."""
    _, mine = st.device_by_span(lambda name: kernel in name)
    _, every = st.device_by_span()
    if not every.get(span):
        return None
    norms = sum(s[0] == span for s in st.spans)
    return mine.get(span, 0) / max(every[span], norms)


# each reading of kernel_share: (the span, a part of its kernel's name)
KERNEL_SHARES = {"rms_norm.kernel_share": ("repro.rms_norm", "rmsnorm"),
                 "ssm.conv.kernel_share": ("repro.ssm.conv",
                                           "causal_conv_silu")}


# inclusive readings: every device record launched inside the span, at
# any depth, a prompt position
INCLUSIVE = {"ssm.us_per_token": ("repro.ssm",),
             "ssm.conv.us_per_token": ("repro.ssm.conv",),
             "ssm.scan.us_per_token": ("repro.ssm.scan",
                                       "repro.ssm.scan.whole"),
             "shared.us_per_token": ("repro.shared",)}
WHOLE_SCAN = "repro.ssm.scan.whole"


def hybrid_readings(st: spans.SpanTrace, positions: int) -> dict:
    """The hybrid's readings (see the module docstring); none where its
    spans launched nothing in the window."""
    chains = st.chains()
    seconds = dict.fromkeys(INCLUSIVE, 0.0)
    for i, s, e in st._in_window():
        for metric, names in INCLUSIVE.items():
            if any(n in chains[i] for n in names):
                seconds[metric] += (e - s) * 1e-9
    out = {m: 1e6 * v / positions for m, v in seconds.items()
           if v > 0 and positions}
    prefills = sum(s[0] == spans.PREFILL for s in st.spans)
    if out and prefills:
        out["ssm.whole_scans"] = sum(s[0] == WHOLE_SCAN
                                     for s in st.spans) / prefills
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=30.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_readings: needs the card", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    result, st, view = traced_run(cell, args.seed, args.seconds)
    rows = by_kind(st)
    other_s = sum(r.get("other_s", 0.0) for r in rows.values())
    readings = spans.readings(st, view.positions)
    for name, (span, kernel) in KERNEL_SHARES.items():
        share = kernel_share(st, span, kernel)
        if share is not None:
            readings[name] = share
    readings.update(hybrid_readings(st, view.positions))
    out = {
        "workload": args.workload, "seed": args.seed,
        "correct": result["correct"], "device": result["device"],
        "metrics": result["metrics"],
        "spans": readings,
        "breakdown": {**result["breakdown"], **spans.breakdown(st)},
        "breakdown_without_spans": tr.breakdown(st.records),
        "by_span": rows,
        "check": {
            "positions": view.positions,
            "other_us_per_token_by_spans": 1e6 * other_s / view.positions,
            "device_s_by_spans": sum(st.device_by_span()[0].values()),
            "busy_s": view.busy_s},
    }
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
