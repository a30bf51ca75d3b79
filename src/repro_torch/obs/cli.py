"""``python -m repro_torch.obs`` — summarize or convert a trace file.

Subcommands:

  summary <trace.jsonl>            per-kind / per-replica event counts,
                                   decision ledger (predicted vs realized)
  chrome  <trace.jsonl> [-o OUT]   re-export a JSONL trace as Chrome
                                   ``trace_event`` JSON for Perfetto
  timeseries <report.json> [...]   print the gauge time series embedded
                                   in a ``repro_torch.eval`` report row
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
from typing import List, Optional

from repro_torch.obs.metrics import slack_edge_labels
from repro_torch.obs.trace import load_jsonl


def _fmt_pct(x) -> str:
    return "-" if x is None else f"{100.0 * x:5.1f}%"


def cmd_summary(args) -> int:
    data = load_jsonl(args.trace)
    header, events, decisions = (data["header"], data["events"],
                                 data["decisions"])
    counts = header.get("counts", {})
    print(f"trace: {args.trace}")
    print(f"records written: {header.get('n_written', len(events))} "
          f"(ring-dropped: {header.get('n_dropped', 0)})")
    print("event totals (exact, ring-wrap safe):")
    for kind, n in sorted(counts.items()):
        print(f"  {kind:<12} {n}")
    replicas = sorted({e["b"] for e in events}) if events else []
    if len(replicas) > 1:
        print(f"replicas: {len(replicas)} "
              f"(b = {replicas[0]}..{replicas[-1]})")
    if decisions:
        print(f"\ndecisions ({len(decisions)}):")
        committed = [d for d in decisions if d.get("committed")]
        vetoed = [d for d in decisions if not d.get("committed")]
        print(f"  committed: {len(committed)}  vetoed: {len(vetoed)}")
        for d in decisions[: args.limit]:
            pred = d.get("predicted_margin")
            real = d.get("realized_fulfill")
            pred_s = "-" if pred is None else f"{pred:+.4f}"
            real_s = "-" if real is None else f"{real:.4f}"
            print(f"  [b={d.get('b', 0)}] epoch {d.get('epoch')}"
                  f" t={d.get('t', 0.0):.3f}"
                  f" action={d.get('action')}"
                  f" committed={d.get('committed')}"
                  f" predicted_margin={pred_s}"
                  f" realized_fulfill={real_s}")
        if len(decisions) > args.limit:
            print(f"  ... {len(decisions) - args.limit} more "
                  f"(raise --limit)")
    return 0


def cmd_chrome(args) -> int:
    data = load_jsonl(args.trace)
    events = []
    for rec in data["events"]:
        rec = dict(rec)
        kind = rec.pop("kind")
        events.append({"name": kind, "ph": "i", "s": "t",
                       "ts": float(rec.pop("t", 0.0)) * 1e6,
                       "pid": rec.pop("b", 0), "tid": kind, "args": rec})
    for d in data["decisions"]:
        d = dict(d)
        d.pop("kind", None)
        events.append({"name": "decision", "ph": "i", "s": "t",
                       "ts": float(d.pop("t", 0.0)) * 1e6,
                       "pid": d.pop("b", 0), "tid": "decision", "args": d})
    out = pathlib.Path(args.out or
                       pathlib.Path(args.trace).with_suffix(".chrome.json"))
    out.write_text(json.dumps({"traceEvents": events,
                               "displayTimeUnit": "ms"}))
    print(f"wrote {out} ({len(events)} events) — open in chrome://tracing "
          f"or https://ui.perfetto.dev")
    return 0


def cmd_timeseries(args) -> int:
    doc = json.loads(pathlib.Path(args.report).read_text())
    rows = doc.get("rows", doc if isinstance(doc, list) else [])
    shown = 0
    for row in rows:
        ts = row.get("timeseries")
        if not ts:
            continue
        label = (f"{row.get('method', '?')} / {row.get('scenario', '?')} "
                 f"seed={row.get('seed', '?')}")
        if args.grep and args.grep not in label:
            continue
        shown += 1
        print(f"== {label} ({len(ts)} samples, "
              f"interval from t={ts[0]['t']:.2f} to t={ts[-1]['t']:.2f}) ==")
        print(f"  slack bins: {', '.join(slack_edge_labels())}")
        for s in ts[: args.limit]:
            util = s.get("util_gpu", [])
            mean_util = sum(util) / len(util) if util else 0.0
            slo = s.get("slo", {})
            print(f"  t={s['t']:8.2f}  gpu_util={mean_util:5.3f}"
                  f"  depth={s.get('queue_depth', 0):4d}"
                  f"  slack={s.get('slack_hist')}"
                  f"  slo: ran={_fmt_pct(slo.get('ran'))}"
                  f" large={_fmt_pct(slo.get('large_ai'))}"
                  f" small={_fmt_pct(slo.get('small_ai'))}")
        if len(ts) > args.limit:
            print(f"  ... {len(ts) - args.limit} more samples")
        if args.max_rows and shown >= args.max_rows:
            break
    if not shown:
        print("no rows with a `timeseries` field "
              "(rerun with --metrics-interval > 0)")
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m repro_torch.obs", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="summarize a JSONL trace")
    s.add_argument("trace")
    s.add_argument("--limit", type=int, default=20,
                   help="max decisions to list (default 20)")
    s.set_defaults(fn=cmd_summary)

    c = sub.add_parser("chrome", help="convert JSONL trace to Chrome format")
    c.add_argument("trace")
    c.add_argument("-o", "--out", default=None)
    c.set_defaults(fn=cmd_chrome)

    t = sub.add_parser("timeseries",
                       help="print gauge series from an eval report")
    t.add_argument("report")
    t.add_argument("--limit", type=int, default=10,
                   help="max samples per row (default 10)")
    t.add_argument("--max-rows", type=int, default=0,
                   help="stop after this many rows (0 = all)")
    t.add_argument("--grep", default="",
                   help="only rows whose method/scenario label contains this")
    t.set_defaults(fn=cmd_timeseries)
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
