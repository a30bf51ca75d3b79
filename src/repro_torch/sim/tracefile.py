"""Cluster-trace replay: bounded-memory CSV/JSONL arrival streams.

The ``trace`` scenario family replays a real (or synthesized) request
trace instead of the synthetic Poisson generator.  A trace file is a CSV
or JSONL sequence of rows, sorted by arrival time:

====================  =========================================================
column                meaning
====================  =========================================================
``arrival``           arrival time [s], **nondecreasing** (validated)
``cls``               service class label; mapped to ``large``/``small`` via
                      the recipe's ``class_map`` (identity by default)
``prompt_tokens``     prompt length [tokens]
``output_tokens``     response length [tokens]
``cell``              (optional) originating cell id; drawn uniformly if absent
``deadline``          (optional) relative deadline [s]; drawn from the class's
                      default range if absent
====================  =========================================================

Replay is two-pass and never holds more than a chunk of rows:
:func:`trace_metadata` scans once for (n_rows, horizon) and validates the
sort, then the stream's ``chunks()`` passes parse chunk-by-chunk.  All
randomness (model pick, KV draw, missing cells/deadlines) comes from one
seeded generator consumed in row order — the realization depends only on
(file, seed, row limit), never on chunk size.

``speedup`` divides arrival times (replay a day-scale trace in
simulation minutes); ``class_map`` is a compact string
(``"chat=small,batch=large"``).  A small synthetic trace writer plus a
CLI (``python -m repro_torch.sim.tracefile``) generates checked-in flagship
traces without committing real cluster data.
"""
from __future__ import annotations

import csv
import json
import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from repro_torch.sim.stream import ArrivalStream
from repro_torch.sim.types import Request, RequestClass
from repro_torch.sim.workload import ServiceWorkModel, WorkloadConfig

_TRACE_STREAM = 0x545243      # rng stream tag ("TRC")
PARSE_CHUNK = 4096

_FIELDS = ("arrival", "cls", "prompt_tokens", "output_tokens")


def parse_class_map(text: str) -> Dict[str, str]:
    """``"chat=small,batch=large"`` → {"chat": "small", "batch": "large"}."""
    out: Dict[str, str] = {}
    for part in (text or "").split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"class_map entry {part!r} is not 'label=class'")
        k, v = (s.strip() for s in part.split("=", 1))
        if v not in ("large", "small"):
            raise ValueError(
                f"class_map target {v!r} must be 'large' or 'small'")
        out[k] = v
    return out


def _iter_rows(path: str) -> Iterator[Dict]:
    """Stream raw rows from a CSV or JSONL trace (O(1) rows in memory)."""
    if path.endswith((".jsonl", ".ndjson")):
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if line:
                    yield json.loads(line)
    else:
        with open(path, newline="") as fh:
            yield from csv.DictReader(fh)


def read_trace_chunks(path: str, chunk: int = PARSE_CHUNK,
                      limit: Optional[int] = None
                      ) -> Iterator[List[Dict]]:
    """Parsed trace rows in chunks; numeric fields coerced, sort intact."""
    buf: List[Dict] = []
    n = 0
    for raw in _iter_rows(path):
        row = {"arrival": float(raw["arrival"]),
               "cls": str(raw["cls"]),
               "prompt_tokens": int(float(raw["prompt_tokens"])),
               "output_tokens": int(float(raw["output_tokens"]))}
        cell = raw.get("cell")
        if cell not in (None, ""):
            row["cell"] = int(float(cell))
        deadline = raw.get("deadline")
        if deadline not in (None, ""):
            row["deadline"] = float(deadline)
        buf.append(row)
        n += 1
        if limit is not None and n >= limit:
            break
        if len(buf) >= chunk:
            yield buf
            buf = []
    if buf:
        yield buf


def trace_metadata(path: str, limit: Optional[int] = None
                   ) -> Tuple[int, float]:
    """One bounded-memory pass: (n_rows, horizon); validates the sort."""
    n = 0
    last = -np.inf
    for chunk in read_trace_chunks(path, limit=limit):
        for row in chunk:
            a = row["arrival"]
            if a < last:
                raise ValueError(
                    f"{path}: arrivals not sorted at row {n} "
                    f"({a} < {last})")
            last = a
            n += 1
    return n, (float(last) if n else 0.0)


def trace_stream(spec: Dict, work_models: Dict[str, List[ServiceWorkModel]],
                 seed: int = 0, n_requests: Optional[int] = None
                 ) -> ArrivalStream:
    """An :class:`ArrivalStream` replaying the trace recipe ``spec``.

    ``spec`` keys: ``file`` (empty = the built-in synthetic diurnal
    trace, deterministic in ``seed``), ``speedup`` (divides arrivals),
    ``class_map``, ``n_cells``.  ``n_requests`` caps the replayed rows
    (a prefix — useful for smoke runs over a large trace).
    """
    path = spec.get("file") or ""
    if path and not os.path.exists(path):
        raise FileNotFoundError(f"trace file not found: {path}")
    speedup = float(spec.get("speedup", 1.0))
    if speedup <= 0:
        raise ValueError(f"speedup must be > 0 (got {speedup})")
    cmap = spec.get("class_map") or ""
    cmap = parse_class_map(cmap) if isinstance(cmap, str) else dict(cmap)
    n_cells = int(spec.get("n_cells", WorkloadConfig.n_cells))
    limit = int(n_requests) if n_requests else None
    defaults = WorkloadConfig()

    if path:
        def rows_factory() -> Iterator[List[Dict]]:
            return read_trace_chunks(path, limit=limit)
        n_rows, raw_horizon = trace_metadata(path, limit=limit)
        source = path
    else:
        n_synth = limit or _SYNTH_DEFAULT_N

        def rows_factory() -> Iterator[List[Dict]]:
            return synthetic_row_chunks(n_synth, seed=seed)
        n_rows, raw_horizon = 0, 0.0
        for rows in rows_factory():           # metadata pass (chunked)
            n_rows += len(rows)
            raw_horizon = rows[-1]["arrival"]
        source = f"<synthetic n={n_synth} seed={seed}>"
    horizon = raw_horizon / speedup
    info = {"horizon": horizon, "n_requests": n_rows, "source": source,
            "speedup": speedup,
            "lambda_ai": (n_rows / horizon if horizon > 0 else 0.0),
            "lambda_ran": 0.0}

    def factory() -> Iterator[List[Request]]:
        rng = np.random.default_rng([seed, _TRACE_STREAM])
        rid = 0
        for rows in rows_factory():
            out: List[Request] = []
            for row in rows:
                label = cmap.get(row["cls"], row["cls"])
                if label not in ("large", "small"):
                    raise ValueError(
                        f"trace class {row['cls']!r} maps to {label!r}; "
                        "extend class_map to cover it")
                models = work_models[label]
                model = models[rng.integers(len(models))]
                flops, cpu, kv = model.work(
                    rng, row["prompt_tokens"], row["output_tokens"])
                cell = row.get("cell")
                if cell is None:
                    cell = int(rng.integers(0, n_cells))
                deadline = row.get("deadline")
                if deadline is None:
                    rng_range = (defaults.large_deadline if label == "large"
                                 else defaults.small_deadline)
                    deadline = float(rng.uniform(*rng_range))
                out.append(Request(
                    rid=rid,
                    cls=(RequestClass.LARGE_AI if label == "large"
                         else RequestClass.SMALL_AI),
                    arrival=row["arrival"] / speedup, deadline=deadline,
                    cell=cell % n_cells, ai_work_g=flops, ai_work_c=cpu,
                    kv_bytes=kv, service=model.arch))
                rid += 1
            yield out
    return ArrivalStream(factory, horizon=horizon, n_requests=n_rows,
                         info=info)


# --------------------------------------------------------------------------- #
# synthetic trace generation (flagship experiments ship a generator, not
# data; the trace family with file="" replays these rows directly)
# --------------------------------------------------------------------------- #
_SYNTH_DEFAULT_N = 2000


def synthetic_row_chunks(n_requests: int, seed: int = 0,
                         duration: float = 600.0,
                         large_fraction: float = 0.35,
                         diurnal_depth: float = 0.7,
                         n_cells: int = 6,
                         chunk: int = 8192) -> Iterator[List[Dict]]:
    """Diurnal-modulated synthetic trace rows, chunked and vectorized.

    Arrivals are an inhomogeneous Poisson process (sinusoidal intensity
    over one ``duration``-long period, via time rescaling); lengths are
    lognormal per class.  O(chunk) memory, so 10^6-row traces generate
    in seconds.  Deterministic in (n_requests, seed, params).
    """
    from repro_torch.sim.workload import (LARGE_OUTPUT, LARGE_PROMPT, SMALL_OUTPUT,
                                    SMALL_PROMPT, _lognormal_len)
    rng = np.random.default_rng([seed, _TRACE_STREAM, 0x57])
    lam = n_requests / duration
    # Λ⁻¹ map for m(t) = 1 + depth·sin(2πt/duration), normalized Λ(H)=H
    ts = np.linspace(0.0, duration, 4097)
    m = np.maximum(1.0 + diurnal_depth * np.sin(2 * np.pi * ts / duration),
                   0.05)
    lam_cum = np.concatenate(
        [[0.0], np.cumsum(0.5 * (m[1:] + m[:-1]) * np.diff(ts))])
    lam_cum *= duration / lam_cum[-1]

    t = 0.0
    written = 0
    while written < n_requests:
        c = min(chunk, n_requests - written)
        a = t + np.cumsum(rng.exponential(1.0 / lam, c))
        t = float(a[-1])
        warped = np.interp(a, lam_cum, ts)
        tail = a >= lam_cum[-1]
        warped[tail] = duration + (a[tail] - lam_cum[-1])
        large = rng.random(c) < large_fraction
        lp = _lognormal_len(rng, *LARGE_PROMPT, c)
        lo = _lognormal_len(rng, *LARGE_OUTPUT, c)
        sp = _lognormal_len(rng, *SMALL_PROMPT, c)
        so = _lognormal_len(rng, *SMALL_OUTPUT, c)
        prompts = np.where(large, lp, sp)
        outputs = np.where(large, lo, so)
        cells = rng.integers(0, n_cells, c)
        # rounding is monotone, so the written arrivals stay sorted
        yield [{"arrival": round(float(warped[i]), 6),
                "cls": "large" if large[i] else "small",
                "prompt_tokens": int(prompts[i]),
                "output_tokens": int(outputs[i]),
                "cell": int(cells[i])} for i in range(c)]
        written += c


def write_synthetic_trace(path: str, n_requests: int, seed: int = 0,
                          duration: float = 600.0,
                          large_fraction: float = 0.35,
                          diurnal_depth: float = 0.7,
                          n_cells: int = 6,
                          chunk: int = 8192) -> str:
    """Write :func:`synthetic_row_chunks` as CSV or JSONL (by suffix)."""
    jsonl = path.endswith((".jsonl", ".ndjson"))
    with open(path, "w", newline="") as fh:
        writer = None
        if not jsonl:
            writer = csv.writer(fh)
            writer.writerow(_FIELDS + ("cell",))
        for rows in synthetic_row_chunks(
                n_requests, seed=seed, duration=duration,
                large_fraction=large_fraction, diurnal_depth=diurnal_depth,
                n_cells=n_cells, chunk=chunk):
            if jsonl:
                for row in rows:
                    fh.write(json.dumps(row) + "\n")
            else:
                writer.writerows(
                    (row["arrival"], row["cls"], row["prompt_tokens"],
                     row["output_tokens"], row["cell"]) for row in rows)
    return path


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    p = argparse.ArgumentParser(
        description="write a synthetic diurnal trace file (CSV/JSONL)")
    p.add_argument("path", help="output file (.csv, .jsonl)")
    p.add_argument("--n", type=int, default=2000, help="number of requests")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration", type=float, default=600.0,
                   help="trace duration [s] (one diurnal period)")
    p.add_argument("--large-fraction", type=float, default=0.35)
    p.add_argument("--depth", type=float, default=0.7,
                   help="diurnal modulation depth")
    args = p.parse_args(argv)
    write_synthetic_trace(args.path, args.n, seed=args.seed,
                          duration=args.duration,
                          large_fraction=args.large_fraction,
                          diurnal_depth=args.depth)
    n, horizon = trace_metadata(args.path)
    print(f"wrote {n} rows to {args.path} (horizon {horizon:.1f}s)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
