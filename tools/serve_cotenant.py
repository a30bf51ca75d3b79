"""Phase ``serve`` of ``chip_smoke.py`` alone and beside a dry-run sweep in
a subprocess on one host core, alternated in one process (A B B A A B): does
a co-tenant sweep move the phase's timings?

    python3 tools/serve_cotenant.py [--out FILE]

``A`` runs the phase alone; ``B`` first starts ``python -m
repro_torch.launch.dryrun --mesh single --arch qwen2-0.5b,mamba2-130m``
(``OMP_NUM_THREADS=1``) and waits for it after the phase.  Each run's
timed numbers are kept: every served model's first prefill, the median of
five prefills and the decode ms a step, on the kernel path and on the
composite ``xla`` path, and the phase's seconds.  The last line is one
JSON object: per number, the alone runs' median and spread (max / min) and
the ratio of the runs beside the sweep to the alone runs (median /
median).  Needs one NVIDIA GPU and nvcc.
"""
import argparse
import json
import os
import pathlib
import subprocess
import sys
import tempfile
import time

HERE = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(HERE))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def numbers(rec) -> dict:
    """The timed numbers of one served model's record."""
    return {"prefill_ms": rec["prefill_ms"],
            "prefill_ms_median5": rec["prefill_ms_median5"],
            "decode_ms_per_step": rec["decode_ms_per_step"],
            "xla_prefill_ms_median5": rec["xla"]["prefill_ms_median5"],
            "xla_decode_ms_per_step": rec["xla"]["decode_ms_per_step"]}


SWEEP = ("--mesh", "single", "--arch", "qwen2-0.5b,mamba2-130m")
ORDER = "ABBAAB"


def start_sweep(out: str) -> subprocess.Popen:
    env = dict(os.environ, PYTHONPATH=str(HERE / "src"), OMP_NUM_THREADS="1")
    return subprocess.Popen([sys.executable, "-m", "repro_torch.launch.dryrun",
                             *SWEEP, "--out", out], env=env,
                            stdout=subprocess.DEVNULL)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(HERE / "build" /
                                         "serve_cotenant.json"))
    args = ap.parse_args()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = cs.nvidia_smi_line()
    cs._build.build_all()
    cs._build.load()

    runs = []
    recs = []
    emit = cs.emit

    def keep(phase, **fields):
        if phase == "serve":
            recs.append(fields)
        emit(phase, **fields)
    cs.emit = keep
    for mode in ORDER:
        recs.clear()
        with tempfile.TemporaryDirectory() as out:
            sweep = start_sweep(out) if mode == "B" else None
            t0 = time.perf_counter()
            try:
                cs.phase_serve()
            finally:
                seconds = time.perf_counter() - t0
                if sweep is not None and sweep.wait(timeout=300) != 0:
                    raise SystemExit("the dry-run sweep failed")
        runs.append({"mode": mode, "seconds": seconds,
                     "models": {f"{r['model']}/{r['impl']}": numbers(r)
                                for r in recs}})

    summary = {}
    alone = [r for r in runs if r["mode"] == "A"]
    beside = [r for r in runs if r["mode"] == "B"]
    keys = [(m, k) for m in alone[0]["models"]
            for k in alone[0]["models"][m]]
    for m, k in keys + [("phase", "seconds")]:
        def values(rs):
            return [r["seconds"] if m == "phase" else r["models"][m][k]
                    for r in rs]
        a, b = values(alone), values(beside)
        summary[f"{m} {k}"] = {
            "alone_median": float(np.median(a)),
            "alone_spread": max(a) / min(a),
            "beside_over_alone": float(np.median(b) / np.median(a)) if b
            else None,
            "beside_inside_alone_range": bool(min(a) <= np.median(b)
                                              <= max(a)) if b else None}
    os.makedirs(os.path.dirname(args.out), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"nvidia_smi": smi, "torch": torch.__version__,
                   "order": ORDER, "runs": runs, "summary": summary},
                  f, indent=1)
    print(smi, flush=True)
    print(json.dumps({"order": ORDER, "summary": summary}), flush=True)


if __name__ == "__main__":
    main()
