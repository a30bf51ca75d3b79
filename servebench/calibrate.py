"""Readings from which the check's limits are set (PERF.md), on the card.

    python3 servebench/calibrate.py --workload llava.longdoc \
        --seeds 1,2,3 [--control]

For each seed, one run of the cell through the harness's own path with a
window of 0.1 s: the first pass is served up to the calls the check keeps,
which are judged against the float32 reference as in every run.  With
``--control`` the program is replaced by the control (the reference in
float8, servebench/core/control.py).  Each seed's numbers are printed as a
JSON line and appended to build/servebench/calibrate-<workload>.jsonl.
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0:1] = [ROOT, os.path.join(ROOT, "src")]

import torch  # noqa: E402

from servebench.core import cli, spec  # noqa: E402
from servebench.core.control import Control  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch.models.api as api
    if args.control:
        build = api.build_model

        def control(cfg, impl="xla", device=None, remat="dots"):
            return Control(build(cfg, impl=impl, device=device),
                           cell.reference(), cell.numbers,
                           cell.config["cache"])
        api.build_model = control
    out = os.path.join(ROOT, "build", "servebench",
                       f"calibrate-{args.workload}.jsonl")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.time()
        result, verdicts = cli.run_cell(cell, seed, 0.1, False,
                                        torch.device("cuda", 0))
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "control": args.control,
                           "correct": result["correct"],
                           "numbers": {v["name"]: v["value"]
                                       for v in verdicts},
                           "seconds": time.time() - t})
        print(line, flush=True)
        with open(out, "a") as f:
            f.write(line + "\n")
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
