"""Declarative experiment demo on the port: spec grammar, provenance,
resume.

Declares a fleet sweep (two placement policies over three generated
scenarios × two workload seeds) as a :class:`repro_torch.exp.ExperimentSpec`
— methods and scenarios in the spec grammar — writes it to a TOML file,
runs it through the provenance-stamped harness (the ``cuda`` engine on the
card; the eager ``torch`` engine on the host with ``--device cpu``), then
runs it AGAIN to show resume: every completed row is reused from the
report on disk.

  PYTHONPATH=src python examples/torch/scenario_sweep.py [--out DIR]
"""
from __future__ import annotations

import argparse
import pathlib

from repro_torch.eval import format_table
from repro_torch.exp import ExperimentSpec, run_experiment
from repro_torch.models.api import resolve_device
from repro_torch.sim.scenarios import make_scenario, scenario_fingerprint

ART = pathlib.Path(__file__).resolve().parents[2] / "artifacts"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(ART),
                    help="directory of the spec file and the report")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    out = out_dir / "scenario_sweep_demo.json"
    spec_file = out_dir / "scenario_sweep_demo.toml"

    # 1) scenarios are data: inspect one before running anything
    sc = make_scenario("flash-crowd", seed=0, magnitude=6.0)
    print(f"flash-crowd: {len(sc['nodes'])} nodes, "
          f"{len(sc['instances'])} instances, "
          f"spike windows={sc['workload']['arrival']['windows']}")
    print(f"fingerprint: {scenario_fingerprint(sc)[:16]}... "
          f"(same seed -> same fingerprint)")

    # 2) experiments are data too: the whole sweep in one spec, with the
    #    method/scenario grammar every frontend shares
    spec = ExperimentSpec(
        name="scenario-sweep-demo",
        methods=("haf-static", "round-robin"),
        scenarios=("flash-crowd(magnitude=6.0)",
                   "node-outage",
                   "dense-urban(n_nodes=12)"),
        seeds=(0, 1),
        n_ai_requests=400,          # demo-sized; drop for the real run
        workers=2,
        engine="cuda" if dev.type == "cuda" else "torch",
        out=str(out))
    spec.to_file(spec_file)         # checked-in form: --spec runs it too
    print(f"spec -> {spec_file}  (spec_hash={spec.spec_hash()[:12]}, "
          f"run it with: python -m repro_torch.eval --spec {spec_file})")

    # 3) run it (the report embeds the canonical spec, its hashes,
    #    per-cell scenario fingerprints and backend info)
    out.unlink(missing_ok=True)
    first = run_experiment(spec, verbose=True, device=str(dev))
    print(format_table(first["aggregate"]))
    print(f"report -> {out}")

    # 4) run it AGAIN: the resume key matches, every row is reused
    again = run_experiment(spec, verbose=True, device=str(dev))
    resumed = again["provenance"]["resumed_rows"]
    print(f"second run resumed {resumed}/{again['n_runs']} rows "
          "from the report on disk")
    return {"first": first, "again": again, "resumed": resumed,
            "spec_file": str(spec_file), "report": str(out)}


if __name__ == "__main__":
    main()
