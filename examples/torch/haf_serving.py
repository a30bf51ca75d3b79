"""End-to-end HAF serving run on the port (the paper's headline
experiment, reduced).

Runs the 6-node AI-RAN cluster at ρ=1.0 under (i) static placement and
(ii) the full HAF stack, printing the Table-III-style comparison and the
committed migration log.  On the card both runs go through the ``cuda``
engine (the ``event_step`` kernel, one launch a tick); ``--device cpu``
runs its eager float64 ``torch`` twin on the host.  The critic is read from
``--critic`` (the reference's ``artifacts/critic.json`` by default: a
critic saved by either package loads here), and is harvested and trained
on the same device only when that file is missing.

Run:  PYTHONPATH=src python examples/torch/haf_serving.py [--requests 3000]
"""
import argparse
import pathlib

from repro_torch.core import HAFPlacement, make_agent
from repro_torch.core.critic import Critic, train_critic
from repro_torch.core.datagen import harvest
from repro_torch.models.api import resolve_device
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             paper_scenario)
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement

CRITIC = pathlib.Path(__file__).resolve().parents[2] / "artifacts" / \
    "critic.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=3000)
    ap.add_argument("--rho", type=float, default=1.0)
    ap.add_argument("--critic", default=str(CRITIC))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = None if dev.type == "cuda" else "torch"

    sc = paper_scenario()
    reqs, info = generate_workload(
        WorkloadConfig(rho=args.rho, n_ai_requests=args.requests, seed=0),
        sc["work_models"])
    print(f"workload: {len(reqs)} requests over {info['horizon']:.0f}s "
          f"(λ_ai={info['lambda_ai']:.1f}/s)")
    sim = Simulator(sc, epoch_interval=5.0, engine=engine, device=dev)

    static = sim.run(reqs, StaticPlacement(), DeadlineAwareAllocation())
    print("\nstatic placement:", static.summary())

    path = pathlib.Path(args.critic)
    trained = not path.exists()
    if trained:
        print("training critic (one-time offline phase)...")
        critic = train_critic(harvest(sc, engine=engine, device=dev),
                              device=dev)
        path.parent.mkdir(parents=True, exist_ok=True)
        critic.save(str(path))
    else:
        critic = Critic.load(str(path))

    haf = sim.run(reqs, HAFPlacement(make_agent("qwen3-32b-sim"),
                                     critic=critic),
                  DeadlineAwareAllocation())
    print("\nHAF:", haf.summary())
    print("\nmigration log:")
    log = [f"t={t:7.1f}s  {a.describe(sc['instances'], sc['nodes'])}"
           for t, a in haf.migrations]
    for line in log:
        print(" ", line)
    return {"n_requests": len(reqs), "static": static.summary(),
            "haf": haf.summary(), "migrations": log,
            "events": [static.n_events, haf.n_events],
            "critic_trained": trained, "critic": critic.fingerprint()}


if __name__ == "__main__":
    main()
