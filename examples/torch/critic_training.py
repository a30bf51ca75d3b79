"""Critic offline training walkthrough (§III-B) on the port: exploration +
counterfactual probes → supervised regression → before/after gating
comparison.  The harvest runs the simulator on the card (the ``cuda``
engine) and the critic trains there; ``--device cpu`` runs both on the host.

Run:  PYTHONPATH=src python examples/torch/critic_training.py
(The defaults are the reference's sizes; ``--harvest-bulk``,
``--harvest-probe``, ``--epochs`` and ``--requests`` shrink a smoke run.)
"""
import argparse

from repro_torch.core import HAFPlacement, make_agent, train_critic
from repro_torch.core.datagen import harvest
from repro_torch.models.api import resolve_device
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             paper_scenario)
from repro_torch.sim.engine import DeadlineAwareAllocation


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--harvest-bulk", type=int, default=2500)
    ap.add_argument("--harvest-probe", type=int, default=1500)
    ap.add_argument("--epochs", type=int, default=1500)
    ap.add_argument("--requests", type=int, default=2500,
                    help="requests of the gating comparison")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = None if dev.type == "cuda" else "torch"

    sc = paper_scenario()
    print("1) harvesting epoch samples (bulk exploration + counterfactual "
          "probes)...")
    samples = harvest(sc, bulk_requests=args.harvest_bulk,
                      probe_requests=args.harvest_probe, engine=engine,
                      device=dev, verbose=True)
    print(f"   {len(samples)} (φ, r, mask) samples")

    print("2) supervised regression (Eq. 10, factored Δ-critic)...")
    critic = train_critic(samples, epochs=args.epochs, seed=0, device=dev)

    print("3) gating effect on an erratic agent (deepseek-r1 stand-in):")
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=args.requests, seed=0),
        sc["work_models"])
    sim = Simulator(sc, epoch_interval=5.0, engine=engine, device=dev)
    out = {"n_samples": len(samples), "critic": critic.fingerprint()}
    for critic_arg, tag in ((None, "HAF-NoCritic"), (critic, "HAF(+Critic)")):
        pol = HAFPlacement(make_agent("deepseek-r1-70b-sim"),
                           critic=critic_arg)
        s = sim.run(reqs, pol, DeadlineAwareAllocation()).summary()
        print(f"   {tag:14s} overall={s['overall']:.3f} "
              f"migrations={s['mig_large']}/{s['mig_total']}")
        out[tag] = s
    return out


if __name__ == "__main__":
    main()
