"""Quickstart on the port: the three layers of the repo on one H100.

  1. the paper's closed-form deadline-aware allocator (one node),
  2. one HAF placement decision end to end (prompt → agent → critic),
  3. one assigned architecture: a loss and its gradient, then prefill and
     a decode step (reduced config).

Run:  PYTHONPATH=src python examples/torch/quickstart.py [--device cpu]
(On the card the simulator runs the ``cuda`` engine; with ``--device cpu``
its eager float64 ``torch`` twin on the host.)
"""
import argparse

import numpy as np
import torch

from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.core import HAFPlacement, candidate_actions, make_agent
from repro_torch.core.allocator import solve_resource
from repro_torch.core.prompts import build_prompt
from repro_torch.models.api import Model, resolve_device
from repro_torch.sim import (Simulator, WorkloadConfig, generate_workload,
                             paper_scenario)
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement

# Eq. 16–19: one node's GPU between a DU (floored) and two AI services
PSI = [2e12, 6e13, 2.4e14]          # DU, small-AI, large-AI work
OMEGA = [900.0, 12.0, 40.0]         # urgency (1 ms vs seconds)
FLOORS = [3e13, 0.0, 0.0]           # DU floor from Eq. 15
CAPACITY = 2e14


def allocate(device):
    """The allocator's result on ``device`` (float32, as the reference's
    ``jnp`` inputs are)."""
    t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
    return solve_resource(t(PSI), t(OMEGA), t(FLOORS), CAPACITY)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    engine = None if dev.type == "cuda" else "torch"

    # 1) the allocator
    res = allocate(dev)
    print("allocator: g* =", np.round(res.alloc.cpu().numpy() / 1e12, 1),
          "TFLOP/s  (DU pinned at floor:", bool(res.floored[0]), ")")

    # 2) one placement epoch: snapshot -> prompt -> agent -> action
    sc = paper_scenario()
    reqs, _ = generate_workload(
        WorkloadConfig(rho=1.0, n_ai_requests=400, seed=0),
        sc["work_models"])
    snaps = []
    Simulator(sc, engine=engine, device=dev).run(
        reqs, StaticPlacement(), DeadlineAwareAllocation(),
        epoch_hook=lambda rec, cl: snaps.append(rec.snapshot))
    snap = snaps[1]
    cands = candidate_actions(snap)
    print(f"\nplacement: |M_k| = {len(cands)} candidates; prompt excerpt:")
    print("\n".join(build_prompt(snap, cands).splitlines()[:6]), "...")
    decision = HAFPlacement(make_agent("qwen3-32b-sim"),
                            critic=None).decide(snap)
    described = (decision.describe(sc["instances"], sc["nodes"])
                 if decision else "no-migration")
    print("agent decision:", described)

    # 3) one assigned architecture (MLA + MoE family, reduced)
    cfg = smoke_config("deepseek-v2-lite-16b")
    model = Model(cfg, remat="none", device=dev)
    params = model.init(0)
    batch = model.make_inputs(ShapeCell("demo", 16, 2, "train"),
                              torch.Generator(device=dev).manual_seed(1))
    leaves, spec = torch.utils._pytree.tree_flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    loss = model.loss(torch.utils._pytree.tree_unflatten(leaves, spec), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    loss = loss.detach()
    print(f"\n{cfg.name}: loss={float(loss):.3f}, "
          f"params={model.param_count()/1e6:.2f}M")
    with torch.no_grad():
        logits, cache = model.prefill(params,
                                      {"tokens": batch["tokens"][:, :8]})
        cache = model.pad_cache(cache, 16)
        logits, cache = model.decode_step(
            params, cache, {"tokens": batch["tokens"][:, 8:9], "pos": 8})
    print("decode step ok:", tuple(logits.shape))
    return {"alloc": res.alloc, "floored": res.floored,
            "feasible": res.feasible, "n_candidates": len(cands),
            "decision": described, "loss": loss,
            "grad_norm": torch.sqrt(sum((g.float() ** 2).sum()
                                        for g in grads)),
            "logits": logits}


if __name__ == "__main__":
    main()
