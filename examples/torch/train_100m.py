"""Train a ~100M-param member of the assigned-architecture family for a few
hundred steps with the fault-tolerant loop (checkpoints + injected failure),
on the port: CUDA by default, the host with ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch/train_100m.py [--steps 300]
(~100M params: ``--steps 50`` for a quick pass; on the host add
``--device cpu`` and cut ``--seq-len`` and ``--batch``.)
"""
import argparse
import tempfile

from repro_torch.distributed.failure import FailureInjector
from repro_torch.launch.train import make_pipeline, preset_config
from repro_torch.models.api import Model, resolve_device
from repro_torch.models.common import tree_leaves
from repro_torch.train.loop import TrainConfig, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--fail-at", type=int, default=None,
                    help="inject a node failure at this step")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = preset_config(args.arch, "100m")
    model = Model(cfg, remat="none", device=dev)
    print(f"{cfg.name}: {model.param_count()/1e6:.1f}M params")
    pipe = make_pipeline(cfg, args.seq_len, args.batch)
    final = {}
    with tempfile.TemporaryDirectory() as ckpt_dir:
        tc = TrainConfig(steps=args.steps, checkpoint_every=50,
                         checkpoint_dir=ckpt_dir, log_every=20)
        injector = FailureInjector(
            [args.fail_at] if args.fail_at else [args.steps // 2])
        hist = train(model, pipe, tc, injector=injector, device=dev,
                     final_state=final)
    print(f"\nloss: {hist['loss'][0]:.3f} -> {hist['loss'][-1]:.3f}; "
          f"restarts at {hist['restarts']}; "
          f"stragglers flagged: {len(hist['stragglers'])}")
    return {"params_m": model.param_count() / 1e6, "loss": hist["loss"],
            "restarts": hist["restarts"], "stragglers": hist["stragglers"],
            "params": tree_leaves(final["params"])}


if __name__ == "__main__":
    main()
