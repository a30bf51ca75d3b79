"""Fault-tolerant training launcher (twin of the reference's
``launch/train.py``; the reference's flags plus ``--device``).

  python -m repro_torch.launch.train --arch qwen2-0.5b --preset 100m \
      --steps 200 --checkpoint-dir /tmp/ckpt
  python -m repro_torch.launch.train --arch mamba2-130m --preset smoke

It trains on the card: without ``--device`` it runs on CUDA and raises
``RuntimeError`` where there is none (``--device cpu`` runs the plain torch
path on the host).  Training runs ``impl="xla"``, as in the reference.
``--mesh DATAxMODEL`` trains on a device mesh of that shape, one process a
device, over the process group that ``torchrun`` describes in the
environment (NCCL on CUDA, gloo with ``--device cpu``); every rank runs
the same command:

  torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch qwen2-0.5b \
      --preset smoke --device cpu --steps 4 --seq-len 16 --global-batch 4 \
      --mesh 2x2
An encoder-decoder config (whisper) is fed stub encoder frames beside the
tokens (``data.FramesPipeline``): the reference feeds tokens only and fails
on it (ROADMAP Queue C R7).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataPipeline, FramesPipeline
from repro_torch.launch.mesh import MeshShape
from repro_torch.models.api import Model
from repro_torch.train.loop import TrainConfig, train


def preset_config(arch: str, preset: str) -> ArchConfig:
    if preset == "full":
        return get_config(arch)
    if preset == "smoke":
        return smoke_config(arch)
    if preset == "100m":
        cfg = get_config(arch)
        kw = dict(name=cfg.name + "-100m", num_layers=12, d_model=768,
                  vocab_size=32000, param_dtype="float32",
                  compute_dtype="float32")
        if cfg.family not in ("ssm",):
            kw.update(num_heads=12, num_kv_heads=4, head_dim=64, d_ff=2048)
        if cfg.moe is not None:
            kw["moe"] = dataclasses.replace(cfg.moe, num_experts=8, top_k=2,
                                            d_ff_expert=512,
                                            first_dense_layers=1,
                                            d_ff_dense=2048)
        if cfg.hybrid is not None and cfg.hybrid.published:
            kw["hybrid"] = dataclasses.replace(cfg.hybrid, layer_ids=tuple(
                i for i in cfg.hybrid.layer_ids if i < kw["num_layers"]))
        if cfg.mla is not None:
            kw["mla"] = dataclasses.replace(cfg.mla, q_lora_rank=0,
                                            kv_lora_rank=128,
                                            qk_nope_head_dim=64,
                                            qk_rope_head_dim=32,
                                            v_head_dim=64)
        return dataclasses.replace(cfg, **kw)
    raise ValueError(preset)


def init_from_env(device) -> None:
    """The process group of ``torchrun``'s environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``), NCCL on CUDA with
    this process on card ``LOCAL_RANK``, gloo on the host; nothing where a
    group is initialised already."""
    dist = torch.distributed
    if dist.is_initialized():
        return
    if torch.device(device or "cuda").type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")


def make_pipeline(cfg: ArchConfig, seq_len: int, global_batch: int):
    """The launcher's data: the token pipeline, with stub encoder frames
    for an encoder-decoder config."""
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=seq_len,
                        global_batch=global_batch)
    if cfg.encdec is not None:
        return FramesPipeline(pipe, cfg.encdec.encoder_frames, cfg.d_model)
    return pipe


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, List[float]]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--preset", default="100m",
                    choices=("smoke", "100m", "full"))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=512)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--device", default=None,
                    help="torch device (default: CUDA, which must exist)")
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL (e.g. 2x2): train on a device mesh of "
                         "that shape over the process group torchrun "
                         "starts, one process a device")
    args = ap.parse_args(argv)
    mesh = None
    if args.mesh:
        data, width = (int(n) for n in args.mesh.lower().split("x"))
        mesh = MeshShape(("data", "model"), (data, width))
        init_from_env(args.device)

    cfg = preset_config(args.arch, args.preset)
    model = Model(cfg, remat=args.remat, device=args.device)
    print(f"[launch] {cfg.name}: {model.param_count()/1e6:.1f}M params")
    pipeline = make_pipeline(cfg, args.seq_len, args.global_batch)
    tc = TrainConfig(steps=args.steps, peak_lr=args.lr,
                     checkpoint_every=args.checkpoint_every,
                     checkpoint_dir=args.checkpoint_dir,
                     compress_grads=args.compress_grads)
    hist = train(model, pipeline, tc, device=args.device, mesh=mesh)
    print(f"[launch] done: loss {hist['loss'][0]:.3f} -> "
          f"{hist['loss'][-1]:.3f} over {len(hist['loss'])} steps; "
          f"restarts={hist['restarts']}")
    return hist


if __name__ == "__main__":
    main()
