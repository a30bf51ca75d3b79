"""Fault-tolerant training loop.

Twin of the reference's ``train/loop.py``.  One train step (loss -> grads
-> [int8 compression] -> clip -> cosine lr -> AdamW, eager torch, gradients
by ``torch.autograd.grad`` over the parameter tree's leaves); around it:

  * periodic atomic checkpoints (params + optimizer + pipeline state), every
    ``checkpoint_every`` steps and at the end;
  * failure handling — any step exception restores the latest checkpoint
    and resumes (with none, re-initialises from ``seed`` at pipeline step
    0; without a ``checkpoint_dir`` it re-raises);
  * straggler monitoring (flagged step times in the log);
  * optional int8 gradient compression with error feedback.

``train`` runs on CUDA unless ``device="cpu"`` is passed, and raises
``RuntimeError`` where CUDA is wanted and missing.  Its ``seed`` seeds a
``torch.Generator``, so the initial weights are not the reference's (the
two frameworks' generators differ); ``make_train_step`` takes any
parameters, so a trajectory can be held against the reference's on
converted weights.  A ``mesh`` has its parameter specs computed and
checked.  A ``launch.mesh.MeshShape`` of one device keeps whole tensors on
the card; a larger one (over the initialised process group, whose world
size it must equal) or a ``DeviceMesh`` places the parameters, the AdamW
state and each batch on it (``distributed.placement``, the reference's
``jax.device_put``): the same step then runs on ``DTensor``s, gradients are
redistributed to their parameters' placements, and checkpoints are written
whole by rank 0.  Every rank calls ``train``.  Under autograd only
``impl="xla"`` runs: the kernel wrappers refuse to be differentiated, as
the reference's kernels cannot be.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression as comp
from repro_torch.distributed import placement
from repro_torch.distributed.failure import FailureInjector, StragglerMonitor
from repro_torch.distributed.sharding import (ShardingRules, check_specs,
                                              params_shardings)
from repro_torch.launch.mesh import make_device_mesh, mesh_shape
from repro_torch.models.api import Model, resolve_device
from repro_torch.models.common import (mesh_scope, tree_leaves,
                                       tree_unflatten)
from repro_torch.obs import diag
from repro_torch.train.optimizer import (AdamWState, adamw_init, adamw_update,
                                         clip_by_global_norm, cosine_schedule)

Tree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    peak_lr: float = 3e-4
    warmup: int = 20
    max_grad_norm: float = 1.0
    weight_decay: float = 0.1
    checkpoint_every: int = 25
    checkpoint_dir: Optional[str] = None
    compress_grads: bool = False
    log_every: int = 10


def value_and_grad(model: Model, params: Tree, batch: Dict):
    """``(loss, grads)`` of ``model.loss`` at ``params``: the loss detached,
    the gradients a tree like ``params`` (zeros for a leaf the loss does not
    read, as ``jax.grad`` gives)."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad(), mesh_scope():
        loss = model.loss(tree_unflatten(params, leaves), batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                    materialize_grads=True)
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(model: Model, cfg: TrainConfig, compress: bool,
                    decay: Optional[Tree] = None) -> Callable:
    """``step(params, opt, batch, comp_state) -> (params, opt, comp_state,
    metrics)``; new tensors out, the inputs are left as they are.
    ``decay`` defaults to ``model.decay_mask()``."""
    decay = model.decay_mask() if decay is None else decay

    def train_step(params: Tree, opt: AdamWState, batch: Dict,
                   comp_state: Optional[comp.CompressionState]):
        loss, grads = value_and_grad(model, params, batch)
        grads = placement.redistribute_like(grads, params)
        with torch.no_grad():
            if compress:
                grads, comp_state = comp.compressed_gradients(grads,
                                                              comp_state)
            grads, gnorm = clip_by_global_norm(grads, cfg.max_grad_norm)
            lr = cosine_schedule(opt.step, peak_lr=cfg.peak_lr,
                                 warmup=cfg.warmup, total=cfg.steps)
            params, opt = adamw_update(params, grads, opt, lr=lr,
                                       weight_decay=cfg.weight_decay,
                                       decay=decay)
        return params, opt, comp_state, {
            "loss": placement.to_plain(loss), "grad_norm": gnorm,
            "lr": placement.to_plain(lr)}
    return train_step


def batch_to_device(batch: Dict[str, np.ndarray], device) -> Dict:
    """A pipeline's numpy batch on ``device``: integer arrays as int64
    (token ids), the others as they are."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(np.ascontiguousarray(v))
        if not t.is_floating_point():
            t = t.long()
        out[k] = t.to(device)
    return out


def check_mesh(model: Model, mesh, rules: ShardingRules):
    """Compute and check the parameter specs on ``mesh``; return the
    ``DeviceMesh`` to place on, or None for a ``MeshShape`` of one device
    (whole tensors, as without a mesh).  A larger ``MeshShape`` becomes a
    ``DeviceMesh`` over the initialised process group, whose world size
    must be the mesh's."""
    shape = mesh_shape(mesh)
    check_specs(params_shardings(model, shape, rules), model.param_specs(),
                shape)
    if mesh is not shape:
        return mesh
    if shape.size == 1:
        return None
    dist = torch.distributed
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != shape.size:
        raise ValueError(
            f"train on a mesh of {shape.size} devices {shape.shape}: the "
            f"process group has {world} rank(s); start one process a device "
            f"(torchrun, or init_process_group with world_size={shape.size})")
    return make_device_mesh(shape, model.device.type)


def train(model: Model, pipeline, cfg: TrainConfig, *,
          mesh=None, rules: ShardingRules = ShardingRules(),
          injector: Optional[FailureInjector] = None,
          seed: int = 0, verbose: bool = True,
          device=None,
          final_state: Optional[Dict] = None) -> Dict[str, List[float]]:
    """Run the loop; returns the metric history (one entry per step).  A
    ``final_state`` dict receives the last ``"params"`` and ``"opt"`` (as
    placed), the ``"device_mesh"`` (None without placement) and the seconds
    of each step run (``"step_s"``)."""
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"the model is on {model.device}, training on "
                         f"{device}: build it with device={str(device)!r}")
    dmesh = check_mesh(model, mesh, rules) if mesh is not None else None
    injector = injector or FailureInjector()
    monitor = StragglerMonitor()
    history: Dict[str, List[float]] = {"loss": [], "grad_norm": [],
                                       "restarts": [], "stragglers": []}

    def place(params, opt):
        if dmesh is None:
            return params, opt
        return (placement.place_params(params, model, dmesh, rules),
                placement.place_opt(opt, model, dmesh, rules))

    def fresh():
        p = model.init(torch.Generator(device=model.device).manual_seed(seed))
        return place(p, adamw_init(p))

    # ---- init or restore ------------------------------------------------ #
    params, opt = fresh()
    comp_state = comp.init_state(params) if cfg.compress_grads else None
    step_fn = make_train_step(model, cfg, cfg.compress_grads)

    start_step = 0
    if cfg.checkpoint_dir:
        template = {"params": params, "opt_state": opt}
        state, s, extra = ckpt.restore_checkpoint(cfg.checkpoint_dir,
                                                  template)
        if state is not None:
            params, opt = state["params"], state["opt_state"]
            pipeline.restore(extra.get("pipeline"))
            start_step = s
            if verbose:
                diag(f"[train] restored checkpoint at step {s}")

    def save(step: int) -> None:
        if not cfg.checkpoint_dir:
            return
        ckpt.save_checkpoint(cfg.checkpoint_dir, step, params,
                             opt_state=opt,
                             extra={"pipeline": pipeline.state_dict()})

    # ---- the loop -------------------------------------------------------- #
    step = start_step
    while step < cfg.steps:
        try:
            injector.maybe_fail(step)
            batch = batch_to_device(pipeline.next_batch(), model.device)
            if dmesh is not None:
                batch = placement.place_batch(batch, dmesh, rules)
            monitor.start()
            params, opt, comp_state, metrics = step_fn(params, opt, batch,
                                                       comp_state)
            loss = float(metrics["loss"])
            dt = monitor.stop(step)
            history["loss"].append(loss)
            history["grad_norm"].append(float(metrics["grad_norm"]))
            if verbose and (step % cfg.log_every == 0):
                flag = " STRAGGLER" if monitor.flagged and \
                    monitor.flagged[-1] == step else ""
                diag(f"[train] step {step:5d} loss {loss:.4f} "
                     f"({dt*1e3:.0f} ms){flag}")
            step += 1
            if step % cfg.checkpoint_every == 0 or step == cfg.steps:
                save(step)
        except Exception as e:  # noqa: BLE001 — node failure path
            if not cfg.checkpoint_dir:
                raise
            history["restarts"].append(step)
            if verbose:
                diag(f"[train] step {step} failed ({e}); restoring")
            template = {"params": params, "opt_state": opt}
            state, s, extra = ckpt.restore_checkpoint(cfg.checkpoint_dir,
                                                      template)
            if state is None:
                params, opt = fresh()
                pipeline.restore({"step": 0})
                step = 0
            else:
                params, opt = state["params"], state["opt_state"]
                pipeline.restore(extra.get("pipeline"))
                step = s
    history["stragglers"] = list(monitor.flagged)
    if final_state is not None:
        final_state.update(params=params, opt=opt, device_mesh=dmesh,
                           step_s=list(monitor.times))
    return history
