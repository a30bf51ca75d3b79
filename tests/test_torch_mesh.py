"""Training on a device mesh: four gloo ranks on the host, against one
process.

Each mesh shape (2×2, 4×1, 1×4 ``data`` × ``model``; the last over the
host-staged backend) is one spawn of four ranks (a module fixture), which
trains the qwen2 and mamba2 smoke configs
for three float32 steps through ``train(mesh=...)``, once more with a
checkpoint directory, and reports back through a JSON file.  The tests
hold the reports against a one-process run: the first step's gradients
within 1e-5 of each leaf's own scale, losses and final parameters within
1e-6 relative, the mesh's checkpoint restoring
bit-equal in one process and through the reference's
``restore_checkpoint``.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import socket
from datetime import timedelta

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models.api import Model
from repro_torch.train import loop

WORLD = 4
STEPS = 3
ARCHS = ("qwen2-0.5b", "mamba2-130m", "deepseek-v2-lite-16b")
# mesh shape -> (data, model), the process group's backend: the 1×4 spawn
# runs the host-staged backend that ranks sharing one card take
MESHES = {"2x2": ((2, 2), "gloo"), "4x1": ((4, 1), "gloo"),
          "1x4": ((1, 4), "hoststaged")}
TIMEOUT = timedelta(seconds=120)
# the launcher's command line, on a mesh and in one process
LAUNCH = ["--arch", "qwen2-0.5b", "--preset", "smoke", "--device", "cpu",
          "--steps", "2", "--seq-len", "16", "--global-batch", "4"]
REL = 1e-6
# the first step's gradients, each leaf of its own largest magnitude: a
# gradient placed wrong (a Partial summed twice or never) is off by a
# factor, where sums taken in another order differ by at most 7e-6
GRAD_REL = 1e-5


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _pipeline(cfg):
    return DataPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                        global_batch=4)


def _run(arch, mesh, ckpt_dir=None, compress=False):
    """``train`` of ``arch``'s smoke config for STEPS steps; returns (the
    loss history, the final parameters gathered whole)."""
    from repro_torch.distributed.placement import gather_full
    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu", remat="none")
    tc = loop.TrainConfig(steps=STEPS, warmup=1, checkpoint_dir=ckpt_dir,
                          checkpoint_every=STEPS, compress_grads=compress)
    out = {}
    hist = loop.train(model, _pipeline(cfg), tc, mesh=mesh, verbose=False,
                      device="cpu", final_state=out)
    return hist, gather_full(out["params"])


def _first_grads(arch, mesh):
    """The gradients of ``train``'s first step (its initial parameters and
    batch, before clipping and AdamW), gathered whole, as float64 arrays."""
    from repro_torch.distributed import placement
    from repro_torch.models.common import tree_leaves
    cfg = smoke_config(arch)
    model = Model(cfg, device="cpu", remat="none")
    params = model.init(torch.Generator(device="cpu").manual_seed(0))
    batch = loop.batch_to_device(_pipeline(cfg).next_batch(), model.device)
    if mesh is not None:
        dmesh = loop.check_mesh(model, mesh, loop.ShardingRules())
        params = placement.place_params(params, model, dmesh)
        batch = placement.place_batch(batch, dmesh)
    _, grads = loop.value_and_grad(model, params, batch)
    grads = placement.gather_full(placement.redistribute_like(grads, params))
    return [g.double().numpy() for g in tree_leaves(grads)]


def _worker(rank, port, dims, backend, out_dir):
    torch.set_num_threads(1)
    import repro_torch.distributed.hoststaged  # noqa: F401 — registers it
    torch.distributed.init_process_group(
        backend, init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=WORLD, timeout=TIMEOUT)
    try:
        from repro_torch.launch.mesh import MeshShape, make_debug_mesh
        from repro_torch.models.common import tree_leaves
        mesh = MeshShape(("data", "model"), dims)
        report = {"debug_mesh": list(make_debug_mesh(4, 4).sizes),
                  "backend": torch.distributed.get_backend()}
        for arch in ARCHS:
            hist, params = _run(arch, mesh)
            report[arch] = {
                "loss": hist["loss"], "grad_norm": hist["grad_norm"],
                "params": [p.double().numpy().tolist()
                           for p in tree_leaves(params)],
                "grads": [g.tolist() for g in _first_grads(arch, mesh)]}
        report["compressed"] = _run("qwen2-0.5b", mesh,
                                    compress=True)[0]["loss"]
        with contextlib.redirect_stdout(io.StringIO()):
            report["launcher"] = launch_train.main(LAUNCH + [
                "--mesh", "x".join(map(str, dims))])["loss"]
        hist, params = _run("qwen2-0.5b", mesh,
                            os.path.join(out_dir, "ckpt"))
        report["ckpt_params"] = [p.double().numpy().tolist()
                                 for p in tree_leaves(params)]
        if rank == 0:
            with open(os.path.join(out_dir, "report.json"), "w") as f:
                json.dump(report, f)
    finally:
        torch.distributed.destroy_process_group()


@pytest.fixture(scope="module", params=list(MESHES))
def mesh_run(request, tmp_path_factory):
    out = tmp_path_factory.mktemp(f"mesh_{request.param}")
    dims, backend = MESHES[request.param]
    mp.start_processes(_worker, args=(_free_port(), dims, backend, str(out)),
                       nprocs=WORLD, start_method="spawn")
    with open(out / "report.json") as f:
        return request.param, json.load(f), out


@pytest.fixture(scope="module")
def one_process():
    from repro_torch.models.common import tree_leaves
    out = {}
    for arch in ARCHS:
        hist, params = _run(arch, None)
        out[arch] = {"loss": hist["loss"], "grad_norm": hist["grad_norm"],
                     "params": [p.double().numpy()
                                for p in tree_leaves(params)],
                     "grads": _first_grads(arch, None)}
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_first_gradients_equal_one_process(mesh_run, one_process,
                                                arch):
    """The first step's gradient of every leaf, redistributed to its
    parameter's placement and gathered, within 1e-5 of that leaf's own
    largest magnitude of the one-process gradient."""
    _, report, _ = mesh_run
    want = one_process[arch]["grads"]
    got = report[arch]["grads"]
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        g = np.asarray(g)
        assert g.shape == w.shape, i
        scale = np.abs(w).max()
        assert scale > 0, i
        assert np.abs(g - w).max() <= GRAD_REL * scale, i


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_trajectory_equals_one_process(mesh_run, one_process, arch):
    """Three float32 steps on the mesh: every loss, and the first step's
    gradient norm, within 1e-6 relative of the one-process run; every final
    parameter within 1e-6 of the parameters' largest magnitude.  (Not of
    each leaf's own, nor later gradient norms: AdamW steps each element by
    its own gradient over that gradient's RMS, so an element whose gradient
    is small beside its leaf's largest carries the rounding of a sum taken
    in another order, small of the leaf's scale, as a large share of its
    own step -- qwen2's zero-initialised q / k biases, whose scale is a few
    steps' worth of the learning rate, end 3e-4 of it apart -- and the next
    gradients follow the parameters.  The first step's gradients are held
    leaf by leaf above.)"""
    _, report, _ = mesh_run
    want = one_process[arch]
    got = report[arch]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=REL)
    np.testing.assert_allclose(got["grad_norm"][0], want["grad_norm"][0],
                               rtol=REL)
    assert len(got["params"]) == len(want["params"])
    scale = max(np.abs(w).max() for w in want["params"])
    for g, w in zip(got["params"], want["params"]):
        assert np.abs(np.asarray(g) - w).max() <= REL * scale


def test_mesh_checkpoint_restores_in_one_process(mesh_run):
    """The mesh's last checkpoint, restored in one process, is bit-equal
    to the parameters the mesh gathered."""
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.models.common import tree_leaves
    _, report, out = mesh_run
    model = Model(smoke_config("qwen2-0.5b"), device="cpu")
    template = {"params": model.init(0)}
    state, step, extra = ckpt.restore_checkpoint(str(out / "ckpt"),
                                                 template)
    assert step == STEPS and extra["pipeline"]["step"] == STEPS
    for g, w in zip(tree_leaves(state["params"]), report["ckpt_params"]):
        assert np.array_equal(g.double().numpy(), np.asarray(w))


def test_mesh_checkpoint_restores_in_reference(mesh_run):
    """The same archive through the reference's ``restore_checkpoint``."""
    import jax
    from repro.distributed.checkpoint import restore_checkpoint
    from repro_torch.distributed import checkpoint as ckpt
    from repro_torch.models.common import tree_leaves
    _, _, out = mesh_run
    model = Model(smoke_config("qwen2-0.5b"), device="cpu")
    mine, _, _ = ckpt.restore_checkpoint(str(out / "ckpt"),
                                         {"params": model.init(0)})
    shapes = {"params": model.param_specs()}
    template = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes,
                            is_leaf=lambda x: hasattr(x, "dtype"))
    ref, step, _ = restore_checkpoint(str(out / "ckpt"), template)
    assert step == STEPS
    from repro_torch.models.common import stack_stacked
    want = tree_leaves(stack_stacked(mine["params"]))
    got = jax.tree.leaves(ref["params"])
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), w.numpy())


def test_compressed_trajectory_equals_one_process(mesh_run):
    """int8 gradient compression on the mesh: one scale a tensor from the
    global tensor's largest magnitude, so the same losses."""
    _, report, _ = mesh_run
    want = _run("qwen2-0.5b", None, compress=True)[0]["loss"]
    np.testing.assert_allclose(report["compressed"], want, rtol=REL)


def test_launcher_trains_on_the_mesh(mesh_run):
    """``python -m repro_torch.launch.train --mesh DATAxMODEL`` (the
    group already up, as under torchrun) gives the one-process losses."""
    _, report, _ = mesh_run
    with contextlib.redirect_stdout(io.StringIO()):
        want = launch_train.main(LAUNCH)["loss"]
    np.testing.assert_allclose(report["launcher"], want, rtol=REL)


def test_mesh_ran_on_its_backend(mesh_run):
    name, report, _ = mesh_run
    assert report["backend"] == MESHES[name][1]


def test_debug_mesh_takes_the_world_size(mesh_run):
    """Under a 4-rank group ``make_debug_mesh(4, 4)`` is 4×1, as the
    reference's is over four devices."""
    _, report, _ = mesh_run
    assert report["debug_mesh"] == [4, 1]
