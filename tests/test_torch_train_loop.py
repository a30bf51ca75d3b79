"""The port's training loop, launcher and kernel guard on the CPU, and the
reference's own training cases run on the port.

- ``tests/test_train.py`` of the reference (AdamW, clipping, the schedule,
  the pipeline, the fault-tolerant loop with a restart at step 13, the
  failure without a checkpoint, compressed training) and the loss and
  train-step cases of ``tests/test_models.py``, on ``repro_torch``;
- the loop's restart from ``seed`` before any checkpoint and its resume
  from an existing one, ``train(mesh=...)`` and ``train(device=...)``;
- the kernel wrappers' autograd guard: ``flash_attention`` and
  ``ssd_scan`` raise under autograd on every device, forward unchanged;
- the launcher: presets equal to the reference's, every config trained
  in-process on the host at the smoke preset.

Parity of the loss, gradients, optimizer and trajectories with the
reference is ``tests/test_torch_train.py``.  Sizes are the smoke configs.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_NAMES, ShapeCell, smoke_config
from repro_torch.models import common
from repro_torch.models.api import Model, build_model
from repro_torch.train import loop, optimizer


def test_frames_pipeline_replays_after_restore():
    """The launcher's stub encoder frames are a function of (seed, step,
    shard): a restore replays them, and the tokens are the wrapped
    pipeline's."""
    from repro_torch.data.pipeline import DataPipeline, FramesPipeline
    mk = lambda: FramesPipeline(DataPipeline(vocab_size=64, seq_len=8,
                                             global_batch=2, seed=3), 5, 4)
    a = mk()
    batches = [a.next_batch() for _ in range(3)]
    assert batches[0]["frames"].shape == (2, 5, 4)
    assert batches[0]["frames"].dtype == np.float32
    assert not np.array_equal(batches[0]["frames"], batches[1]["frames"])
    b = mk()
    b.restore({"step": 2})
    again = b.next_batch()
    for k in ("tokens", "frames"):
        assert np.array_equal(again[k], batches[2][k])
    assert a.state_dict() == {"step": 3}


# --------------------------------------------------------------------------- #
# the reference's own cases (tests/test_train.py), on the port
# --------------------------------------------------------------------------- #
def test_adamw_moves_params_and_decays():
    params = {"w": torch.ones((4, 4)), "b": torch.zeros((4,))}
    grads = {"w": torch.ones((4, 4)), "b": torch.ones((4,))}
    state = optimizer.adamw_init(params)
    new, state = optimizer.adamw_update(params, grads, state,
                                        lr=torch.tensor(0.1))
    assert int(state.step) == 1
    assert not np.allclose(new["w"].numpy(), 1.0)
    # bias (1-D) is not weight-decayed: pure Adam step of size ~lr
    np.testing.assert_allclose(new["b"].numpy(), -0.1, atol=1e-3)


def test_clip_by_global_norm():
    grads = {"a": torch.full((10,), 100.0)}
    clipped, norm = optimizer.clip_by_global_norm(grads, 1.0)
    assert float(norm) > 1.0
    total = float(torch.sqrt(torch.sum(torch.square(clipped["a"]))))
    assert total == pytest.approx(1.0, rel=1e-5)


def test_cosine_schedule_shape():
    lrs = [float(optimizer.cosine_schedule(torch.tensor(t), peak_lr=1.0,
                                           warmup=10, total=100))
           for t in range(100)]
    assert lrs[0] == 0.0
    assert max(lrs) == pytest.approx(1.0, rel=1e-3)
    assert lrs[-1] < 0.2
    assert lrs[5] < lrs[9]          # warming up


def test_pipeline_deterministic_and_restorable():
    from repro_torch.data.pipeline import DataPipeline
    mk = lambda: DataPipeline(vocab_size=512, seq_len=32, global_batch=4,
                              seed=7)
    p1, p2 = mk(), mk()
    b1 = [p1.next_batch()["tokens"] for _ in range(3)]
    b2 = [p2.next_batch()["tokens"] for _ in range(3)]
    for x, y in zip(b1, b2):
        np.testing.assert_array_equal(x, y)
    p3 = mk()
    p3.restore({"step": 2})
    np.testing.assert_array_equal(p3.next_batch()["tokens"], b1[2])


def test_pipeline_shards_disjoint():
    from repro_torch.data.pipeline import DataPipeline
    a = DataPipeline(vocab_size=512, seq_len=32, global_batch=8, seed=0,
                     shard=0, num_shards=2)
    b = DataPipeline(vocab_size=512, seq_len=32, global_batch=8, seed=0,
                     shard=1, num_shards=2)
    assert not np.array_equal(a.next_batch()["tokens"],
                              b.next_batch()["tokens"])


def test_train_loss_decreases_and_restarts(tmp_path):
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.checkpoint import latest_step
    from repro_torch.distributed.failure import FailureInjector
    cfg = smoke_config("qwen2-0.5b")
    model = Model(cfg, remat="none", device="cpu")
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=32, global_batch=4)
    tc = loop.TrainConfig(steps=24, checkpoint_every=8,
                          checkpoint_dir=str(tmp_path), log_every=100)
    hist = loop.train(model, pipe, tc, injector=FailureInjector([13]),
                      verbose=False, device="cpu")
    assert hist["restarts"] == [13]
    assert hist["loss"][-1] < hist["loss"][0]
    assert set(hist) == {"loss", "grad_norm", "restarts", "stragglers"}
    # 13 steps, the failure, then steps 8..23 again from the checkpoint
    assert len(hist["loss"]) == 13 + 16
    assert latest_step(str(tmp_path)) == 24


def test_train_without_checkpoint_raises_on_failure():
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.failure import (FailureInjector,
                                                 InjectedFailure)
    cfg = smoke_config("mamba2-130m")
    model = Model(cfg, remat="none", device="cpu")
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    tc = loop.TrainConfig(steps=10, checkpoint_dir=None)
    with pytest.raises(InjectedFailure):
        loop.train(model, pipe, tc, injector=FailureInjector([3]),
                   verbose=False, device="cpu")


def test_compressed_training_still_learns():
    from repro_torch.data.pipeline import DataPipeline
    cfg = smoke_config("mamba2-130m")
    model = Model(cfg, remat="none", device="cpu")
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    tc = loop.TrainConfig(steps=15, compress_grads=True, checkpoint_dir=None)
    hist = loop.train(model, pipe, tc, verbose=False, device="cpu")
    assert hist["loss"][-1] < hist["loss"][0]


def test_failure_without_a_checkpoint_yet_restarts_from_seed(tmp_path):
    """A failure before the first checkpoint re-initialises from ``seed``
    at pipeline step 0 (the reference's ``loop.py:137-155``): the replayed
    losses are the first run's."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed.failure import FailureInjector
    cfg = smoke_config("qwen2-0.5b")
    model = Model(cfg, remat="none", device="cpu")
    pipe = DataPipeline(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2)
    tc = loop.TrainConfig(steps=6, checkpoint_every=100,
                          checkpoint_dir=str(tmp_path))
    hist = loop.train(model, pipe, tc, injector=FailureInjector([3]),
                      verbose=False, device="cpu")
    assert hist["restarts"] == [3]
    assert hist["loss"][:3] == hist["loss"][3:6]
    assert len(hist["loss"]) == 3 + 6


def test_train_resumes_from_an_existing_checkpoint(tmp_path):
    """A second ``train`` on the same directory starts from its latest
    checkpoint: nothing is left to run, and the checkpoint restores the
    final parameters and AdamW state bit for bit."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.distributed import checkpoint as ckpt
    cfg = smoke_config("qwen2-0.5b")
    model = Model(cfg, device="cpu")
    mk = lambda: DataPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                              global_batch=2)
    tc = loop.TrainConfig(steps=4, checkpoint_every=2,
                          checkpoint_dir=str(tmp_path))
    loop.train(model, mk(), tc, verbose=False, device="cpu")
    again = loop.train(model, mk(), tc, verbose=False, device="cpu")
    assert again["loss"] == []
    params = model.init(0)
    template = {"params": params, "opt_state": optimizer.adamw_init(params)}
    state, step, extra = ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 4 and extra == {"pipeline": {"step": 4}}
    assert int(state["opt_state"].step) == 4


# --------------------------------------------------------------------------- #
# tests/test_models.py's loss and train-step cases, on the port
# --------------------------------------------------------------------------- #
CELL = ShapeCell("smoke-train", 16, 2, "train")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_smoke_loss_and_shapes(arch):
    cfg = smoke_config(arch)
    model = Model(cfg, remat="none", device="cpu")
    params = model.init(0)
    batch = model.make_inputs(CELL, torch.Generator().manual_seed(1))
    loss = model.loss(params, batch)
    assert loss.shape == () and loss.dtype == torch.float32
    assert bool(torch.isfinite(loss)), arch
    logits = model.forward(params, batch)
    assert logits.shape[-1] == cfg.padded_vocab
    assert bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_train_step_reduces_loss(arch):
    """A few SGD steps on one repeated batch must reduce the loss."""
    cfg = smoke_config(arch)
    model = Model(cfg, remat="none", device="cpu")
    params = model.init(0)
    batch = model.make_inputs(CELL, torch.Generator().manual_seed(1))

    def step(p):
        loss, g = loop.value_and_grad(model, p, batch)
        return loss, common.tree_unflatten(p, [
            x - 0.05 * gg for x, gg in zip(common.tree_leaves(p),
                                           common.tree_leaves(g))])

    l0, params = step(params)
    for _ in range(3):
        l1, params = step(params)
    assert float(l1) < float(l0), arch


# --------------------------------------------------------------------------- #
# the kernel wrappers' autograd guard
# --------------------------------------------------------------------------- #
def _flash_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 16, 4, 64, generator=g)
    k = torch.randn(2, 16, 2, 64, generator=g)
    v = torch.randn(2, 16, 2, 64, generator=g)
    return [t.requires_grad_(requires_grad) for t in (q, k, v)]


def _ssd_inputs(requires_grad):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 16, 4, 8, generator=g)
    dt = torch.rand(1, 16, 4, generator=g) * 0.1
    A = -torch.rand(4, generator=g)
    B_ = torch.randn(1, 16, 1, 8, generator=g)
    C = torch.randn(1, 16, 1, 8, generator=g)
    return [t.requires_grad_(requires_grad) for t in (x, dt, A, B_, C)]


def test_kernel_wrappers_refuse_autograd():
    """The kernels have no backward pass: ``flash_attention`` and
    ``ssd_scan`` raise where grad mode is on and an input requires grad
    (on the CPU too, where the plain version would differentiate), and
    give the same values as before under ``torch.no_grad()`` or on inputs
    that require no grad."""
    from repro_torch.kernels import ops
    for fn, mk in ((lambda a: ops.flash_attention(*a), _flash_inputs),
                   (lambda a: ops.ssd_scan(*a, chunk=8), _ssd_inputs)):
        with pytest.raises(RuntimeError, match="no backward"):
            fn(mk(True))
        plain = fn(mk(False))
        with torch.no_grad():
            guarded = fn(mk(True))
        for a, b in zip(plain if isinstance(plain, tuple) else (plain,),
                        guarded if isinstance(guarded, tuple) else
                        (guarded,)):
            assert torch.equal(a, b)


@pytest.mark.parametrize("name,impl", (("qwen2-0.5b", "flash"),
                                       ("mamba2-130m", "pallas"),
                                       ("zamba2-2.7b", "pallas")))
def test_kernel_lowerings_train_only_forward(name, impl):
    """``Model.loss`` under a kernel lowering raises under autograd (as the
    reference's ``jax.value_and_grad`` does) and equals ``impl="xla"``'s
    loss (1e-5) under ``torch.no_grad()``."""
    cfg = smoke_config(name)
    model = build_model(cfg, impl=impl, device="cpu")
    params = model.init(0)
    batch = model.make_inputs(CELL, torch.Generator().manual_seed(1))
    with pytest.raises(RuntimeError, match="no backward"):
        loop.value_and_grad(model, params, batch)
    with torch.no_grad():
        got = float(model.loss(params, batch))
        want = float(build_model(cfg, device="cpu").loss(params, batch))
    assert got == pytest.approx(want, rel=1e-5)


# --------------------------------------------------------------------------- #
# train(): device, mesh; the launcher
# --------------------------------------------------------------------------- #
def test_train_on_a_mesh_of_one_device_and_refuses_more(tmp_path):
    """A mesh of one device: the specs are computed and checked and the
    run is the mesh-less one.  A production mesh without a process group of
    its size: ``ValueError`` naming the world size, before any step (a mesh
    that has one is trained in ``test_torch_mesh.py``)."""
    from repro_torch.data.pipeline import DataPipeline
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh
    cfg = smoke_config("qwen2-0.5b")
    model = Model(cfg, device="cpu")
    mk = lambda: DataPipeline(vocab_size=cfg.vocab_size, seq_len=16,
                              global_batch=2)
    tc = loop.TrainConfig(steps=3)
    one = loop.train(model, mk(), tc, mesh=make_debug_mesh(), verbose=False,
                     device="cpu")
    none = loop.train(model, mk(), tc, verbose=False, device="cpu")
    assert one["loss"] == none["loss"]
    with pytest.raises(ValueError, match="process group has 1 rank"):
        loop.train(model, mk(), tc, mesh=make_production_mesh(),
                   verbose=False, device="cpu")


def test_train_device_must_match_the_model():
    from repro_torch.data.pipeline import DataPipeline
    model = Model(smoke_config("qwen2-0.5b"), device="cpu")
    pipe = DataPipeline(vocab_size=256, seq_len=16, global_batch=2)
    if torch.cuda.is_available():
        with pytest.raises(ValueError, match="model is on"):
            loop.train(model, pipe, loop.TrainConfig(steps=1),
                       verbose=False)
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            loop.train(model, pipe, loop.TrainConfig(steps=1),
                       verbose=False)


def test_preset_configs_equal_reference():
    """``smoke | 100m | full`` of every config the reference has: its
    ``preset_config`` field for field (the 100m MoE and MLA overrides
    included)."""
    from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
    from repro.launch.train import preset_config as ref_preset
    from repro_torch.configs.base import HybridConfig
    from repro_torch.launch.train import preset_config
    # the port's HybridConfig adds the published Zamba2 form's fields, which
    # a config of the reference leaves at their defaults
    published = {f.name: f.default for f in dataclasses.fields(HybridConfig)
                 if f.name in ("layer_ids", "adapter_rank")}
    for arch in ARCH_NAMES:
        if arch not in REF_ARCH_NAMES:      # zamba2-7b: the port's alone
            continue
        for preset in ("smoke", "100m", "full"):
            mine = dataclasses.asdict(preset_config(arch, preset))
            if mine["hybrid"] is not None:
                for field, default in published.items():
                    assert mine["hybrid"].pop(field) == default, (arch, field)
            assert mine == dataclasses.asdict(ref_preset(arch, preset)), \
                (arch, preset)
    with pytest.raises(ValueError):
        preset_config("qwen2-0.5b", "7b")


@pytest.mark.parametrize("arch", ARCH_NAMES)
def test_launcher_trains_every_config_on_the_host(arch, tmp_path, capsys):
    """``python -m repro_torch.launch.train`` in-process with ``--device
    cpu`` at the smoke preset: finite losses, checkpoints written (the
    encoder-decoder fed stub frames)."""
    from repro_torch.distributed.checkpoint import latest_step
    from repro_torch.launch import train as launch
    hist = launch.main(["--arch", arch, "--preset", "smoke", "--steps", "2",
                        "--seq-len", "16", "--global-batch", "2",
                        "--device", "cpu", "--checkpoint-dir",
                        str(tmp_path), "--checkpoint-every", "1"])
    assert len(hist["loss"]) == 2 and np.isfinite(hist["loss"]).all()
    assert latest_step(str(tmp_path)) == 2
    assert "[launch] done" in capsys.readouterr().out
