"""The training path of the port against the reference's, on the CPU.

The reference's parameters (``Model.init`` from a PRNG key) go to the port
through ``convert.params_from_numpy``; the same numpy inputs (tokens, and
``frames`` / ``patch_embeds`` where the family takes them) go through both
packages.  Compared, each at the tolerance stated beside it:

- ``Model.loss`` and its gradient tree against ``jax.value_and_grad`` of
  the reference's ``Model.loss``, for every family's smoke config (float32;
  the loss at ``rtol=1e-5``, each gradient leaf in the stacked layout at
  ``1e-4`` of its largest magnitude);
- the three ``remat`` policies against each other (bit for bit);
- AdamW, clipping and the cosine schedule on random trees of float32 and
  bf16 leaves, and the set of decayed leaves of every config;
- 5 steps of ``make_train_step`` against the reference's jitted
  ``make_train_step`` on the same weights and batches (losses at
  ``rtol=1e-4``, parameters at ``1e-4`` of their scale);
- the data pipeline's batches, bit for bit.

The reference's own training cases, the loop, the kernel guard and the
launcher are ``tests/test_torch_train_loop.py``.

Inputs come from numpy seeds; sizes are the smoke configs
(``configs.smoke_config``).  The attention projections whose fan-in the
reference's initialisation takes as the head count (GQA ``wq`` / ``wk``,
MLA ``wq`` or ``wq_b`` and ``wkv_b``) are scaled by 1/8 in both packages'
weights, as in ``tests/test_torch_zoo.py``'s full layouts (ROADMAP Queue C
P3): untempered, the smoke scores reach a standard deviation of ~16, the
softmax is near an argmax and its backward cancels, so each float32
implementation is ~3e-4 of the scale from a float64 evaluation (zamba2's
shared ``wk``: the reference 6.0e-4, the port 2.8e-4).
``test_untempered_gradients_as_near_float64_as_reference`` keeps the
untempered weights and holds the port's float32 gradients to be about as
near float64 as the reference's.  The reference trains on ``impl="xla"`` (it
cannot differentiate through its Pallas kernels), so the port's training
path launches no kernel.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import smoke_config as ref_smoke_config
from repro.models.api import Model as RefModel
from repro.train import loop as ref_loop
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, smoke_config
from repro_torch.models import common
from repro_torch.models.api import Model, build_model
from repro_torch.train import loop, optimizer

LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
B, S = 2, 16

FAMILIES = ("qwen2-0.5b", "mamba2-130m", "zamba2-2.7b",
            "deepseek-v2-lite-16b", "deepseek-v3-671b", "whisper-medium",
            "llava-next-mistral-7b")


def _close(got, want, what, tol):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: {err:.3g} of scale > {tol}"


TEMPER = 0.125


def _temper(tree):
    """Scale, in place, the projections whose fan-in the reference takes as
    the head count: GQA ``wq`` / ``wk``, MLA ``wq`` or ``wq_b`` and
    ``wkv_b``."""
    if not isinstance(tree, dict):
        return
    if "wkv_b" in tree:
        keys = ("wq_b" if "wq_b" in tree else "wq", "wkv_b")
    elif "wq" in tree and "wk" in tree:
        keys = ("wq", "wk")
    else:
        keys = ()
    for key in keys:
        tree[key] = tree[key] * TEMPER
    for v in tree.values():
        _temper(v)


@functools.lru_cache(maxsize=None)
def _ref_params(name, tempered=True):
    rcfg = ref_smoke_config(name)
    tree = jax.tree.map(np.asarray, RefModel(rcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.array, tree)               # writable copies
    if tempered:
        _temper(tree)
    return tree


def _inputs(cfg, seed=0):
    """numpy inputs of one batch: tokens and the family's precomputed
    embeddings (a VLM's patches come before ``S - P`` tokens)."""
    rng = np.random.default_rng(seed)
    n_tok = S - (cfg.vlm.num_patches if cfg.vlm is not None else 0)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, n_tok)).astype(
        np.int32)}
    if cfg.encdec is not None:
        out["frames"] = rng.normal(
            size=(B, cfg.encdec.encoder_frames, cfg.d_model)).astype(
                np.float32)
    if cfg.vlm is not None:
        out["patch_embeds"] = rng.normal(
            size=(B, cfg.vlm.num_patches, cfg.d_model)).astype(np.float32)
    return out


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return loop.batch_to_device(batch, "cpu")


def _port_params(name):
    return convert.params_from_numpy(smoke_config(name), _ref_params(name),
                                     device="cpu")




def _stacked_numpy(tree):
    """A port tree (per-layer lists) in the reference's stacked layout as
    numpy arrays."""
    return common.tree_map(convert.tensor_to_numpy,
                           common.stack_stacked(tree))


def _flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@functools.lru_cache(maxsize=None)
def _ref_loss_and_grads(name):
    rmodel = RefModel(ref_smoke_config(name), remat="none")
    loss, grads = jax.jit(jax.value_and_grad(rmodel.loss))(
        jax.tree.map(jnp.asarray, _ref_params(name)),
        _jax(_inputs(rmodel.cfg)))
    return float(loss), _flat(grads)


@pytest.mark.parametrize("name", FAMILIES)
def test_loss_and_gradients_match_reference(name):
    """Float32: the loss at rtol 1e-5, every gradient leaf (stacked layout,
    same keys) at 1e-4 of the reference leaf's largest magnitude."""
    cfg = smoke_config(name)
    model = build_model(cfg, device="cpu", remat="none")
    loss, grads = loop.value_and_grad(model, _port_params(name),
                                       _torch(_inputs(cfg)))
    want_loss, want = _ref_loss_and_grads(name)
    assert float(loss) == pytest.approx(want_loss, rel=LOSS_TOL)
    got = _flat(_stacked_numpy(grads))
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key], f"{name} grad {key}", GRAD_TOL)


def _port_f64_grads(name, tree):
    cfg = dataclasses.replace(smoke_config(name), param_dtype="float64",
                              compute_dtype="float64")
    model = build_model(cfg, device="cpu", remat="none")
    batch = {k: v.double() if v.is_floating_point() else v
             for k, v in _torch(_inputs(cfg)).items()}
    _, grads = loop.value_and_grad(
        model, convert.params_from_numpy(cfg, tree, device="cpu"), batch)
    return _flat(_stacked_numpy(grads))


@pytest.mark.parametrize("name", ("qwen2-0.5b", "zamba2-2.7b"))
def test_untempered_gradients_as_near_float64_as_reference(name):
    """Untempered weights (see the module docstring): the port's float32
    gradients are about as near the port's float64 evaluation as the
    reference's float32 gradients are -- largest leaf error of the scale,
    within a factor of 3, as two float32 implementations with different
    reduction orders can be (measured: qwen2 6.5e-5 against the reference's
    3.0e-5, zamba2 2.8e-4 against 6.0e-4)."""
    tree = _ref_params(name, tempered=False)
    rmodel = RefModel(ref_smoke_config(name), remat="none")
    _, ref32 = jax.jit(jax.value_and_grad(rmodel.loss))(
        jax.tree.map(jnp.asarray, tree), _jax(_inputs(rmodel.cfg)))
    ref32 = _flat(ref32)
    model = build_model(smoke_config(name), device="cpu", remat="none")
    _, port32 = loop.value_and_grad(
        model, convert.params_from_numpy(model.cfg, tree, device="cpu"),
        _torch(_inputs(model.cfg)))
    port32 = _flat(_stacked_numpy(port32))
    f64 = _port_f64_grads(name, tree)

    def err(got):
        return max(float(np.abs(got[k] - f64[k]).max())
                   / max(float(np.abs(f64[k]).max()), 1e-30) for k in f64)
    assert err(port32) <= 3 * err(ref32), (err(port32), err(ref32))


# --------------------------------------------------------------------------- #
# remat
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("remat", ("dots", "full"))
@pytest.mark.parametrize("name", FAMILIES)
def test_remat_changes_no_value(name, remat):
    """``"dots"`` and ``"full"`` give the loss and every gradient of
    ``"none"`` bit for bit."""
    cfg = smoke_config(name)
    batch = _torch(_inputs(cfg))
    out = {}
    for r in ("none", remat):
        model = build_model(cfg, device="cpu", remat=r)
        out[r] = loop.value_and_grad(model, _port_params(name), batch)
    assert torch.equal(out["none"][0], out[remat][0])
    for a, b in zip(common.tree_leaves(out["none"][1]),
                    common.tree_leaves(out[remat][1])):
        assert torch.equal(a, b)


def test_dots_policy_saves_products_without_batch_dims():
    """``jax.checkpoint_policies.dots_with_no_batch_dims_saveable``: a
    projection (``mm``, or ``bmm`` over one batch, as ``torch.einsum``
    issues ``bsd,de->bse``) is saved; attention scores and the experts'
    grouped products (``bmm`` over several batches) and everything else are
    recomputed."""
    from torch.utils.checkpoint import CheckpointPolicy
    aten = torch.ops.aten
    x = torch.zeros(1, 4, 4)
    y = torch.zeros(3, 4, 4)
    save = CheckpointPolicy.MUST_SAVE
    assert common._save_dots(None, aten.mm.default, x[0], x[0]) == save
    assert common._save_dots(None, aten.bmm.default, x, x) == save
    assert common._save_dots(None, aten.bmm.default, y, y) != save
    assert common._save_dots(None, aten.exp.default, y) != save
    with pytest.raises(ValueError, match="remat"):
        Model(smoke_config("qwen2-0.5b"), device="cpu", remat="some")


# --------------------------------------------------------------------------- #
# optimizer
# --------------------------------------------------------------------------- #
OPT_DTYPES = {"w": (np.float32, (6, 8)), "b": (np.float32, (8,)),
              "e": (jnp.bfloat16, (16, 4)), "n": (jnp.bfloat16, (5,)),
              "s": (np.float32, (3, 2, 4))}


def _random_trees(seed):
    """(reference trees, port trees) of params and grads: float32 and bf16
    leaves of rank 1 to 3, the port's bf16 leaves from the same bits."""
    rng = np.random.default_rng(seed)
    ref_p, ref_g = {}, {}
    for k, (dt, shape) in OPT_DTYPES.items():
        ref_p[k] = jnp.asarray(rng.normal(size=shape).astype(np.float32),
                               dtype=dt)
        ref_g[k] = jnp.asarray((rng.normal(size=shape) * 3).astype(
            np.float32), dtype=dt)

    def port(tree):
        return {k: convert._array_to_torch(np.asarray(v))
                for k, v in tree.items()}
    return (ref_p, ref_g), (port(ref_p), port(ref_g))


def _same(got, want, what, tol):
    """A port leaf against a reference leaf: equal dtype names; float32
    within ``tol`` of the scale, bf16 within one bf16 ulp of it."""
    want = np.asarray(want)
    assert str(got.dtype).split(".")[-1] == want.dtype.name, what
    if want.dtype.name == "bfloat16":
        tol = max(tol, 2.0 ** -8)
    _close(convert.tensor_to_numpy(got), want.astype(np.float32), what, tol)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_adamw_matches_reference(seed):
    """Three AdamW steps on random trees (float32 moments; params cast back
    to float32 / bf16): params at 1e-6 of their scale (bf16: one ulp),
    moments at 1e-6, the step counter equal."""
    (rp, rg), (pp, pg) = _random_trees(seed)
    rs, ps = ref_opt.adamw_init(rp), optimizer.adamw_init(pp)
    for i in range(3):
        lr = 1e-2 * (i + 1)
        rp, rs = ref_opt.adamw_update(rp, rg, rs, lr=jnp.asarray(lr))
        pp, ps = optimizer.adamw_update(pp, pg, ps, lr=torch.tensor(lr))
    assert int(ps.step) == int(rs.step) == 3
    assert ps.step.dtype == torch.int32
    for k in OPT_DTYPES:
        _same(pp[k], rp[k], f"param {k}", 1e-6)
        _same(ps.m[k], rs.m[k], f"m {k}", 1e-6)
        _same(ps.v[k], rs.v[k], f"v {k}", 1e-6)


@pytest.mark.parametrize("max_norm", (0.5, 1.0, 1e3))
def test_clip_by_global_norm_matches_reference(max_norm):
    (_, rg), (_, pg) = _random_trees(5)
    r_clip, r_norm = ref_opt.clip_by_global_norm(rg, max_norm)
    p_clip, p_norm = optimizer.clip_by_global_norm(pg, max_norm)
    assert float(p_norm) == pytest.approx(float(r_norm), rel=1e-6)
    for k in OPT_DTYPES:
        _same(p_clip[k], r_clip[k], f"clipped {k}", 1e-6)


@pytest.mark.parametrize("warmup,total", ((10, 100), (0, 50), (20, 20)))
def test_cosine_schedule_matches_reference(warmup, total):
    for t in range(total + 5):
        want = float(ref_opt.cosine_schedule(
            jnp.asarray(t, jnp.int32), peak_lr=3e-4, warmup=warmup,
            total=total))
        got = float(optimizer.cosine_schedule(
            torch.tensor(t, dtype=torch.int32), peak_lr=3e-4,
            warmup=warmup, total=total))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-12), t


def _decayed(flat_ranks):
    return {k for k, r in flat_ranks.items() if r >= 2}


# the configs both packages have: the published Zamba2 (zamba2-7b) is the
# port's alone, with no reference to pair it with
PAIRED = [a for a in ARCH_NAMES if a in REF_ARCH_NAMES]


@pytest.mark.parametrize("name", PAIRED)
def test_decayed_leaves_equal_reference(name):
    """AdamW decays a leaf of stacked rank >= 2, as the reference does:
    the port's ``decay_mask`` (per-layer lists) names the reference's set,
    per-layer norms and Mamba2's per-head vectors included."""
    from repro.configs import get_config as ref_get_config
    specs = RefModel(ref_get_config(name)).param_specs()
    want = _decayed({jax.tree_util.keystr(p): len(s.shape) for p, s in
                     jax.tree_util.tree_flatten_with_path(specs)[0]})
    mask = Model(ARCH_CFG(name), device="cpu").decay_mask()
    stacked = {k: v[0] if k in common.STACKED else v
               for k, v in mask.items()}
    got = {jax.tree_util.keystr(p) for p, d in
           jax.tree_util.tree_flatten_with_path(stacked)[0] if d}
    assert got == want
    for k in common.STACKED:
        if k in mask:
            assert all(m == mask[k][0] for m in mask[k])
    cfg = ARCH_CFG(name)
    if cfg.family in ("dense", "moe", "vlm"):
        assert "['layers']['ln1']" in got
    if cfg.family == "ssm":
        assert {"['layers']['A_log']", "['layers']['D_skip']",
                "['layers']['dt_bias']"} <= got
        assert "['final_norm']" not in got


def ARCH_CFG(name):
    from repro_torch.configs import get_config
    return get_config(name)


def test_adamw_decays_stacked_norms_like_reference():
    """One AdamW step on converted mamba2 smoke weights: every leaf,
    per-layer norms included, within 1e-6 of the reference's
    step in the stacked layout (a literal ``p.dim() >= 2`` would skip the
    decay of the 1-D pieces)."""
    name = "mamba2-130m"
    tree = _ref_params(name)
    rng = np.random.default_rng(3)
    grads = jax.tree.map(lambda a: rng.normal(size=a.shape).astype(
        np.float32), tree)
    rp, _ = ref_opt.adamw_update(
        jax.tree.map(jnp.asarray, tree), jax.tree.map(jnp.asarray, grads),
        ref_opt.adamw_init(tree), lr=jnp.asarray(0.1))
    cfg = smoke_config(name)
    pp = convert.params_from_numpy(cfg, tree, device="cpu")
    pg = convert.params_from_numpy(cfg, grads, device="cpu")
    model = Model(cfg, device="cpu")
    new, _ = optimizer.adamw_update(pp, pg, optimizer.adamw_init(pp),
                                    lr=torch.tensor(0.1),
                                    decay=model.decay_mask())
    got, want = _flat(convert.params_to_numpy(cfg, new)), _flat(rp)
    for key in want:
        _close(got[key], want[key], key, 1e-6)
    literal, _ = optimizer.adamw_update(pp, pg, optimizer.adamw_init(pp),
                                        lr=torch.tensor(0.1))
    literal = _flat(convert.params_to_numpy(cfg, literal))
    assert not np.allclose(literal["['layers']['norm']"],
                           want["['layers']['norm']"])


# --------------------------------------------------------------------------- #
# trajectory
# --------------------------------------------------------------------------- #
TRAJ = dict(steps=5, warmup=2, peak_lr=3e-3)


def _ref_trajectory(name, compress, batches, jit):
    """The reference's parameters after ``make_train_step`` over
    ``batches`` from the converted weights, jitted or op by op."""
    from repro.distributed import compression as ref_comp
    tc = ref_loop.TrainConfig(**TRAJ, compress_grads=compress)
    step = ref_loop.make_train_step(RefModel(ref_smoke_config(name)), tc,
                                    compress)
    step = jax.jit(step) if jit else step
    rp = jax.tree.map(jnp.asarray, _ref_params(name))
    rs = ref_opt.adamw_init(rp)
    rc = ref_comp.init_state(rp) if compress else None
    losses = []
    for batch in batches:
        rp, rs, rc, rm = step(rp, rs, _jax(batch), rc)
        losses.append((float(rm["loss"]), float(rm["lr"])))
    return _flat(rp), losses


@pytest.mark.parametrize("name,compress", (("qwen2-0.5b", False),
                                           ("mamba2-130m", True)))
def test_train_steps_match_reference(name, compress):
    """5 steps of ``make_train_step`` against the reference's jitted
    ``make_train_step`` on the same converted weights and pipeline batches
    (``remat="dots"`` on both sides, int8 compression for mamba2): losses
    at rtol 1e-4, the final parameters at 1e-4 of each leaf's scale.

    Adam divides each element's step by that element's own gradient RMS,
    so an element whose gradient is a near-cancelling sum (qwen2's key
    bias ``bk``: its median gradient is 1e-2 of its largest, known to 9 %
    in float32 although the leaf is within 1e-6 of its scale) carries its
    rounding into a full-size step.  A leaf above 1e-4 is therefore held to
    the reference's own reproducibility instead: no further from the jitted
    reference than the reference's op-by-op run of the same steps is
    (qwen2's ``bk``: the port 2.3e-4, the reference's own runs 3.9e-4)."""
    from repro.data.pipeline import DataPipeline as RefPipeline
    from repro_torch.distributed import compression as comp
    cfg = smoke_config(name)
    pipe = RefPipeline(vocab_size=cfg.vocab_size, seq_len=S, global_batch=B)
    batches = [pipe.next_batch() for _ in range(TRAJ["steps"])]
    want, want_losses = _ref_trajectory(name, compress, batches, jit=True)

    p_step = loop.make_train_step(
        Model(cfg, device="cpu"),
        loop.TrainConfig(**TRAJ, compress_grads=compress), compress)
    pp = convert.params_from_numpy(cfg, _ref_params(name), device="cpu")
    ps = optimizer.adamw_init(pp)
    pc = comp.init_state(pp) if compress else None
    for i, (batch, (loss, lr)) in enumerate(zip(batches, want_losses)):
        pp, ps, pc, pm = p_step(pp, ps, _torch(batch), pc)
        assert float(pm["loss"]) == pytest.approx(loss, rel=1e-4), i
        assert float(pm["lr"]) == pytest.approx(lr, rel=1e-6), i
    got = _flat(convert.params_to_numpy(cfg, pp))
    assert sorted(got) == sorted(want)
    eager = None
    for key in want:
        scale = float(np.abs(want[key]).max())
        err = float(np.abs(got[key] - want[key]).max()) / scale
        if err > 1e-4:
            if eager is None:
                eager, _ = _ref_trajectory(name, compress, batches, jit=False)
            own = float(np.abs(eager[key] - want[key]).max()) / scale
            assert err <= own, f"{name} {key}: {err:.3g} > {own:.3g}"
    moved = _flat(_ref_params(name))
    assert any(not np.allclose(want[k], moved[k]) for k in want)


# --------------------------------------------------------------------------- #
# data pipeline
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,shard,num_shards", ((0, 0, 1), (7, 0, 1),
                                                   (12345, 1, 2),
                                                   (3, 3, 4)))
def test_pipeline_batches_equal_reference(seed, shard, num_shards):
    """Batches bit-equal to the reference's for the seed and shard, from
    the start and after a restore to step 5."""
    from repro.data.pipeline import DataPipeline as RefPipeline
    from repro_torch.data.pipeline import DataPipeline
    kw = dict(vocab_size=1000, seq_len=64, global_batch=8, seed=seed,
              shard=shard, num_shards=num_shards, mean_doc_len=16)
    ref, port = RefPipeline(**kw), DataPipeline(**kw)
    for _ in range(6):
        a, b = ref.next_batch()["tokens"], port.next_batch()["tokens"]
        assert a.dtype == b.dtype and np.array_equal(a, b)
    assert port.state_dict() == ref.state_dict() == {"step": 6}
    ref.restore({"step": 5})
    port.restore({"step": 5})
    assert np.array_equal(ref.next_batch()["tokens"],
                          port.next_batch()["tokens"])
