"""The port's model zoo against the reference's, on the CPU.

The reference's parameters (``Model.init`` from a PRNG key) are handed to
the port as numpy arrays (``convert.params_from_numpy``); the same numpy
tokens go through both ``Model``s.  The reference's kernel lowerings
(``impl="flash"`` / ``"pallas"``) run their Pallas kernels in interpret
mode; the port's run the kernels' plain versions, as every wrapper does for
CPU tensors.

Tolerance: float32 throughout, ``rtol=1e-4`` and ``atol=1e-4`` times the
largest magnitude of the compared reference tensor (the two frameworks sum
the same products in other orders, so the error scales with the values).
The full-width qwen2 layout tempers ``wq`` / ``wk`` by 1/8 in both packages'
parameters: with the reference's initialisation (fan-in of ``wq [D, H, hd]``
taken as ``H``) attention scores reach a standard deviation of ~60, the
softmax is an argmax, and it turns float32 rounding of ``q . k`` (~2e-5
relative, equally far from float64 in both frameworks) into 3e-4 of the
logits; at 1/8 the scores are O(1), as in a trained model, and the layout
-- 14 query heads over 2 KV heads, head_dim 64, QKV bias -- is what is
under test.  The port's own prefill + decode == forward contract is held to
``2e-3``, as the reference's ``tests/test_models.py`` holds its own.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import MLAConfig as RefMLAConfig
from repro.models.api import Model as RefModel
from repro_torch import convert
from repro_torch.configs import ShapeCell, get_config, smoke_config
from repro_torch.configs.base import MLAConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.api import build_model

TOL = 1e-4


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _full_width(name: str, cfg):
    """Two layers of the full config's layout, vocab 256, float32."""
    kw = dict(num_layers=2, vocab_size=256, param_dtype="float32",
              compute_dtype="float32")
    if cfg.family == "dense":
        kw["d_ff"] = 256
    return dataclasses.replace(cfg, **kw)


def _configs(name: str, size: str):
    if size == "smoke":
        return ref_smoke_config(name), smoke_config(name)
    return (_full_width(name, ref_get_config(name)),
            _full_width(name, get_config(name)))


def _pair(name: str, size: str, impl: str):
    """Reference model + params, port model + the same params."""
    rcfg, cfg = _configs(name, size)
    rmodel = RefModel(rcfg, impl=impl, remat="none")
    rparams = rmodel.init(jax.random.PRNGKey(0))
    if size == "full" and cfg.family == "dense":
        layers = dict(rparams["layers"])
        attn = dict(layers["attn"])
        attn["wq"] = attn["wq"] * 0.125
        attn["wk"] = attn["wk"] * 0.125
        layers["attn"] = attn
        rparams = dict(rparams, layers=layers)
    model = build_model(cfg, impl=impl, device="cpu")
    params = convert.params_from_numpy(
        cfg, jax.tree.map(np.asarray, rparams), device="cpu")
    return rmodel, rparams, model, params


def _tokens(S: int, B: int = 2, seed: int = 0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)).astype(
        np.int32)


def _caches_close(got, want, what):
    """The port's stacked cache tree against the reference's."""
    for key in want["layers"]:
        _close(got["layers"][key].numpy(), want["layers"][key],
               f"{what}: cache {key}")


CASES = [("qwen2-0.5b", "xla"), ("qwen2-0.5b", "flash"),
         ("mamba2-130m", "xla"), ("mamba2-130m", "pallas")]


# --------------------------------------------------------------------------- #
# (b), (c): the port's Model against the reference's Model
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("size", ("smoke", "full"))
@pytest.mark.parametrize("name,impl", CASES)
def test_model_matches_reference(name, impl, size):
    """forward, prefill (logits and caches) and one decode_step after
    pad_cache, at float32 1e-4.  ``full`` runs the full config's head
    layout at two layers; mamba2's 300-token prompt then runs one SSD chunk
    of 300 (the odd-length fallback of ``ssm_forward``)."""
    rmodel, rparams, model, params = _pair(name, size, impl)
    S = 300 if (size == "full" and name.startswith("mamba2")) else \
        (64 if size == "full" else 16)
    tok = _tokens(S)
    what = f"{name}/{impl}/{size}"

    ref_full = np.asarray(rmodel.forward(rparams, {"tokens": jnp.asarray(tok)}))
    full = model.forward(params, {"tokens": torch.from_numpy(tok).long()})
    _close(full.numpy(), ref_full, f"{what}: forward")

    prompt = tok[:, :S - 1]
    rl, rc = rmodel.prefill(rparams, {"tokens": jnp.asarray(prompt)})
    pl, pc = model.prefill(params, {"tokens": torch.from_numpy(prompt).long()})
    _close(pl.numpy(), rl, f"{what}: prefill logits")
    _caches_close(pc, rc, f"{what}: prefill")

    rc = rmodel.pad_cache(rc, S + 3)
    pc = model.pad_cache(pc, S + 3)
    step = tok[:, S - 1:S]
    rd, rc2 = rmodel.decode_step(rparams, rc, {
        "tokens": jnp.asarray(step), "pos": jnp.asarray(S - 1, jnp.int32)})
    pd, pc2 = model.decode_step(params, pc, {
        "tokens": torch.from_numpy(step).long(), "pos": S - 1})
    _close(pd.numpy(), rd, f"{what}: decode logits")
    _caches_close(pc2, rc2, f"{what}: decode")


# --------------------------------------------------------------------------- #
# (d): the port's own serving contract
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("name,impl", CASES)
def test_prefill_decode_matches_forward(name, impl):
    """prefill(prompt), then decode_step on the known next tokens, agrees
    with forward at 2e-3 (three steps, so the cache writes are exercised)."""
    cfg = smoke_config(name)
    model = build_model(cfg, impl=impl, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    S, P = 14, 11
    tok = torch.from_numpy(_tokens(S, seed=3)).long()
    full = model.forward(params, {"tokens": tok})
    logits, cache = model.prefill(params, {"tokens": tok[:, :P]})
    np.testing.assert_allclose(logits[:, 0].numpy(), full[:, P - 1].numpy(),
                               rtol=2e-3, atol=2e-3)
    cache = model.pad_cache(cache, S + 2)
    for pos in range(P, S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tok[:, pos:pos + 1], "pos": pos})
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, pos].numpy(), rtol=2e-3,
                                   atol=2e-3, err_msg=f"pos {pos}")


def test_caches_keep_the_reference_layout():
    q = build_model(smoke_config("qwen2-0.5b"), device="cpu")
    m = build_model(smoke_config("mamba2-130m"), device="cpu")
    rq = RefModel(ref_smoke_config("qwen2-0.5b"))
    rm = RefModel(ref_smoke_config("mamba2-130m"))
    for port, ref in ((q, rq), (m, rm)):
        want = jax.tree.map(lambda d: d.shape, ref.cache_defs(3, 20),
                            is_leaf=lambda x: hasattr(x, "axes"))
        got = common.tree_map(lambda t: tuple(t.shape), port.init_cache(3, 20))
        assert got == want
    padded = q.pad_cache(q.init_cache(3, 20), 25)
    assert padded["layers"]["k"].shape == (2, 3, 25, 2, 16)
    state = m.init_cache(3, 20)
    assert m.pad_cache(state, 25) is state


def test_param_count_and_init_follow_the_reference():
    for name in ("qwen2-0.5b", "mamba2-130m"):
        full = build_model(get_config(name), device="cpu")
        assert full.param_count() == RefModel(ref_get_config(name)) \
            .param_count()
        model = build_model(smoke_config(name), device="cpu")
        params = model.init(7)
        again = model.init(torch.Generator().manual_seed(7))
        flat = common.tree_leaves(params)
        assert len(params["layers"]) == 2
        assert sum(t.numel() for t in flat) == model.param_count()
        for a, b in zip(flat, common.tree_leaves(again)):
            assert torch.equal(a, b)
    ones = params["layers"][0]["norm"]
    assert torch.equal(ones, torch.ones_like(ones))


def test_params_from_numpy_splits_the_stacked_layers():
    cfg = smoke_config("qwen2-0.5b")
    rmodel = RefModel(ref_smoke_config("qwen2-0.5b"))
    tree = jax.tree.map(np.asarray, rmodel.init(jax.random.PRNGKey(1)))
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    assert len(params["layers"]) == cfg.num_layers
    np.testing.assert_array_equal(
        params["layers"][1]["attn"]["wq"].numpy(),
        tree["layers"]["attn"]["wq"][1])
    np.testing.assert_array_equal(params["embed"].numpy(), tree["embed"])
    bf = convert.params_from_numpy(
        dataclasses.replace(cfg, param_dtype="bfloat16"),
        jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)),
                     tree), device="cpu")
    assert bf["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        bf["embed"].float().numpy(),
        np.asarray(jnp.asarray(tree["embed"], jnp.bfloat16), np.float32))
    # every stacked subtree of the other families, and nothing else
    for name, stacked in (("zamba2-2.7b", ("ssm_layers", "shared")),
                          ("deepseek-v3-671b", ("dense_layers", "layers")),
                          ("whisper-medium", ("enc_layers", "dec_layers"))):
        cfg = smoke_config(name)
        tree = jax.tree.map(np.asarray, RefModel(ref_smoke_config(name))
                            .init(jax.random.PRNGKey(2)))
        params = convert.params_from_numpy(cfg, tree, device="cpu")
        for key in stacked:
            n = len(jax.tree.leaves(tree[key])[0])
            assert isinstance(params[key], list) and len(params[key]) == n
            first = jax.tree.leaves(tree[key])[0][n - 1]
            np.testing.assert_array_equal(
                common.tree_leaves(params[key][n - 1])[0].numpy(), first)
        if "mtp" in tree:
            np.testing.assert_array_equal(
                params["mtp"]["block"]["ln1"].numpy(),
                tree["mtp"]["block"]["ln1"])


def test_kernel_lowerings_on_cpu_count_no_launch():
    """On CPU tensors every kernel lowering runs the plain version and
    counts no launch: qwen2 and whisper's decoder (flash), llava behind its
    patch prefix (flash), zamba2 under both impls, mamba2 (pallas)."""
    ops.reset_launch_counts()
    cell = ShapeCell("c", 12, 1, "prefill")
    for name, impl in (("qwen2-0.5b", "flash"), ("mamba2-130m", "pallas"),
                       ("zamba2-2.7b", "flash"), ("zamba2-2.7b", "pallas"),
                       ("whisper-medium", "flash"),
                       ("llava-next-mistral-7b", "flash")):
        model = build_model(smoke_config(name), impl=impl, device="cpu")
        params = model.init(0)
        model.prefill(params, model.make_inputs(
            cell, torch.Generator().manual_seed(0)))
    assert set(ops.launch_counts().values()) == {0}


# --------------------------------------------------------------------------- #
# (e): entry points
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("field", ("mla", "mtp"))
def test_dense_config_with_mla_or_mtp_follows_reference(field):
    """A dense config given MLA attention or an MTP head builds the
    reference's tree (MLA projections; the ``mtp`` subtree) and serves."""
    cfg = smoke_config("qwen2-0.5b")
    value = MLAConfig(q_lora_rank=0, kv_lora_rank=32, qk_nope_head_dim=16,
                      qk_rope_head_dim=8, v_head_dim=16) if field == "mla" \
        else True
    model = build_model(dataclasses.replace(cfg, **{field: value}),
                        device="cpu")
    rcfg = ref_smoke_config("qwen2-0.5b")
    rvalue = RefMLAConfig(**dataclasses.asdict(value)) if field == "mla" \
        else True
    ref = RefModel(dataclasses.replace(rcfg, **{field: rvalue}))
    shapes = jax.tree.map(lambda d: tuple(d.shape), ref.param_defs(),
                          is_leaf=lambda x: hasattr(x, "axes"))
    assert common.tree_map(lambda d: tuple(d.shape),
                           model.param_defs()) == shapes
    logits, _ = model.prefill(model.init(0), {
        "tokens": torch.zeros((1, 6), dtype=torch.long)})
    assert logits.shape == (1, 1, cfg.padded_vocab)


def test_unknown_impl_raises():
    with pytest.raises(ValueError, match="impl"):
        build_model(smoke_config("qwen2-0.5b"), impl="triton", device="cpu")
