"""The rest of the model zoo -- hybrid, MoE with MLA, encoder-decoder and
VLM -- against the reference, on the CPU.

As in ``tests/test_torch_models.py``: the reference's parameters
(``Model.init`` from a PRNG key) go to the port through
``convert.params_from_numpy``, and the same numpy inputs (tokens, and
``frames`` / ``patch_embeds`` where the family takes them) go through both
``Model``s.  The reference's kernel lowerings run their Pallas kernels in
interpret mode; the port's run the kernels' plain versions, as every wrapper
does for CPU tensors.  Compared: forward logits, prefill logits, every cache
leaf, and after ``pad_cache`` one ``decode_step``'s logits and every cache
leaf.

Tolerance: float32, ``rtol=1e-4`` and ``atol=1e-4`` times the largest
magnitude of the compared reference tensor; the port's own prefill + decode
== forward contract at ``2e-3`` (the reference's ``tests/test_models.py``).

Sizes: each family's smoke config (``configs.smoke_config``), and (in
``tests/test_torch_zoo_full.py``) its full head layout at two layers (the
hybrid: six Mamba2 layers in two groups of three, so that both shared blocks
are applied), vocab 256, float32.  Cut in
the full layouts, besides depth and vocab: every ``d_ff`` to 256 (MoE: the
dense layer's to 256 and each expert's and shared expert's to 64), the
hybrid's ``attn_every`` 6 -> 3, whisper's encoder frames 1500 -> 32, llava's
patches 576 -> 16.  Kept: d_model, heads, KV heads, head dims (zamba2's 80,
the MLA dims), SSM heads / head_dim / d_state / groups, all 64 of
deepseek-v2-lite's experts, top-6, its two shared experts and capacity
factor.  Attention projections whose fan-in the reference's initialisation
takes as the head count (``wq``, ``wk``; MLA's ``wq`` / ``wq_b`` and
``wkv_b``) are scaled by 1/8 in the full layouts, in both packages'
parameters, for the reason given in ``tests/test_torch_models.py`` (ROADMAP
Queue C P3).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ShapeCell as RefShapeCell
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.configs.base import HybridConfig as RefHybridConfig
from repro.configs.base import MoEConfig as RefMoEConfig
from repro.models import attention as ref_attn
from repro.models import common as ref_common
from repro.models import moe as ref_moe
from repro.models.api import Model as RefModel
from repro_torch import convert
from repro_torch.configs import ShapeCell, get_config, smoke_config
from repro_torch.configs.base import HybridConfig, MoEConfig
from repro_torch.models import attention, common, moe
from repro_torch.models.api import FAMILIES, build_model

TOL = 1e-4
CONTRACT = 2e-3
TEMPER = 0.125
B = 2

NEW = ("zamba2-2.7b", "deepseek-v2-lite-16b", "deepseek-v3-671b",
       "whisper-medium", "llava-next-mistral-7b")


def _close(got, want, what, tol=TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * scale,
                               err_msg=what)


def _full_layout(cfg, hybrid_cls, moe_cls):
    """Two layers of a full config's head layout (see the module
    docstring for what is cut); ``hybrid_cls`` / ``moe_cls`` are the
    package's own config dataclasses."""
    kw = dict(num_layers=2, vocab_size=256, d_ff=256,
              param_dtype="float32", compute_dtype="float32")
    if cfg.family == "hybrid":
        kw.update(num_layers=6, hybrid=hybrid_cls(
            attn_every=3,
            shared_attn_blocks=cfg.hybrid.shared_attn_blocks))
    if cfg.moe is not None:
        m = cfg.moe
        kw["moe"] = moe_cls(
            num_experts=m.num_experts, top_k=m.top_k, d_ff_expert=64,
            num_shared_experts=m.num_shared_experts, d_ff_shared=64,
            capacity_factor=m.capacity_factor,
            router_aux_coef=m.router_aux_coef,
            first_dense_layers=min(m.first_dense_layers, 1), d_ff_dense=256)
    if cfg.encdec is not None:
        kw["encdec"] = dataclasses.replace(cfg.encdec, encoder_layers=2,
                                           encoder_frames=32)
    if cfg.vlm is not None:
        kw["vlm"] = dataclasses.replace(cfg.vlm, num_patches=16)
    return dataclasses.replace(cfg, **kw)


def _configs(name, size):
    if size == "smoke":
        return ref_smoke_config(name), smoke_config(name)
    return (_full_layout(ref_get_config(name), RefHybridConfig, RefMoEConfig),
            _full_layout(get_config(name), HybridConfig, MoEConfig))


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


@functools.lru_cache(maxsize=2)
def _ref_params(name, size):
    """The reference's parameters as a numpy tree (tempered in the full
    layouts); cached, since the impls of one layout share them."""
    rcfg, _ = _configs(name, size)
    tree = jax.tree.map(np.asarray,
                        RefModel(rcfg).init(jax.random.PRNGKey(0)))
    tree = jax.tree.map(np.array, tree)               # writable copies
    if size == "full":
        _temper(tree)
    return tree


def _pair(name, size, impl):
    rcfg, cfg = _configs(name, size)
    tree = _ref_params(name, size)
    rmodel = RefModel(rcfg, impl=impl, remat="none")
    model = build_model(cfg, impl=impl, device="cpu")
    return (rmodel, jax.tree.map(jnp.asarray, tree), model,
            convert.params_from_numpy(cfg, tree, device="cpu"))


def _inputs(cfg, S, seed=0):
    """numpy inputs of one prompt: tokens [B, S] and the family's
    precomputed embeddings."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, 256, (B, S)).astype(np.int32)}
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
    return {k: torch.from_numpy(v).long() if k == "tokens"
            else torch.from_numpy(v) for k, v in batch.items()}


def _leaves_close(got, want, what):
    """Every leaf of the port's cache tree against the reference's, in the
    two trees' (sorted-key) order, paths and shapes equal."""
    want_paths = [jax.tree_util.keystr(p) for p, _ in
                  jax.tree_util.tree_flatten_with_path(want)[0]]
    got_leaves = common.tree_leaves(got)
    want_leaves = jax.tree.leaves(want)
    assert len(got_leaves) == len(want_leaves), what
    for path, g, w in zip(want_paths, got_leaves, want_leaves):
        _close(g.numpy(), w, f"{what}: cache {path}")


def _prefix(cfg):
    return cfg.vlm.num_patches if cfg.vlm is not None else 0


CASES = ([("zamba2-2.7b", impl) for impl in ("xla", "flash", "pallas")]
         + [("deepseek-v2-lite-16b", "xla"), ("deepseek-v2-lite-16b", "flash"),
            ("deepseek-v3-671b", "xla"),
            ("whisper-medium", "xla"), ("whisper-medium", "flash"),
            ("llava-next-mistral-7b", "xla"),
            ("llava-next-mistral-7b", "flash")])


def check_family(name, impl, size):
    """forward and prefill of one prompt (logits and every cache leaf),
    then one decode_step of a further token after pad_cache (logits and
    every cache leaf), at float32 1e-4.  Prompt lengths (patches included)
    are multiples of 16, so that the reference's Pallas flash kernel, whose
    wrapper halves its block until it divides the length, runs blocks of 16
    or more in interpret mode."""
    rmodel, rparams, model, params = _pair(name, size, impl)
    cfg = model.cfg
    S = 32 if size == "full" else 16
    batch = _inputs(cfg, S)
    what = f"{name}/{impl}/{size}"

    ref_full = np.asarray(rmodel.forward(rparams, _jax(batch)))
    full = model.forward(params, _torch(batch))
    _close(full.numpy(), ref_full, f"{what}: forward")

    rl, rc = rmodel.prefill(rparams, _jax(batch))
    pl, pc = model.prefill(params, _torch(batch))
    _close(pl.numpy(), rl, f"{what}: prefill logits")
    _leaves_close(pc, rc, f"{what}: prefill")

    P = _prefix(cfg)
    rc = rmodel.pad_cache(rc, P + S + 3)
    pc = model.pad_cache(pc, P + S + 3)
    step = np.random.default_rng(1).integers(0, 256, (B, 1)).astype(np.int32)
    rd, rc2 = rmodel.decode_step(rparams, rc, {
        "tokens": jnp.asarray(step), "pos": jnp.asarray(P + S, jnp.int32)})
    pd, pc2 = model.decode_step(params, pc, {
        "tokens": torch.from_numpy(step).long(), "pos": P + S})
    _close(pd.numpy(), rd, f"{what}: decode logits")
    _leaves_close(pc2, rc2, f"{what}: decode")


@pytest.mark.parametrize("name,impl", CASES)
def test_family_matches_reference(name, impl):
    """Each family's smoke config against the reference (the full head
    layouts: ``tests/test_torch_zoo_full.py``)."""
    check_family(name, impl, "smoke")


@pytest.mark.parametrize("name,impl", CASES)
def test_prefill_decode_matches_forward(name, impl):
    """prefill(prompt), then decode_step on the known next tokens, agrees
    with forward at 2e-3 (three steps, so the cache writes are exercised)."""
    cfg = smoke_config(name)
    model = build_model(cfg, impl=impl, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    S, n = 14, 11
    batch = _torch(_inputs(cfg, S, seed=3))
    tok = batch["tokens"]
    P = _prefix(cfg)
    full = model.forward(params, batch)
    logits, cache = model.prefill(params, dict(batch, tokens=tok[:, :n]))
    np.testing.assert_allclose(logits[:, 0].numpy(),
                               full[:, P + n - 1].numpy(), rtol=CONTRACT,
                               atol=CONTRACT)
    cache = model.pad_cache(cache, P + S + 2)
    for i in range(n, S):
        logits, cache = model.decode_step(
            params, cache, {"tokens": tok[:, i:i + 1], "pos": P + i})
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, P + i].numpy(), rtol=CONTRACT,
                                   atol=CONTRACT, err_msg=f"pos {i}")


# --------------------------------------------------------------------------- #
# MoE: routing before values
# --------------------------------------------------------------------------- #
def _ref_routing(p, x, cfg):
    """The routing lines of the reference's ``moe_forward``
    (``src/repro/models/moe.py:56-96``), run in jax: top-k experts, slot
    positions, the slot table and its fill."""
    m = cfg.moe
    Bx, S, _ = x.shape
    E, K = m.num_experts, m.top_k
    C = ref_moe.capacity_for(m, S)
    logits = jnp.einsum("bsd,de->bse", x, p["router"]).astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    gate_vals, expert_idx = jax.lax.top_k(probs, K)
    carry = jnp.zeros((Bx, E), jnp.int32)
    pos_list = []
    for k in range(K):
        oh = jax.nn.one_hot(expert_idx[:, :, k], E, dtype=jnp.int32)
        pos_in = jnp.cumsum(oh, axis=1) - oh + carry[:, None, :]
        pos_list.append(jnp.sum(pos_in * oh, axis=-1))
        carry = carry + jnp.sum(oh, axis=1)
    pos = jnp.stack(pos_list, axis=-1)
    valid = pos < C
    tok_idx = jnp.broadcast_to(jnp.arange(S)[None, :, None], (Bx, S, K))
    flat_e = expert_idx.reshape(Bx, S * K)
    flat_p = jnp.where(valid, pos, C).reshape(Bx, S * K)
    b_idx = jnp.broadcast_to(jnp.arange(Bx)[:, None], (Bx, S * K))
    slot_tok = jnp.zeros((Bx, E, C + 1), jnp.int32).at[
        b_idx, flat_e, flat_p].set(tok_idx.reshape(Bx, S * K), mode="drop")
    slot_fill = jnp.zeros((Bx, E, C + 1), x.dtype).at[
        b_idx, flat_e, flat_p].set(1.0, mode="drop")
    return {"gates": gate_vals, "experts": expert_idx, "pos": pos,
            "valid": valid, "slot_tok": slot_tok[:, :, :C],
            "slot_fill": slot_fill[:, :, :C]}


def _moe_case(name, S, seed):
    rcfg, cfg = _configs(name, "full")
    rng = np.random.default_rng(seed)
    D, E = cfg.d_model, cfg.moe.num_experts
    # a router of std 0.1 (logits of std ~4.5): uneven loads, so that
    # capacity overflows at the longer prompts
    p = {k: rng.normal(scale=0.1 if k == "router" else 0.02,
                       size=s).astype(np.float32) for k, s in (
        ("router", (D, E)), ("w_gate", (E, D, 64)), ("w_up", (E, D, 64)),
        ("w_down", (E, 64, D)))}
    Fs = 64 * cfg.moe.num_shared_experts
    for k, s in (("shared_gate", (D, Fs)), ("shared_up", (D, Fs)),
                 ("shared_down", (Fs, D))):
        p[k] = rng.normal(scale=0.02, size=s).astype(np.float32)
    x = rng.normal(size=(B, S, D)).astype(np.float32)
    return rcfg, cfg, p, x


@pytest.mark.parametrize("S,seed", ((8, 0), (40, 1), (256, 2)))
def test_moe_routing_then_values_match_reference(S, seed):
    """deepseek-v2-lite's router (64 experts, top-6, capacity factor 1.25):
    the experts chosen and their order, the slot of every assignment, the
    slot table and its fill equal the reference's; then the gates, the
    output and the aux loss at 1e-4.  S = 256 overflows capacity (C = 32
    slots for 256 x 6 / 64 = 24 per expert on average) and drops."""
    rcfg, cfg, p, x = _moe_case("deepseek-v2-lite-16b", S, seed)
    want = _ref_routing({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), rcfg)
    got = moe.route({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), cfg)
    for key in ("experts", "pos", "valid", "slot_tok", "slot_fill"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    if S == 256:
        assert not bool(got["valid"].all())
    ry, raux = ref_moe.moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                                   jnp.asarray(x), rcfg)
    y, aux = moe.moe_forward({k: torch.from_numpy(v) for k, v in p.items()},
                             torch.from_numpy(x), cfg)
    _close(y.numpy(), ry, "moe y")
    _close(aux.numpy(), raux, "moe aux")


def test_moe_top_k_breaks_ties_like_jax():
    """Equal gates (a zero router: every expert 1/E) and partial ties pick
    the lower expert index first, as ``jax.lax.top_k`` does; slot positions
    depend on that order."""
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.3, 0.3, 0.3],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs), 3)
    got_v, got_i = moe.top_k(torch.from_numpy(probs), 3)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_v.numpy(), np.asarray(want_v))
    rcfg, cfg, p, x = _moe_case("deepseek-v2-lite-16b", 16, 5)
    p["router"][:] = 0.0
    want = _ref_routing({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), rcfg)
    got = moe.route({k: torch.from_numpy(v) for k, v in p.items()},
                    torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(got["experts"].numpy(),
                                  np.broadcast_to(np.arange(6), (B, 16, 6)))
    for key in ("experts", "pos", "slot_tok", "slot_fill"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))


@pytest.mark.parametrize("S", (1, 8, 37, 64, 512))
def test_capacity_for_matches_reference(S):
    for name in ("deepseek-v2-lite-16b", "deepseek-v3-671b"):
        assert moe.capacity_for(get_config(name).moe, S) == \
            ref_moe.capacity_for(ref_get_config(name).moe, S)


# --------------------------------------------------------------------------- #
# MLA and cross attention, block by block
# --------------------------------------------------------------------------- #
def _mla_params(name, seed):
    _, cfg = _configs(name, "full")
    defs = attention.mla_defs(cfg)
    rng = np.random.default_rng(seed)
    out = {}
    for k, d in defs.items():
        if d.init == "ones":
            out[k] = np.ones(d.shape, np.float32)
        else:
            fan = d.shape[-2] if len(d.shape) > 1 else d.shape[0]
            scale = 1.0 / np.sqrt(d.shape[0] if len(d.shape) == 3 else fan)
            out[k] = rng.normal(scale=scale, size=d.shape).astype(np.float32)
    return cfg, out


@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "deepseek-v3-671b"))
def test_mla_blocks_match_reference(name):
    """mla_forward (expanded) and mla_decode (absorbed) at full MLA widths
    (q_lora 0 and 1536) against the reference's blocks at 1e-4."""
    cfg, p = _mla_params(name, 0)
    rcfg = _configs(name, "full")[0]
    rng = np.random.default_rng(1)
    S = 12
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    ry, rc = ref_attn.mla_forward(jp, jnp.asarray(x), rcfg)
    y, c = attention.mla_forward(tp, torch.from_numpy(x), cfg)
    _close(y.numpy(), ry, "mla_forward y")
    for key in ("c_kv", "k_rope"):
        _close(c[key].numpy(), rc[key], f"mla_forward {key}")
    cache = {k: torch.zeros((B, S + 4) + v.shape[2:]) for k, v in c.items()}
    rcache = {k: jnp.zeros((B, S + 4) + v.shape[2:]) for k, v in rc.items()}
    for k in cache:
        cache[k][:, :S - 1] = c[k][:, :S - 1]
        rcache[k] = rcache[k].at[:, :S - 1].set(rc[k][:, :S - 1])
    xd = x[:, S - 1:S]
    ryd, rcd = ref_attn.mla_decode(jp, jnp.asarray(xd), rcache,
                                   jnp.asarray(S - 1, jnp.int32), rcfg)
    yd, cd = attention.mla_decode(tp, torch.from_numpy(xd), cache, S - 1, cfg)
    _close(yd.numpy(), ryd, "mla_decode y")
    for key in ("c_kv", "k_rope"):
        _close(cd[key].numpy(), rcd[key], f"mla_decode {key}")


@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "deepseek-v3-671b"))
def test_mla_absorbed_decode_equals_expanded_forward(name):
    """The absorbed decode over the compressed cache computes what the
    expanded full-sequence form computes at the last position (2e-3)."""
    cfg, p = _mla_params(name, 2)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    S = 10
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(B, S, cfg.d_model)).astype(np.float32))
    y, c = attention.mla_forward(tp, x, cfg)
    cache = {k: torch.zeros((B, S) + v.shape[2:]) for k, v in c.items()}
    for k in cache:
        cache[k][:, :S - 1] = c[k][:, :S - 1]
    yd, cd = attention.mla_decode(tp, x[:, S - 1:], cache, S - 1, cfg)
    np.testing.assert_allclose(yd[:, 0].numpy(), y[:, -1].numpy(),
                               rtol=CONTRACT, atol=CONTRACT)
    for k in cache:
        np.testing.assert_allclose(cd[k].numpy(), c[k].numpy(),
                                   rtol=CONTRACT, atol=CONTRACT)


def test_gqa_cross_decode_matches_reference():
    _, cfg = _configs("whisper-medium", "smoke")
    rcfg = ref_smoke_config("whisper-medium")
    rng = np.random.default_rng(0)
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.resolved_head_dim
    p = {"wq": rng.normal(size=(D, H, hd)).astype(np.float32) / 8,
         "wo": rng.normal(size=(H, hd, D)).astype(np.float32) / 8}
    kv = {k: rng.normal(size=(B, 20, KV, hd)).astype(np.float32)
          for k in ("k", "v")}
    x = rng.normal(size=(B, 1, D)).astype(np.float32)
    want = ref_attn.gqa_cross_decode(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
        {k: jnp.asarray(v) for k, v in kv.items()}, rcfg)
    got = attention.gqa_cross_decode(
        {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x),
        {k: torch.from_numpy(v) for k, v in kv.items()}, cfg)
    _close(got.numpy(), want, "gqa_cross_decode")


@pytest.mark.parametrize("length,d", ((16, 64), (1500, 1024), (77, 30)))
def test_sinusoidal_positions_equal_reference(length, d):
    got = common.sinusoidal_positions(length, d)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(ref_common.sinusoidal_positions(length, d)))
    np.testing.assert_array_equal(
        common.sinusoidal_position(length, d, length - 1).numpy(),
        got[-1:].numpy())


# --------------------------------------------------------------------------- #
# layouts: parameters, caches, inputs
# --------------------------------------------------------------------------- #
def _shapes(defs):
    return jax.tree.map(lambda d: tuple(d.shape), defs,
                        is_leaf=lambda x: hasattr(x, "axes"))


@pytest.mark.parametrize("name", NEW)
def test_param_defs_and_count_follow_reference(name):
    """The full config's parameter tree (every path and shape) and count
    are the reference's."""
    port = build_model(get_config(name), device="cpu")
    ref = RefModel(ref_get_config(name))
    got = common.tree_map(lambda d: tuple(d.shape), port.param_defs())
    assert got == _shapes(ref.param_defs())
    assert port.param_count() == ref.param_count()


@pytest.mark.parametrize("name", NEW)
def test_init_splits_stacked_subtrees(name):
    """init() gives each stacked subtree as a list of per-layer dicts (the
    MTP block stays a single dict), deterministic in the seed, with the
    leaves' count equal to param_count."""
    model = build_model(smoke_config(name), device="cpu")
    params = model.init(7)
    again = model.init(torch.Generator().manual_seed(7))
    for key in common.STACKED:
        if key in params:
            assert isinstance(params[key], list) and params[key]
    flat = common.tree_leaves(params)
    assert sum(t.numel() for t in flat) == model.param_count()
    for a, b in zip(flat, common.tree_leaves(again)):
        assert torch.equal(a, b)
    if model.cfg.mtp:
        assert isinstance(params["mtp"]["block"], dict)


@pytest.mark.parametrize("name", NEW)
def test_cache_layout_and_pad_follow_reference(name):
    """cache_defs / init_cache give the reference's tree and shapes;
    pad_cache pads exactly the reference's tables along axis 2 (hybrid:
    only ``attn``; audio: only ``self``; MLA: ``c_kv`` / ``k_rope``) and
    leaves the rest as they are."""
    port = build_model(smoke_config(name), device="cpu")
    ref = RefModel(ref_smoke_config(name))
    want = _shapes(ref.cache_defs(3, 20))
    got = common.tree_map(lambda t: tuple(t.shape), port.init_cache(3, 20))
    assert got == want
    padded = port.pad_cache(port.init_cache(3, 20), 25)
    ref_padded = jax.tree.map(lambda a: a.shape, ref.pad_cache(
        ref.init_cache(3, 20), 25))
    assert common.tree_map(lambda t: tuple(t.shape), padded) == ref_padded
    cache = port.init_cache(3, 20)
    padded = port.pad_cache(cache, 25)
    if name.startswith("zamba2"):
        assert padded["ssm_layers"] is cache["ssm_layers"]
    if name.startswith("whisper"):
        assert padded["cross"] is cache["cross"]


@pytest.mark.parametrize("kind", ("prefill", "decode"))
@pytest.mark.parametrize("name", NEW)
def test_input_specs_and_make_inputs_follow_reference(name, kind):
    cell_args = ("c", 40, 3, kind)
    port = build_model(smoke_config(name), device="cpu")
    ref = RefModel(ref_smoke_config(name))
    want = {k: (tuple(s.shape), np.dtype(s.dtype).kind)
            for k, s in ref.input_specs(RefShapeCell(*cell_args)).items()}
    specs = port.input_specs(ShapeCell(*cell_args))
    assert {k: (s, "f" if d.is_floating_point else "i")
            for k, (s, d) in specs.items()} == want
    batch = port.make_inputs(ShapeCell(*cell_args),
                             torch.Generator().manual_seed(0))
    for k, (shape, dtype) in specs.items():
        assert tuple(batch[k].shape) == shape and batch[k].dtype == dtype
    if kind == "prefill":
        assert 0 <= int(batch["tokens"].min()) \
            and int(batch["tokens"].max()) < port.cfg.vocab_size
        logits, _ = port.prefill(port.init(0), batch)
        assert bool(torch.isfinite(logits).all())


def test_every_family_is_served():
    assert set(FAMILIES) == {"dense", "ssm", "hybrid", "moe", "audio", "vlm"}
    for name in NEW:
        assert build_model(name, device="cpu").cfg.family in FAMILIES


def test_moe_capacity_drops_make_dispatch_non_causal_in_both_packages():
    """ROADMAP Queue C R6.  Slots are given k-major over the whole sequence,
    so once assignments overflow an expert's capacity a later token's first
    choice can push out an earlier token's second: the reference's logits at
    the first S - 1 positions then depend on token S (forward over S tokens
    differs from forward over S - 1 there, at equal capacity C = 24), and
    prefill + decode cannot equal forward.  The port does what the reference
    does -- both forwards within 1e-4 of the reference's, drops included --
    and the dependence goes once nothing is dropped (capacity factor
    E / k)."""
    name, S = "deepseek-v2-lite-16b", 40
    rcfg, cfg = ref_smoke_config(name), smoke_config(name)
    rcfg = dataclasses.replace(rcfg, moe=dataclasses.replace(
        rcfg.moe, capacity_factor=1.0))
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=1.0))
    assert moe.capacity_for(cfg.moe, S) == moe.capacity_for(cfg.moe, S - 1)
    tree = jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(4)))
    rparams = jax.tree.map(jnp.asarray, tree)
    model = build_model(cfg, device="cpu")
    params = convert.params_from_numpy(cfg, tree, device="cpu")
    tok = _inputs(cfg, S, seed=6)["tokens"]

    def ref_forwards(rcfg_):
        rm = RefModel(rcfg_, remat="none")
        return [np.asarray(rm.forward(rparams, {"tokens": jnp.asarray(t)}))
                for t in (tok, tok[:, :-1])]

    full, short = ref_forwards(rcfg)
    assert np.abs(short - full[:, :-1]).max() > 1e-2     # not causal
    for t, want in ((tok, full), (tok[:, :-1], short)):
        _close(model.forward(params, {"tokens": torch.from_numpy(t).long()})
               .numpy(), want, f"forward over {t.shape[1]} with drops")
    m = rcfg.moe
    full, short = ref_forwards(dataclasses.replace(rcfg, moe=dataclasses.replace(
        m, capacity_factor=m.num_experts / m.top_k)))
    assert np.abs(short - full[:, :-1]).max() < CONTRACT
