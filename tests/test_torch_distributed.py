"""The port's distribution substrate against the reference's, on the CPU:
int8 gradient compression, checkpoints, sharding specs, mesh shapes.

- Compression: ``q`` and ``scale`` bit-equal to the reference's on the same
  float32 inputs, and over several error-feedback steps, the L per-layer
  pieces of a stacked leaf sharing the stacked tensor's one scale.
- Checkpoints, both directions, bit for bit: the reference saves (bf16
  params, the AdamW state) and the port restores into its per-layer lists,
  and the port saves and the reference restores; and the reference's own
  cases (atomic commit, missing leaf, shape mismatch, extra state, latest
  step).
- Sharding: the port's specs equal the reference's ``PartitionSpec``s
  entry for entry for every config both packages have, at both production
  meshes, under ``DEFAULT_RULES`` and ``DECODE_SEQ_SHARD``, for parameters
  and decode caches; ``spec_report`` lines equal.
- The reference's ``tests/test_distributed.py``, run on the port.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro.configs import get_config as ref_get_config
from repro.configs import smoke_config as ref_smoke_config
from repro.distributed import checkpoint as ref_ckpt
from repro.distributed import compression as ref_comp
from repro.distributed import sharding as ref_shard
from repro.models.api import Model as RefModel
from repro.train import optimizer as ref_opt
from repro_torch import convert
from repro_torch.configs import ARCH_NAMES, get_config, smoke_config
from repro_torch.distributed import checkpoint as ckpt
from repro_torch.distributed import compression as comp
from repro_torch.distributed import sharding as shard
from repro_torch.launch.mesh import (MeshShape, make_debug_mesh,
                                     make_production_mesh)
from repro_torch.models import common
from repro_torch.models.api import Model
from repro_torch.train import optimizer


class FakeMesh:
    """Just enough of a Mesh for spec_for (shape lookup)."""
    def __init__(self, **axes):
        self.shape = dict(axes)


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint8 if x.itemsize == 1 else np.uint32
                  if x.itemsize == 4 else np.uint16)


# --------------------------------------------------------------------------- #
# compression
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("seed,shape,scale", ((0, (256, 64), 1.0),
                                              (1, (1000,), 1e-6),
                                              (2, (3, 5, 7), 1e4),
                                              (3, (17,), 0.0)))
def test_int8_q_and_scale_bit_equal_reference(seed, shape, scale):
    """Same float32 input: ``q`` and ``scale`` bit for bit (ties at .5
    included: round half to even in both), and the dequantized values."""
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * scale).astype(np.float32)
    x.flat[:4] = np.float32(0.5) * np.abs(x).max() / np.float32(127.0) \
        * np.array([1, 3, -5, 7], np.float32)        # exact half-steps
    rq, rs = ref_comp.compress_int8(jnp.asarray(x))
    q, s = comp.compress_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert np.array_equal(q.numpy(), np.asarray(rq))
    assert np.array_equal(_bits(s.numpy()), _bits(rs))
    assert np.array_equal(
        _bits(comp.decompress_int8(q, s).numpy()),
        _bits(ref_comp.decompress_int8(rq, rs)))


def test_error_feedback_bit_equal_reference_over_steps():
    """Ten ``compressed_gradients`` steps on a tree with a stacked subtree:
    the port's per-layer pieces of ``layers/w`` share the stacked tensor's
    scale, so the compressed gradients and the error accumulators stay the
    reference's bit for bit (stacked layout)."""
    rng = np.random.default_rng(1)
    L = 3
    r_state = p_state = None
    for step in range(10):
        ref = {"embed": rng.normal(size=(8, 4)).astype(np.float32),
               "layers": {"w": (rng.normal(size=(L, 4, 4))
                                * np.array([1e-3, 1.0, 10.0])[:, None, None]
                                ).astype(np.float32)}}
        port = {"embed": torch.from_numpy(ref["embed"]),
                "layers": [{"w": torch.from_numpy(ref["layers"]["w"][i])}
                           for i in range(L)]}
        if step == 0:
            r_state = ref_comp.init_state(ref)
            p_state = comp.init_state(port)
        r_g, r_state = ref_comp.compressed_gradients(
            jax.tree.map(jnp.asarray, ref), r_state)
        p_g, p_state = comp.compressed_gradients(port, p_state)
        for got, want in ((p_g, r_g), (p_state.error, r_state.error)):
            got = common.tree_map(lambda t: t.numpy(),
                                  common.stack_stacked(got))
            for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
                assert np.array_equal(_bits(a), _bits(b)), step


def test_int8_compression_bounded_error():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256, 64)).astype(np.float32))
    q, scale = comp.compress_int8(x)
    assert q.dtype == torch.int8
    err = (comp.decompress_int8(q, scale) - x).abs()
    assert float(err.max()) <= float(scale) * 0.5 + 1e-7


def test_error_feedback_is_unbiased_over_time():
    """Σ compressed grads → Σ true grads (error feedback carries residual)."""
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.normal(size=(32,)).astype(np.float32)
                              * 1e-3) for _ in range(50)]
    state = comp.init_state({"g": grads[0]})
    acc = np.zeros(32)
    for g in grads:
        cg, state = comp.compressed_gradients({"g": g}, state)
        acc += cg["g"].numpy()
    true = np.sum([g.numpy() for g in grads], axis=0)
    resid = np.abs(acc + state.error["g"].numpy() - true)
    assert resid.max() < 1e-4


# --------------------------------------------------------------------------- #
# checkpoints, both directions
# --------------------------------------------------------------------------- #
NAME = "qwen2-0.5b"


def _bf16_cfgs():
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16")
    return (dataclasses.replace(ref_smoke_config(NAME), **kw),
            dataclasses.replace(smoke_config(NAME), **kw))


def _ref_state(seed):
    """Reference bf16 smoke params and an AdamW state after one step."""
    rcfg, _ = _bf16_cfgs()
    params = RefModel(rcfg).init(jax.random.PRNGKey(seed))
    grads = jax.tree.map(lambda p: jnp.full(p.shape, 0.5, p.dtype), params)
    return ref_opt.adamw_update(params, grads, ref_opt.adamw_init(params),
                                lr=jnp.asarray(0.01))


def _port_template():
    _, cfg = _bf16_cfgs()
    params = Model(cfg, device="cpu").init(0)
    return {"params": params, "opt_state": optimizer.adamw_init(params)}


def _flat_ref(tree):
    return {jax.tree_util.keystr(p): np.asarray(x) for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _flat_port(state):
    """A port payload as the reference's flat ``keystr -> array`` map
    (bf16 as its uint16 bits)."""
    out = {}
    for k, v in ckpt._flatten(state).items():
        out[k] = ckpt._encode(v)[0]
    return out


def test_reference_checkpoint_restores_in_port(tmp_path):
    """reference save -> port restore: every leaf (bf16 params, float32
    moments, the int32 step) bit for bit, per-layer pieces split off the
    stacked arrays, the pipeline state in ``extra``."""
    params, opt = _ref_state(1)
    ref_ckpt.save_checkpoint(str(tmp_path), 3, params, opt_state=opt,
                             extra={"pipeline": {"step": 3}})
    state, step, extra = ckpt.restore_checkpoint(str(tmp_path),
                                                 _port_template())
    assert step == 3 and extra == {"pipeline": {"step": 3}}
    assert isinstance(state["opt_state"], optimizer.AdamWState)
    assert isinstance(state["params"]["layers"], list)
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt_state"].step.dtype == torch.int32
    want = _flat_ref({"params": params, "opt_state": opt})
    got = _flat_port(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k


def test_port_checkpoint_restores_in_reference(tmp_path):
    """port save -> reference restore: the reference's keys, dtypes
    (``bfloat16`` through its uint16 encoding) and values bit for bit."""
    _, cfg = _bf16_cfgs()
    model = Model(cfg, device="cpu")
    params = model.init(5)
    grads = common.tree_map(lambda p: torch.full_like(p, 0.25), params)
    params, opt = optimizer.adamw_update(
        params, grads, optimizer.adamw_init(params), lr=torch.tensor(0.01),
        decay=model.decay_mask())
    ckpt.save_checkpoint(str(tmp_path), 9, params, opt_state=opt,
                         extra={"pipeline": {"step": 9}})
    assert not any(p.startswith(".tmp") for p in os.listdir(tmp_path))
    rcfg, _ = _bf16_cfgs()
    rparams = RefModel(rcfg).param_specs()
    template = {"params": rparams,
                "opt_state": ref_opt.AdamWState(
                    step=jax.ShapeDtypeStruct((), jnp.int32),
                    m=jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                        s.shape, jnp.float32), rparams),
                    v=jax.tree.map(lambda s: jax.ShapeDtypeStruct(
                        s.shape, jnp.float32), rparams))}
    state, step, extra = ref_ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 9 and extra == {"pipeline": {"step": 9}}
    assert state["params"]["embed"].dtype == jnp.bfloat16
    want = _flat_port({"params": params, "opt_state": opt})
    got = _flat_ref(state)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(_bits(got[k]), _bits(want[k])), k
    assert int(state["opt_state"].step) == 1


def test_checkpoint_missing_leaf_and_shape_mismatch_raise(tmp_path):
    """The reference's messages: ``KeyError`` naming the missing leaf's
    path, ``ValueError`` with both (stacked) shapes."""
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros(4),
                                            "layers": [{"a": torch.ones(2)}
                                                       for _ in range(3)]})
    with pytest.raises(KeyError, match=r"checkpoint missing leaf "
                                       r"\['params'\]\['x'\]"):
        ckpt.restore_checkpoint(str(tmp_path), {"params": {
            "w": torch.zeros(4), "x": torch.zeros(1)}})
    with pytest.raises(ValueError, match=r"\['params'\]\['w'\]: checkpoint "
                                         r"shape \(4,\) != model shape"):
        ckpt.restore_checkpoint(str(tmp_path), {"params": {
            "w": torch.zeros(5)}})
    with pytest.raises(ValueError, match=r"shape \(3, 2\) != model shape "
                                         r"\(2, 2\)"):
        ckpt.restore_checkpoint(str(tmp_path), {"params": {
            "w": torch.zeros(4), "layers": [{"a": torch.ones(2)}] * 2}})
    state, _, _ = ckpt.restore_checkpoint(str(tmp_path), {"params": {
        "w": torch.zeros(4), "layers": [{"a": torch.zeros(2)}] * 3}})
    assert all(torch.equal(x["a"], torch.ones(2))
               for x in state["params"]["layers"])


def test_checkpoint_manifest_and_latest(tmp_path):
    """The manifest holds the reference's fields, ``latest_step`` the
    newest committed step, and ``step=`` picks an older one."""
    import json
    params = {"w": torch.arange(12.0).reshape(3, 4)}
    ckpt.save_checkpoint(str(tmp_path), 10, params)
    ckpt.save_checkpoint(str(tmp_path), 20, {"w": params["w"] * 2})
    assert ckpt.latest_step(str(tmp_path)) == 20
    man = json.loads((tmp_path / "step_00000010" / "manifest.json")
                     .read_text())
    assert set(man) == {"step", "treedef", "keys", "dtypes", "extra"}
    assert man["keys"] == ["['params']['w']"]
    assert man["dtypes"] == {"['params']['w']": "float32"}
    state, step, _ = ckpt.restore_checkpoint(
        str(tmp_path), {"params": {"w": torch.zeros(3, 4)}}, step=10)
    assert step == 10 and torch.equal(state["params"]["w"], params["w"])
    assert ckpt.restore_checkpoint(str(tmp_path / "none"), {}) == \
        (None, None, {})


# the reference's own checkpoint cases (tests/test_distributed.py)
def test_checkpoint_roundtrip_and_latest(tmp_path):
    params = {"w": torch.arange(12.0).reshape(3, 4),
              "nested": {"b": torch.ones(5, dtype=torch.bfloat16)}}
    ckpt.save_checkpoint(str(tmp_path), 10, params)
    ckpt.save_checkpoint(str(tmp_path), 20, params)
    assert ckpt.latest_step(str(tmp_path)) == 20
    template = {"params": common.tree_map(
        lambda x: common.TensorSpec(tuple(x.shape), x.dtype), params)}
    state, step, _ = ckpt.restore_checkpoint(str(tmp_path), template)
    assert step == 20
    assert torch.equal(state["params"]["w"], params["w"])
    assert state["params"]["nested"]["b"].dtype == torch.bfloat16


def test_checkpoint_atomic_no_tmp_left(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    leftovers = [p for p in os.listdir(tmp_path) if p.startswith(".tmp")]
    assert not leftovers


def test_checkpoint_failed_write_leaves_nothing(tmp_path, monkeypatch):
    """A crash mid-write removes its ``.tmp_`` directory and commits
    nothing: the previous checkpoint stays the latest."""
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckpt.np, "savez", boom)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(tmp_path), 2, {"w": torch.ones((4,))})
    assert sorted(os.listdir(tmp_path)) == ["step_00000001"]
    assert ckpt.latest_step(str(tmp_path)) == 1


def test_checkpoint_shape_mismatch_raises(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 1, {"w": torch.zeros((4,))})
    template = {"params": {"w": common.TensorSpec((5,), torch.float32)}}
    with pytest.raises(ValueError):
        ckpt.restore_checkpoint(str(tmp_path), template)


def test_checkpoint_extra_state(tmp_path):
    ckpt.save_checkpoint(str(tmp_path), 7, {"w": torch.zeros(3)},
                         extra={"pipeline": {"step": 7}})
    template = {"params": {"w": common.TensorSpec((3,), torch.float32)}}
    _, _, extra = ckpt.restore_checkpoint(str(tmp_path), template)
    assert extra == {"pipeline": {"step": 7}}


# --------------------------------------------------------------------------- #
# sharding
# --------------------------------------------------------------------------- #
MESHES = {"pod": (("data", "model"), (16, 16)),
          "multi_pod": (("pod", "data", "model"), (2, 16, 16))}
RULES = {"default": ref_shard.DEFAULT_RULES,
         "decode_seq": ref_shard.DECODE_SEQ_SHARD}


def _ref_specs(axes, shapes, mesh, rules):
    flat_a = jax.tree.leaves(axes, is_leaf=lambda x: isinstance(x, tuple))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    return {jax.tree_util.keystr(p): ref_shard.spec_for(
        tuple(s.shape), a, mesh, rules) for (p, s), a in zip(paths, flat_a)}


def _port_specs(tree, path=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_specs(tree[k], f"{path}[{k!r}]"))
        return out
    return {path: tree}


# the configs both packages have: the published Zamba2 (zamba2-7b) is the
# port's alone, with no reference to pair it with
PAIRED = [a for a in ARCH_NAMES if a in REF_ARCH_NAMES]


@pytest.mark.parametrize("rules", sorted(RULES))
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", PAIRED)
def test_specs_equal_reference(arch, mesh, rules):
    """Parameter specs (the stacked keys), decode-cache specs at
    ``decode_32k`` (B = 128, S = 32768) and ``spec_report`` lines: the
    reference's, entry for entry."""
    names, sizes = MESHES[mesh]
    port_mesh = make_production_mesh(multi_pod=mesh == "multi_pod")
    assert port_mesh.shape == dict(zip(names, sizes))
    ref_mesh = FakeMesh(**dict(zip(names, sizes)))
    r_rules = ref_shard.ShardingRules(tuple(RULES[rules].items()))
    p_rules = shard.ShardingRules(tuple(
        {"default": shard.DEFAULT_RULES,
         "decode_seq": shard.DECODE_SEQ_SHARD}[rules].items()))
    assert p_rules == shard.ShardingRules(r_rules.rules)
    rmodel = RefModel(ref_get_config(arch))
    model = Model(get_config(arch), device="cpu")
    want = _ref_specs(rmodel.param_axes(), rmodel.param_specs(), ref_mesh,
                      r_rules)
    got = _port_specs(shard.params_shardings(model, port_mesh, p_rules))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])
    shard.check_specs(shard.params_shardings(model, port_mesh, p_rules),
                      model.param_specs(), port_mesh)
    want = _ref_specs(rmodel.cache_axes(128, 32768),
                      rmodel.cache_specs(128, 32768), ref_mesh, r_rules)
    got = _port_specs(shard.cache_shardings(model, port_mesh, 128, 32768,
                                            p_rules))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k] == tuple(want[k]), (k, got[k], want[k])
    assert shard.spec_report(model, port_mesh, p_rules) == \
        ref_shard.spec_report(rmodel, ref_mesh, r_rules)


@pytest.mark.parametrize("arch", PAIRED)
def test_param_and_cache_specs_keep_reference_shapes(arch):
    """``param_specs`` / ``cache_specs`` / the axes: the reference's
    stacked keys, shapes, dtypes and axis names."""
    rmodel = RefModel(ref_get_config(arch))
    model = Model(get_config(arch), device="cpu")
    for r_tree, p_tree in ((rmodel.param_specs(), model.param_specs()),
                           (rmodel.cache_specs(4, 64),
                            model.cache_specs(4, 64))):
        want = {jax.tree_util.keystr(p): s for p, s in
                jax.tree_util.tree_flatten_with_path(r_tree)[0]}
        got = _port_specs(p_tree)
        assert sorted(got) == sorted(want)
        for k, s in want.items():
            assert got[k].shape == tuple(s.shape), k
            assert str(got[k].dtype).split(".")[-1] == s.dtype.name, k
    want = jax.tree.leaves(rmodel.param_axes(),
                           is_leaf=lambda x: isinstance(x, tuple))
    got = list(_port_specs(model.param_axes()).values())
    assert got == want


@pytest.mark.parametrize("names", (("data", "model"),
                                   ("pod", "data", "model")))
@pytest.mark.parametrize("ndim", (1, 2, 3))
def test_batch_sharding_equals_reference(names, ndim):
    devices = np.array(jax.devices()[:1]).reshape((1,) * len(names))
    ref = ref_shard.batch_sharding(jax.sharding.Mesh(devices, names),
                                   ndim=ndim)
    got = shard.batch_sharding(MeshShape(names, (1,) * len(names)),
                               ndim=ndim)
    assert got == tuple(ref.spec)


def test_check_specs_refuses_bad_specs():
    mesh = make_production_mesh()
    shapes = {"w": common.TensorSpec((896, 14), torch.float32)}
    shard.check_specs({"w": ("data",)}, shapes, mesh)
    for bad in (("data", "model"), ("data", "data"), ("pod",),
                ("data", None, None)):
        with pytest.raises(ValueError):
            shard.check_specs({"w": bad}, shapes, mesh)


def test_meshes():
    """The production meshes' names and sizes; the debug mesh clamped to
    the CUDA devices there are (the host counts as one)."""
    assert make_production_mesh().shape == {"data": 16, "model": 16}
    assert make_production_mesh(multi_pod=True).size == 512
    n = max(torch.cuda.device_count(), 1)
    dbg = make_debug_mesh(data=4, model=4)
    assert dbg.axis_names == ("data", "model")
    assert dbg.size <= n and dbg.shape["data"] == min(4, n)


# the reference's own spec cases (tests/test_distributed.py)
def test_spec_for_divisible_dims():
    mesh = FakeMesh(data=16, model=16)
    spec = shard.spec_for((152064, 896), ("vocab", "d_model"), mesh)
    assert spec == ("model", "data") == tuple(P("model", "data"))


def test_spec_for_fallback_replication():
    mesh = FakeMesh(data=16, model=16)
    spec = shard.spec_for((896, 14, 64), ("d_model", "heads", None), mesh)
    assert spec == ("data",)
    spec = shard.spec_for((24,), ("ssm_heads",), mesh)
    assert spec == ()


def test_spec_for_no_axis_reuse():
    mesh = FakeMesh(data=16, model=16)
    spec = shard.spec_for((256, 256), ("vocab", "heads"), mesh)
    assert spec == ("model",)


def test_spec_for_missing_mesh_axis():
    mesh = FakeMesh(data=16, model=16)          # no "pod"
    spec = shard.spec_for((4096, 128), ("batch", None), mesh)
    assert spec == ("data",)
    mesh3 = FakeMesh(pod=2, data=16, model=16)
    spec = shard.spec_for((4096, 128), ("batch", None), mesh3)
    assert spec == (("pod", "data"),)


# --------------------------------------------------------------------------- #
# convert.params_to_numpy
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("arch", ("qwen2-0.5b", "mamba2-130m", "zamba2-2.7b",
                                  "deepseek-v3-671b", "whisper-medium"))
def test_params_to_numpy_inverts_params_from_numpy(arch):
    """The reference's tree -> the port -> back: the same keys, shapes and
    values (float32 smoke weights; bf16 through float32, exactly)."""
    rcfg = ref_smoke_config(arch)
    tree = jax.tree.map(np.asarray, RefModel(rcfg).init(
        jax.random.PRNGKey(0)))
    cfg = smoke_config(arch)
    back = convert.params_to_numpy(
        cfg, convert.params_from_numpy(cfg, tree, device="cpu"))
    want = _flat_ref(tree)
    got = _flat_ref(back)
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    bf = dataclasses.replace(cfg, param_dtype="bfloat16")
    p16 = convert.params_from_numpy(bf, tree, device="cpu")
    again = convert.params_from_numpy(bf, convert.params_to_numpy(bf, p16),
                                      device="cpu")
    for a, b in zip(common.tree_leaves(p16), common.tree_leaves(again)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="expected"):
        convert.params_to_numpy(bf, convert.params_from_numpy(
            cfg, tree, device="cpu"))


def test_checkpoint_restore_reads_members_in_parallel_exactly(tmp_path):
    """Restore reads the archive's members in several threads (each with
    its own handle): many members, restored a few times, equal to a plain
    serial read every time."""
    rng = np.random.default_rng(0)
    params = {f"w{i:02d}": torch.from_numpy(rng.normal(size=(64, 33)).astype(
        np.float32)) for i in range(48)}
    params["layers"] = [{"a": torch.full((5,), float(i)),
                         "b": torch.arange(7, dtype=torch.int32) + i}
                        for i in range(6)]
    ckpt.save_checkpoint(str(tmp_path), 3, params)
    with np.load(tmp_path / "step_00000003" / "arrays.npz") as z:
        serial = {k: z[k] for k in z.files}
    for _ in range(5):
        state, _, _ = ckpt.restore_checkpoint(str(tmp_path),
                                              {"params": params})
        got = _flat_port(state)
        assert sorted(got) == sorted(serial)
        for k in serial:
            assert np.array_equal(got[k], serial[k]), k
