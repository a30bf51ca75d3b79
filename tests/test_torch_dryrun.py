"""The port's dry-run (``launch.dryrun``, ``launch.hlo_analysis``) against
the reference's, on the host.

The analytic model FLOPs and the ``Roofline`` arithmetic equal the
reference's; on one device the traced step's argument bytes equal the
reference's compiled ones and its counted FLOPs lie within 5 % of XLA's;
on the 16×16 production mesh the per-device argument bytes are the local
shards' and the collectives are there.  Each traced cell makes its own
fake process group and destroys it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import re

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, ShapeCell, cells_for, get_config
from repro.configs import ARCH_NAMES as REF_ARCH_NAMES
from repro_torch.configs import ARCH_NAMES
from repro_torch.launch import dryrun, hlo_analysis
from repro_torch.launch.mesh import MeshShape, make_production_mesh

ONE = MeshShape(("data", "model"), (1, 1))
SMALL = ShapeCell("small", 64, 4, "train")
REF_RECORD_KEYS = {"arch", "cell", "kind", "mesh", "n_devices", "seq_len",
                   "global_batch", "params", "active_params", "compile_s",
                   "remat", "unrolled", "memory", "roofline", "torch"}
FLOPS_REL = 0.05


def _reference_dryrun():
    """The reference's dry-run module, imported without letting its
    512-host-device flag reach this process's jax (initialised first)."""
    import jax
    jax.devices()
    saved = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch import dryrun as ref
    finally:
        if saved is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = saved
    return ref


# the configs both packages have: the published Zamba2 (zamba2-7b) is the
# port's alone, with no reference to pair it with
PAIRED = [a for a in ARCH_NAMES if a in REF_ARCH_NAMES]


@pytest.mark.parametrize("arch", PAIRED)
def test_analytic_model_flops_equal_reference(arch):
    from repro.configs import get_config as ref_config
    from repro.launch.hlo_analysis import analytic_model_flops as ref_flops
    for cell in cells_for(arch):
        args = (cell.kind, cell.seq_len, cell.global_batch)
        assert hlo_analysis.analytic_model_flops(get_config(arch), *args) \
            == ref_flops(ref_config(arch), *args)


def test_roofline_equals_reference_at_equal_constants(monkeypatch):
    """With the reference's TPU constants put in, the port's properties
    are the reference's; ``to_dict`` has the reference's keys."""
    from repro.launch import hlo_analysis as ref
    monkeypatch.setattr(hlo_analysis, "PEAK_FLOPS", ref.PEAK_FLOPS)
    monkeypatch.setattr(hlo_analysis, "HBM_BW", ref.HBM_BW)
    monkeypatch.setattr(hlo_analysis, "NVLINK_BW", ref.ICI_LINKS * ref.ICI_BW)
    cases = [(3e12, 4e9, 2e8, 0.0), (1e9, 8e11, 1e6, 5e8),
             (2e11, 1e9, 9e10, 1e11), (0.0, 0.0, 0.0, 0.0)]
    for flops, byts, coll, model in cases:
        kw = dict(flops=flops, hbm_bytes=byts, coll_bytes=coll,
                  coll_breakdown={"all-gather": int(coll)}, out_bytes=1.0,
                  model_flops=model)
        mine, theirs = hlo_analysis.Roofline(**kw), ref.Roofline(**kw)
        assert mine.to_dict().keys() == theirs.to_dict().keys()
        for key, want in theirs.to_dict().items():
            assert mine.to_dict()[key] == pytest.approx(want, rel=1e-12), key


def test_h100_constants():
    """The hardware model is the H100 SXM5's datasheet, NVLink within an
    8-card node and InfiniBand across."""
    assert hlo_analysis.PEAK_FLOPS == 989.4e12
    assert hlo_analysis.HBM_BW == 3.35e12
    assert hlo_analysis.NVLINK_BW == 450e9
    assert hlo_analysis.IB_BW == 50e9 and hlo_analysis.NODE == 8


@pytest.fixture(scope="module")
def one_device_records():
    """(arch, remat) -> (the port's record, the reference's record) on one
    device at 2 layers, S = 64, B = 4."""
    import jax
    ref = _reference_dryrun()
    from repro.configs import SHAPES as REF_SHAPES  # noqa: F401
    from repro.configs import ShapeCell as RefCell
    ref_mesh = jax.make_mesh((1, 1), ("data", "model"))
    out = {}
    for arch in ("qwen2-0.5b", "mamba2-130m"):
        for remat in ("none", "dots"):
            over = {"num_layers": 2}
            mine = dryrun.lower_cell(arch, SMALL, ONE, remat=remat,
                                     cfg_overrides=over)
            theirs = ref.lower_cell(arch, RefCell("small", 64, 4, "train"),
                                    ref_mesh, remat=remat,
                                    cfg_overrides=over)
            out[arch, remat] = (mine, theirs)
    return out


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "mamba2-130m"))
def test_one_device_argument_bytes_equal_reference(one_device_records, arch):
    for remat in ("none", "dots"):
        mine, theirs = one_device_records[arch, remat]
        assert mine["memory"]["argument_size_in_bytes"] == \
            theirs["memory"]["argument_size_in_bytes"]


@pytest.mark.parametrize("arch", ("qwen2-0.5b", "mamba2-130m"))
def test_one_device_flops_near_reference(one_device_records, arch):
    """Counted FLOPs within 5 % of XLA's at remat="none" (both printed at
    "dots" too, where XLA's count of the recompute differs)."""
    mine, theirs = one_device_records[arch, "none"]
    got, want = mine["roofline"]["flops"], theirs["roofline"]["flops"]
    assert abs(got - want) <= FLOPS_REL * want, (got, want)
    dm, dt = one_device_records[arch, "dots"]
    print(f"{arch} remat=dots: counted {dm['roofline']['flops']:.4g}, "
          f"XLA {dt['roofline']['flops']:.4g}; model "
          f"{dm['roofline']['model_flops']:.4g}")
    assert mine["roofline"]["model_flops"] == pytest.approx(
        theirs["roofline"]["model_flops"], rel=1e-12)


def test_record_keys_are_the_references(one_device_records):
    mine, theirs = one_device_records["qwen2-0.5b", "dots"]
    assert set(mine) == set(theirs) | {"torch"} == REF_RECORD_KEYS
    assert mine["torch"] == torch.__version__
    assert set(mine["memory"]) == set(theirs["memory"])
    assert set(mine["roofline"]) == set(theirs["roofline"])
    assert mine["unrolled"] is True and mine["mesh"] == "1x1"


@pytest.fixture(scope="module")
def production_records():
    """qwen2-0.5b at 2 layers, train_4k, on the 16×16 mesh and on one
    device."""
    over = {"num_layers": 2}
    cell = SHAPES["train_4k"]
    return (dryrun.lower_cell("qwen2-0.5b", cell, make_production_mesh(),
                              cfg_overrides=over),
            dryrun.lower_cell("qwen2-0.5b", cell, ONE, cfg_overrides=over))


def _local_numel(shape, spec, mesh) -> int:
    n = math.prod(shape)
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else
                  (entry,) if entry else ()):
            n //= mesh.shape[a]
    return n


def test_production_argument_bytes_are_local_shards(production_records):
    """Per device: params (bf16), AdamW m and v (float32) and step by
    ``params_shardings``, the batch's rows over ``data`` (int32 ids)."""
    from repro_torch.distributed.sharding import params_shardings
    from repro_torch.models.api import Model
    from repro_torch.models.common import tree_leaves
    rec, _ = production_records
    mesh = make_production_mesh()
    cfg = dataclasses.replace(get_config("qwen2-0.5b"), num_layers=2)
    model = Model(cfg, device="meta")
    specs, shapes = params_shardings(model, mesh), model.param_specs()
    flat = lambda t: ([x for k in sorted(t) for x in flat(t[k])]
                      if isinstance(t, dict) else [t])
    spec_leaves = flat(specs)
    shape_leaves = tree_leaves(shapes)
    local = sum(_local_numel(s.shape, sp, mesh)
                for s, sp in zip(shape_leaves, spec_leaves))
    cell = SHAPES["train_4k"]
    want = (local * (2 + 4 + 4) + 4
            + cell.global_batch // 16 * cell.seq_len * 4)
    assert rec["memory"]["argument_size_in_bytes"] == want


def test_production_collectives_and_flops(production_records):
    rec, one = production_records
    coll = rec["roofline"]["coll_breakdown"]
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert coll[kind] > 0, kind
    flops = rec["roofline"]["flops"]
    model = rec["roofline"]["model_flops"]        # per device: ÷ 256
    assert model * 256 == pytest.approx(one["roofline"]["model_flops"])
    assert model < flops < one["roofline"]["flops"]
    assert rec["n_devices"] == 256 and rec["mesh"] == "16x16"
    # the model dim's groups (16 consecutive ranks) span two nodes of 8
    assert rec["roofline"]["t_collective"] == pytest.approx(
        rec["roofline"]["coll_bytes"] / hlo_analysis.IB_BW)


def test_cli_writes_records_and_refuses_a_live_group(tmp_path):
    dryrun.main(["--arch", "mamba2-130m", "--mesh", "single", "--cell",
                 "long_500k", "--out", str(tmp_path)])
    recs = json.loads((tmp_path / "dryrun_single.json").read_text())
    assert len(recs) == 1 and set(recs[0]) == REF_RECORD_KEYS
    assert recs[0]["memory"]["total_per_device"] > 0
    with dryrun.fake_device_mesh(ONE):
        with pytest.raises(SystemExit, match="outside"):
            dryrun.main(["--arch", "mamba2-130m", "--mesh", "single"])
    assert not torch.distributed.is_initialized()


def test_flash_attention_refuses_a_split_sequence():
    """On a mesh the kernel takes batch and whole-head shards; a sequence
    shard raises naming the placement."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 8, 4, 16, generator=g) for _ in range(3))
    with dryrun.fake_device_mesh(MeshShape(("data", "model"), (2, 2))) as m:
        place = lambda t, pl: distribute_tensor(t, m, pl, src_data_rank=None)
        ok = [Shard(0), Shard(2)]
        out = ops.flash_attention(*(place(t, ok) for t in (q, k, v)))
        assert out.placements == tuple(ok)
        np.testing.assert_allclose(
            out.to_local().numpy(),
            ops.flash_attention(q, k, v)[:1, :, :2].numpy(), rtol=1e-6)
        bad = [Shard(0), Shard(1)]
        with pytest.raises(ValueError, match="S\\(1\\) on mesh dim .model."):
            ops.flash_attention(*(place(t, bad) for t in (q, k, v)))
        with pytest.raises(ValueError, match="agree"):
            ops.flash_attention(place(q, ok), place(k, [Replicate()] * 2),
                                place(v, ok))


# --------------------------------------------------------------------- #
# collectives counted from the plan, alike on every torch version (F8)
# --------------------------------------------------------------------- #
_ITEMSIZE = {"bfloat16": 2, "float16": 2, "float32": 4, "float64": 8,
             "int32": 4, "int64": 8, "bool": 1}
PLAN_CELLS = [(arch, cell) for arch in ("zamba2-2.7b", "whisper-medium")
              for cell in ("train_4k", "prefill_32k", "decode_32k")]


def _cut(arch):
    """Smoke depth at full width: one attention block of zamba2, two
    encoder and two decoder layers of whisper."""
    cfg = get_config(arch)
    if cfg.family == "hybrid":
        return {"num_layers": cfg.hybrid.attn_every}
    return {"num_layers": 2,
            "encdec": dataclasses.replace(cfg.encdec, encoder_layers=2)}


def _placement(text):
    m = re.fullmatch(r"S\((\d+)\)", text)
    return ("S", int(m.group(1))) if m else \
        ("P",) if text.startswith("P(") else ("R",)


def _ceil(a, b):
    return -(-a // b)


def _plan(src, dst, shape, mesh):
    """DTensor's greedy plan for ``src -> dst``, one step a mesh dim:
    inner mesh dims first, where a nested shard that the target does not
    keep is replicated, then outer to inner.  Each step carries the tensor's
    logical shape at its mesh dim and the placements before it."""
    logical = [list(shape)]
    for i, p in enumerate(src[:-1]):
        nxt = list(logical[i])
        if p[0] == "S":
            nxt[p[1]] = _ceil(nxt[p[1]], mesh[i])
        logical.append(nxt)
    cur, steps = list(src), []
    if any(p[0] == "S" for p in src):
        for i in reversed(range(len(cur))):
            tgt = dst[i]
            if tgt[0] == "S" and [k for k in range(i) if cur[k] == tgt] \
                    != [k for k in range(i) if dst[k] == tgt]:
                tgt = ("R",)
            if cur[i] != tgt:
                steps.append((i, cur[i], tgt, logical[i], list(cur)))
                cur[i] = tgt
    for i in range(len(cur)):
        if cur[i] != dst[i]:
            steps.append((i, cur[i], dst[i], logical[i], list(cur)))
            cur[i] = dst[i]
    return steps


def placement_bytes(move):
    """The collective bytes by kind (output bytes) that a redistribution
    moves, from its placements, global shape and dtype alone: an all-gather
    per shard replicated (padded to whole chunks), an all-reduce per
    partial replicated, a reduce-scatter per partial sharded, an all-to-all
    per shard moved to another dim, nothing for a local split."""
    src = [_placement(p) for p in move["src"]]
    dst = [_placement(p) for p in move["dst"]]
    mesh, out = move["mesh"], {}
    for i, a, b, logical, cur in _plan(src, dst, move["shape"], mesh):
        n, size = mesh[i], list(move["shape"])
        for k, p in enumerate(cur):
            if p[0] == "S":
                size[p[1]] = _ceil(size[p[1]], mesh[k])
        if a[0] == "S":
            size[a[1]] = _ceil(logical[a[1]], n) * n
        if b[0] == "S":
            size[b[1]] = _ceil(size[b[1]], n)
        kind = {("S", "R"): "all-gather", ("P", "R"): "all-reduce",
                ("P", "S"): "reduce-scatter",
                ("S", "S"): "all-to-all"}.get((a[0], b[0]))
        if kind is not None:
            out[kind] = out.get(kind, 0) + math.prod(size) \
                * _ITEMSIZE[move["dtype"]]
    return out


@pytest.fixture(scope="module")
def mesh_plans():
    """(arch, cell) -> (record, redistributions) on the 16×16 mesh."""
    out = {}
    for arch, cell in PLAN_CELLS:
        moves = []
        rec = dryrun.lower_cell(arch, SHAPES[cell], make_production_mesh(),
                                cfg_overrides=_cut(arch), plans=moves)
        out[arch, cell] = rec, moves
    return out


@pytest.mark.parametrize("arch,cell", PLAN_CELLS)
def test_collective_bytes_equal_placement_derived_count(mesh_plans, arch,
                                                        cell):
    """Every redistribution moves the bytes its placements say, and the
    record's collectives by kind are their sum: nothing is counted that the
    plan does not move."""
    rec, moves = mesh_plans[arch, cell]
    assert rec["torch"] == torch.__version__
    total = {}
    for m in moves:
        want = placement_bytes(m)
        assert m["coll"] == want, m
        for k, v in want.items():
            total[k] = total.get(k, 0) + v
    got = {k: v for k, v in rec["roofline"]["coll_breakdown"].items() if v}
    assert got == total


def _shard_moves(moves):
    return [m for m in moves
            if any(a != b and a.startswith("S(") and b.startswith("S(")
                   for a, b in zip(m["src"], m["dst"]))]


@pytest.mark.parametrize("arch,cell", PLAN_CELLS)
def test_shard_to_shard_moves_are_all_to_all(mesh_plans, arch, cell):
    """A planned ``Shard(i) -> Shard(j)`` move is one all-to-all of the local
    bytes, never an all-gather of the whole tensor (DTensor's CPU route)."""
    rec, moves = mesh_plans[arch, cell]
    planned = _shard_moves(moves)
    a2a = rec["roofline"]["coll_breakdown"]["all-to-all"]
    assert (a2a > 0) == bool(planned)
    for m in planned:
        whole = math.prod(m["shape"]) * _ITEMSIZE[m["dtype"]]
        assert set(m["coll"]) == {"all-to-all"}, m
        assert m["coll"]["all-to-all"] * 256 == whole, m


def test_op_counter_counts_dtensor_all_to_all():
    """A CUDA mesh runs a ``Shard -> Shard`` move as
    ``_dtensor::shard_dim_alltoall``: counted as an all-to-all of its output
    bytes.  The fake mesh runs it as ``all_to_all_single``, with the CPU
    route's shapes, and puts DTensor's own route back on exit."""
    from torch.distributed.tensor import (Shard, distribute_tensor,
                                          placement_types)
    cpu_route = placement_types.shard_dim_alltoall
    with dryrun.fake_device_mesh(MeshShape(("data", "model"), (2, 4))) as m:
        x = torch.empty(2, 8, 6, dtype=torch.bfloat16, device="meta")
        with hlo_analysis.OpCounter() as c:
            y = torch.ops._dtensor.shard_dim_alltoall(
                x, 0, 1, m.get_group(1).group_name)
        assert c.coll["all-to-all"] == hlo_analysis.nbytes(y) > 0
        assert sum(c.coll.values()) == c.coll["all-to-all"]
        t = distribute_tensor(torch.zeros(8, 12), m, [Shard(0), Shard(0)],
                              src_data_rank=None)
        with hlo_analysis.OpCounter() as c:
            u = t.redistribute(m, [Shard(0), Shard(1)])
        assert u.to_local().shape == (4, 3)
        assert c.coll["all-to-all"] == 4 * 3 * 4
        assert c.coll["all-gather"] == 0
    assert placement_types.shard_dim_alltoall is cpu_route
