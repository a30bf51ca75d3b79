"""512-device dry-run with an H100 roofline (twin of the reference's
``launch/dryrun.py``).

For every (architecture × shape cell × mesh) this traces the real step
function -- the train step (fwd + bwd + AdamW), ``prefill`` or
``decode_step`` -- at ``impl="xla"`` on ``meta`` tensors placed on a fake
process group of the mesh's size (``distributed.placement``: nothing is
allocated, as the reference's ``ShapeDtypeStruct``s allocate nothing, so no
card is needed), counts the local ops of one rank
(``hlo_analysis.OpCounter``), and appends the per-cell record to
``artifacts/dryrun_<mesh>.json`` (incrementally, so an interrupted sweep
resumes where it stopped).  A cell that fails records its error and the
sweep goes on.

``compile_s`` holds the trace's seconds.  Eager tracing sees every layer,
so ``unrolled`` is always true and ``--no-unroll`` changes nothing.  A fake
group cannot share a process with a real one: the CLI refuses to start
under an initialised process group, and :func:`lower_cell` given a
``MeshShape`` makes its own group and destroys it after the cell.

Run:
  PYTHONPATH=src python -m repro_torch.launch.dryrun              # everything
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \
      --mesh single
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import time
import traceback
from typing import Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._pytree import tree_leaves

from repro_torch.configs import ARCH_NAMES, ShapeCell, cells_for, get_config
from repro_torch.distributed import placement
from repro_torch.distributed.placement import RULE_SETS
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import (MeshShape, make_device_mesh,
                                     make_production_mesh)
from repro_torch.models.api import Model
from repro_torch.models.common import split_stacked, tree_map
from repro_torch.train.loop import TrainConfig, make_train_step
from repro_torch.train.optimizer import adamw_init

ARTIFACTS = pathlib.Path(__file__).resolve().parents[3] / "artifacts"


@contextlib.contextmanager
def fake_device_mesh(mesh: MeshShape):
    """A ``DeviceMesh`` of ``mesh``'s shape on a fake process group of
    ``mesh.size`` ranks in this process (this is rank 0; collectives return
    at once).  The group is destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes a fake process group and "
                           "cannot share a process with an initialised one")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield make_device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


def _meta(specs):
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                          device="meta"), specs)


def _locals(tree):
    """Each tensor leaf of ``tree`` as this rank holds it."""
    return [t.to_local() if isinstance(t, DTensor) else t
            for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _bytes(tensors) -> int:
    return sum(hlo_analysis.nbytes(t) for t in tensors)


def meta_inputs(model: Model, cell: ShapeCell) -> Dict[str, torch.Tensor]:
    """The cell's inputs on ``meta``, token ids int32 as the reference's
    input specs hold them; a decode step's ``pos`` a host scalar (the last
    row of the cache), as the step reads it."""
    out = {}
    for k, (shape, dtype) in model.input_specs(cell).items():
        if dtype == torch.long:
            dtype = torch.int32
        out[k] = torch.tensor(cell.seq_len - 1) if k == "pos" else \
            torch.empty(shape, dtype=dtype, device="meta")
    return out


def lower_cell(arch: str, cell: ShapeCell, mesh, *,
               rules: ShardingRules = ShardingRules(),
               remat: str = "dots", unroll: bool = True,
               cfg_overrides: Optional[Dict] = None) -> Dict:
    """Trace one (arch, cell, mesh); return the dry-run record.  ``mesh``
    is a ``DeviceMesh`` (on a fake group, :func:`fake_device_mesh`) or a
    ``MeshShape`` (a fake group is made for this cell).  ``unroll`` is
    accepted for the reference's signature: eager tracing always sees
    every layer.  ``cfg_overrides`` replaces config fields."""
    if isinstance(mesh, MeshShape):
        with fake_device_mesh(mesh) as dm:
            return lower_cell(arch, cell, dm, rules=rules, remat=remat,
                              unroll=unroll, cfg_overrides=cfg_overrides)
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    model = Model(cfg, impl="xla", remat=remat, device="meta")
    n_dev = mesh.size()
    t0 = time.perf_counter()

    params = split_stacked(_meta(model.param_specs()))
    p = placement.place_params(params, model, mesh, rules)
    inputs = meta_inputs(model, cell)
    pos = inputs.pop("pos", None)
    b = placement.place_batch(inputs, mesh, rules)
    if pos is not None:
        b["pos"] = pos
    if cell.kind == "train":
        args = (p, placement.place_opt(adamw_init(params), model, mesh,
                                       rules), b)
        step = make_train_step(model, TrainConfig(steps=1000),
                               compress=False)
        run = lambda: step(*args, None)
    elif cell.kind == "prefill":
        args = (p, b)
        run = lambda: model.prefill(p, b)
    else:
        cache = placement.place_cache(
            _meta(model.cache_specs(cell.global_batch, cell.seq_len)), model,
            mesh, cell.global_batch, cell.seq_len, rules)
        args = (p, cache, b)
        run = lambda: model.decode_step(p, cache, b)
    del params

    model_flops = hlo_analysis.analytic_model_flops(
        cfg, cell.kind, cell.seq_len, cell.global_batch)
    with hlo_analysis.OpCounter() as counter:
        out = run()
    ins, outs = _locals(args), _locals(out)
    out_bytes = _bytes(outs)
    # outputs written in place into an argument (a decode cache)
    in_storages = {t.untyped_storage()._cdata for t in ins}
    alias = _bytes(t for t in outs
                   if t.untyped_storage()._cdata in in_storages)
    roof = counter.roofline(model_flops=model_flops / n_dev,
                            out_bytes=out_bytes)
    mem = hlo_analysis.memory_stats(
        _bytes(ins), out_bytes, max(counter.peak_bytes - out_bytes, 0),
        alias)
    return {
        "arch": arch,
        "cell": cell.name,
        "kind": cell.kind,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": n_dev,
        "seq_len": cell.seq_len,
        "global_batch": cell.global_batch,
        "params": cfg.param_count(),
        "active_params": cfg.active_param_count(),
        "compile_s": round(time.perf_counter() - t0, 1),
        "remat": remat,
        "unrolled": True,
        "memory": mem,
        "roofline": roof.to_dict(),
    }


def run_sweep(archs, mesh_mode: str, out_dir: pathlib.Path,
              only_cell: Optional[str] = None, force: bool = False,
              remat: str = "dots", unroll: bool = True,
              rules: ShardingRules = ShardingRules()) -> None:
    out_dir.mkdir(parents=True, exist_ok=True)
    meshes = []
    if mesh_mode in ("single", "both"):
        meshes.append(("single", dict(multi_pod=False)))
    if mesh_mode in ("multi", "both"):
        meshes.append(("multi", dict(multi_pod=True)))

    for mesh_name, kw in meshes:
        out_path = out_dir / f"dryrun_{mesh_name}.json"
        records = {}
        if out_path.exists():
            records = {(r["arch"], r["cell"]): r
                       for r in json.loads(out_path.read_text())}
        shape = make_production_mesh(**kw)
        print(f"== mesh {mesh_name}: {shape.shape} "
              f"({shape.size} devices) ==", flush=True)
        with fake_device_mesh(shape) as mesh:
            for arch in archs:
                for cell in cells_for(arch):
                    if only_cell and cell.name != only_cell:
                        continue
                    key = (arch, cell.name)
                    if key in records and not force \
                            and "error" not in records[key]:
                        continue
                    try:
                        rec = lower_cell(arch, cell, mesh, remat=remat,
                                         unroll=unroll, rules=rules)
                        r = rec["roofline"]
                        hbm = rec["memory"].get("total_per_device", 0) / 2**30
                        print(f"[{mesh_name}] {arch:24s} {cell.name:12s} "
                              f"compile={rec['compile_s']:6.1f}s "
                              f"mem/dev={hbm:6.2f}GiB "
                              f"t_comp={r['t_compute']*1e3:8.2f}ms "
                              f"t_mem={r['t_memory']*1e3:8.2f}ms "
                              f"t_coll={r['t_collective']*1e3:8.2f}ms "
                              f"bound={r['bottleneck']:10s} "
                              f"frac={r['roofline_fraction']:.3f}",
                              flush=True)
                    except Exception as e:  # noqa: BLE001 — record, go on
                        rec = {"arch": arch, "cell": cell.name,
                               "mesh": mesh_name,
                               "error": f"{type(e).__name__}: {e}",
                               "traceback": traceback.format_exc()[-2000:]}
                        print(f"[{mesh_name}] {arch} {cell.name} FAILED: "
                              f"{rec['error'][:300]}", flush=True)
                    records[key] = rec
                    out_path.write_text(json.dumps(
                        list(records.values()), indent=1))


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, help="one arch (default: all)")
    ap.add_argument("--cell", default=None, help="one cell name")
    ap.add_argument("--mesh", default="both",
                    choices=("single", "multi", "both"))
    ap.add_argument("--out", default=str(ARTIFACTS))
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--remat", default="dots")
    ap.add_argument("--no-unroll", action="store_true",
                    help="accepted for the reference's command line; no "
                         "effect: eager tracing always sees every layer")
    ap.add_argument("--rules", default="default",
                    choices=tuple(RULE_SETS), help="sharding rule set")
    args = ap.parse_args(argv)
    if dist.is_available() and dist.is_initialized():
        raise SystemExit("repro_torch.launch.dryrun makes a fake process "
                         "group; run it outside any initialised one")
    if args.arch:
        archs = [a.strip() for a in args.arch.split(",") if a.strip()]
    else:
        archs = ARCH_NAMES
    run_sweep(archs, args.mesh, pathlib.Path(args.out),
              only_cell=args.cell, force=args.force, remat=args.remat,
              unroll=not args.no_unroll, rules=RULE_SETS[args.rules])


if __name__ == "__main__":
    main()
