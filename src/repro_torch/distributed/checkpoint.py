"""Atomic checkpoints in the reference's on-disk format.

Twin of the reference's ``distributed/checkpoint.py``; a checkpoint written
by either package restores in the other.  Format: one directory per step,
``step_XXXXXXXX/``, holding ``arrays.npz`` (every leaf, keyed by its path
in the reference's tree, ``jax.tree_util.keystr`` style:
``['params']['layers']['wq']``, ``['opt_state'].step``,
``['opt_state'].m['embed']``) and ``manifest.json`` (``step``, ``keys``,
``dtypes``, ``extra`` -- the data pipeline's state -- and ``treedef``, a
plain description here: no restore reads it).  Writes go to a ``.tmp_``
directory committed by an atomic rename, so a crash mid-write never
corrupts the latest checkpoint.

The port holds each stacked subtree (``models.common.STACKED``) as a list
of per-layer trees: a list is stacked on the leading axis on save, as in
the reference's tree, and split again on restore.  npz cannot store
bfloat16: such a leaf is saved as its uint16 bit view with the dtype tag
``"bfloat16"`` (the reference's encoding) and decoded here through
``torch.bfloat16`` (no ``ml_dtypes`` needed).

A state placed on a device mesh is saved whole, in the same one archive
(the reference has no per-rank files), and restores on a mesh, in one
process or in the reference alike.
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import tempfile
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.distributed.placement import gather_full
from repro_torch.models.common import stack_trees

Tree = Any

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
READERS = 8                  # threads reading the archive's members


def _is_record(tree) -> bool:
    """A NamedTuple (``AdamWState``): its fields are ``.name`` keys."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def _flatten(tree: Tree, key: str = "", out=None) -> Dict[str, Any]:
    """``{keystr path: leaf}`` in the reference's (stacked) layout; tensors
    are copied to the host."""
    out = {} if out is None else out
    if _is_record(tree):
        for f in tree._fields:
            _flatten(getattr(tree, f), f"{key}.{f}", out)
    elif isinstance(tree, dict):
        for k in sorted(tree):
            _flatten(tree[k], f"{key}[{k!r}]", out)
    elif isinstance(tree, list):
        host = [_to_host(t) for t in tree]
        _flatten(stack_trees(host), key, out)
    else:
        out[key] = tree.detach().cpu() if isinstance(tree, torch.Tensor) \
            else np.asarray(tree)
    return out


def _to_host(tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.detach().cpu()


def _encode(x) -> Tuple[np.ndarray, str]:
    """An npz-storable array and its dtype tag."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        x = x.numpy()
    return x, x.dtype.name


def _decode(arr: np.ndarray, name: str) -> torch.Tensor:
    if name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if arr.dtype.name != name:
        raise ValueError(f"checkpoint dtype {name!r} stored as "
                         f"{arr.dtype.name}: not readable here")
    return torch.from_numpy(arr)


def _describe(tree: Tree) -> str:
    if _is_record(tree):
        return f"{type(tree).__name__}(" + ", ".join(
            f"{f}={_describe(getattr(tree, f))}" for f in tree._fields) + ")"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_describe(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, list):
        return f"stacked[{len(tree)}]({_describe(tree[0])})"
    return "*"


def save_checkpoint(ckpt_dir: str, step: int, params: Tree,
                    opt_state: Optional[Tree] = None,
                    extra: Optional[Dict] = None) -> str:
    """Atomic write of step's state; returns the committed path.  A state
    placed on a device mesh (``DTensor`` leaves) is gathered whole on every
    rank, rank 0 writes the one archive and the others wait for it at a
    barrier: call it on every rank."""
    payload = {"params": params}
    if opt_state is not None:
        payload["opt_state"] = opt_state
    root = pathlib.Path(ckpt_dir)
    final = root / f"step_{step:08d}"
    if not _has_dtensor(payload):
        _write(root, final, step, payload, extra)
        return str(final)
    payload = gather_full(payload)
    try:
        if dist.get_rank() == 0:
            _write(root, final, step, payload, extra)
    finally:
        dist.barrier()
    return str(final)


def _has_dtensor(tree: Tree) -> bool:
    if isinstance(tree, dict):
        return any(_has_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_has_dtensor(v) for v in tree)
    return isinstance(tree, DTensor)


def _write(root: pathlib.Path, final: pathlib.Path, step: int,
           payload: Tree, extra: Optional[Dict]) -> None:
    root.mkdir(parents=True, exist_ok=True)
    tmp = pathlib.Path(tempfile.mkdtemp(dir=root, prefix=".tmp_"))
    try:
        arrays = _flatten(payload)
        dtypes = {}
        enc = {}
        for k, v in arrays.items():
            enc[k], dtypes[k] = _encode(v)
        np.savez(tmp / ARRAYS, **enc)
        manifest = {
            "step": step,
            "treedef": _describe(payload),
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "extra": extra or {},
        }
        (tmp / MANIFEST).write_text(json.dumps(manifest))
        if final.exists():                      # re-save of same step
            _rmtree(final)
        os.replace(tmp, final)                  # atomic commit
    except BaseException:
        _rmtree(tmp)
        raise


def restore_checkpoint(ckpt_dir: str, template: Tree,
                       step: Optional[int] = None, device=None
                       ) -> Tuple[Optional[Tree], Optional[int], Dict]:
    """Restore ``template``-shaped state.

    Returns (state, step, extra) or (None, None, {}) when there is no
    checkpoint.  ``template`` is shaped like the payload that was saved
    (``{"params": ..., "opt_state": ...?}``; leaves are tensors or anything
    with a ``.shape``, per-layer lists where the port keeps them).  Each
    leaf comes back in its stored dtype, on its template tensor's device
    (``device``, default the CPU, for a template leaf that is no tensor);
    a ``DTensor`` template leaf gets the full array placed as it is placed
    (every rank reads the archive).
    Raises ``KeyError`` for a leaf the checkpoint lacks and ``ValueError``
    for a shape that differs from the template's (stacked) shape.
    """
    s = latest_step(ckpt_dir) if step is None else step
    if s is None:
        return None, None, {}
    path = pathlib.Path(ckpt_dir) / f"step_{s:08d}"
    manifest = json.loads((path / MANIFEST).read_text())
    dtypes = manifest.get("dtypes", {})
    archive = path / ARRAYS

    def read(k):
        # a handle of its own per read: ZipFile.open is not thread-safe
        with np.load(archive) as z:
            arr = z[k]                          # each member read once
        return _decode(arr, dtypes.get(k, arr.dtype.name))
    with np.load(archive) as z:
        keys = z.files
    # members are read by a few threads at once: zlib's CRC and the copies
    # out of the archive run outside the GIL
    with ThreadPoolExecutor(min(READERS, os.cpu_count() or 1)) as pool:
        arrays = dict(zip(keys, pool.map(read, keys)))
    default = torch.device("cpu" if device is None else device)

    def build(tmpl, key, layer=None):
        if _is_record(tmpl):
            return type(tmpl)(*(build(getattr(tmpl, f), f"{key}.{f}", layer)
                                 for f in tmpl._fields))
        if isinstance(tmpl, dict):
            return {k: build(tmpl[k], f"{key}[{k!r}]", layer)
                    for k in tmpl}
        if isinstance(tmpl, list):
            return [build(t, key, (i, len(tmpl))) for i, t in enumerate(tmpl)]
        if key not in arrays:
            raise KeyError(f"checkpoint missing leaf {key}")
        arr = arrays[key]
        want = tuple(tmpl.shape)
        if layer is not None:
            want = (layer[1],) + want
        if tuple(arr.shape) != want:
            raise ValueError(f"{key}: checkpoint shape {tuple(arr.shape)} != "
                             f"model shape {want}")
        if layer is not None:
            arr = arr[layer[0]]
        if isinstance(tmpl, DTensor):
            return distribute_tensor(arr.to(tmpl.to_local().device),
                                     tmpl.device_mesh, tmpl.placements,
                                     src_data_rank=None)
        dev = tmpl.device if isinstance(tmpl, torch.Tensor) else default
        return arr.to(dev)

    return build(template, ""), s, manifest.get("extra", {})


def latest_step(ckpt_dir: str) -> Optional[int]:
    root = pathlib.Path(ckpt_dir)
    if not root.exists():
        return None
    steps = []
    for p in root.iterdir():
        if p.name.startswith("step_") and (p / MANIFEST).exists():
            try:
                steps.append(int(p.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def _rmtree(path: pathlib.Path) -> None:
    shutil.rmtree(path, ignore_errors=True)
