"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc -shared`` per source — all started together — gives
``build/repro_torch_kernels/lib<name>-<digest>.so`` in a few seconds.  The
digest covers the source, every shared header (``csrc/*.cuh``) and that
source's flags, so an edited kernel is rebuilt and an unchanged one is
reused.  A failed build raises; nothing here falls back to another
implementation.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# <checkout>/build/repro_torch_kernels (this file is src/repro_torch/kernels/)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"

KERNELS = ("event_step", "alloc_active_set", "rmsnorm", "flash_attention",
           "ssd_scan", "causal_conv_silu")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Flags of one source on top of NVCC_FLAGS.  -fmad=false: event_step is held
# bit-for-bit to the numpy event core, which rounds `alloc * tg` before
# subtracting; a fused multiply-add would not.  alloc_active_set and
# ssd_scan keep it too, so that their numbers stay those of the design they
# were measured with; flash_attention, rmsnorm and causal_conv_silu contract
# freely.
SOURCE_FLAGS = {"event_step": ["-fmad=false"],
                "alloc_active_set": ["-fmad=false"],
                "ssd_scan": ["-fmad=false"],
                "flash_attention": [], "rmsnorm": [], "causal_conv_silu": []}

# element types of the model kernels (DTYPE_* in csrc/common.cuh)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_c_ptr, _c_int, _c_float = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SIGNATURES = {
    "event_step_launch": [_c_ptr] * 13 + [_c_int] * 4 + [_c_ptr],
    # psi, omega, floors, capacity, mask, alloc, feasible, pinned, N, S,
    # route, rows, stages, ctas, warps, stream
    "alloc_active_set_launch": [_c_ptr] * 8 + [_c_int] * 7 + [_c_ptr],
    # x, w, y, rows, d, eps, x_dtype, w_dtype, groups, stream
    "rmsnorm_launch": [_c_ptr] * 3 + [_c_int, _c_int, _c_float, _c_int,
                                      _c_int, _c_int, _c_ptr],
    # q, k, v, o, B, S, H, KV, D, scale, causal, dtype, stream
    "flash_attention_launch": [_c_ptr] * 4 + [_c_int] * 5
    + [_c_float, _c_int, _c_int, _c_ptr],
    # x, dt, A, B, C, y, state, cs, delta, totals, in_hi, in_lo,
    # b, S, h, g, p, px, n, nx, chunk, dtype, stream
    "ssd_scan_launch": [_c_ptr] * 12 + [_c_int] * 10 + [_c_ptr],
    # x, w, b, y, B, S, C, K, x_dtype, w_dtype, stream
    "causal_conv_silu_launch": [_c_ptr] * 4 + [_c_int] * 6 + [_c_ptr],
}


H100_SMS = 132


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index``."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def on_device(dev: torch.device):
    """A context in which ``dev`` is the current CUDA device: nothing to do
    where it already is, ``torch.cuda.device(dev)`` where it is not."""
    if dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


# the current stream's handle without building a torch.cuda.Stream object
# (a few µs a launch); absent from builds of torch without CUDA
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def current_stream(dev: torch.device) -> int:
    """The ``cudaStream_t`` of ``dev``'s current stream, as an int."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are compiled from source at first use")


def nvcc_flags(name: str) -> List[str]:
    """Every flag ``nvcc`` gets for ``csrc/<name>.cu`` (before ``-o``)."""
    return NVCC_FLAGS + SOURCE_FLAGS[name]


def aligned16(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on a 16-byte
    boundary (TMA and 16-byte vector loads need one)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(nvcc_flags(name)).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> Dict[str, pathlib.Path]:
    """Compile every kernel that has no up-to-date library; one nvcc per
    source, all running at once.  Returns ``{name: library path}``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {name: BUILD_DIR / f"lib{name}-{_digest(name)}.so"
            for name in KERNELS}
    procs: List = []
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
        cmd = [find_nvcc(), *nvcc_flags(name), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs.append((name, lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, lib, tmp, cmd, proc in procs:
        out, _ = proc.communicate()
        (BUILD_DIR / f"{name}.nvcc.log").write_text(
            " ".join(cmd) + "\n" + out)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{out}")
        else:
            os.replace(tmp, lib)       # atomic: no half-written library
    if failed:
        raise RuntimeError("kernel build failed\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load() -> Dict[str, ctypes.CDLL]:
    """``{name: loaded library}`` with argument types declared (pointers
    must not be passed as 32-bit ints).  Built once per process."""
    out = {}
    for name, path in build_all().items():
        lib = ctypes.CDLL(str(path))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _SIGNATURES[f"{name}_launch"]
        fn.restype = _c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [_c_int]
        err.restype = ctypes.c_char_p
        out[name] = lib
    return out


def launch(name: str, *args) -> None:
    """Call ``<name>_launch`` and raise if the launch was refused."""
    lib = load()[name]
    code = getattr(lib, f"{name}_launch")(*args)
    if code != 0:
        msg = getattr(lib, f"{name}_error_string")(code).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} "
                           f"(cudaError {code})")
