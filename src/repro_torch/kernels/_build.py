"""Build the CUDA sources in ``csrc/`` at first use and bind them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface (no PyTorch headers), so one
``nvcc -shared`` per source — all started together — gives
``build/repro_torch_kernels/lib<name>-<digest>.so`` in a few seconds.  The
digest covers the source, the shared header and the flags, so an edited
kernel is rebuilt and an unchanged one is reused.  A failed build raises;
nothing here falls back to another implementation.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
from typing import Dict, List

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
# <checkout>/build/repro_torch_kernels (this file is src/repro_torch/kernels/)
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" \
    / "repro_torch_kernels"

KERNELS = ("event_step", "alloc_active_set")

# -fmad=false: event_step is held bit-for-bit to the numpy event core, which
# rounds `alloc * tg` before subtracting; a fused multiply-add would not.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_c_ptr, _c_int = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    "event_step_launch": [_c_ptr] * 13 + [_c_int, _c_int, _c_ptr],
    "alloc_active_set_launch": [_c_ptr] * 8 + [_c_int, _c_int, _c_ptr],
}


def find_nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of repro_torch are compiled from source at first use")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    h.update((CSRC / "common.cuh").read_bytes())
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
        cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
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
