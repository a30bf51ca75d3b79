"""Package-level contracts of repro_torch, checked in fresh interpreters:
it imports neither jax nor the reference package, and where CUDA is not
available its default entry points raise instead of running on the CPU.
"""
import os
import pathlib
import pkgutil
import subprocess
import sys

import pytest
import torch

SRC = str(pathlib.Path(__file__).resolve().parents[1] / "src")


def _run(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=SRC)
    return subprocess.run([sys.executable, "-c", code], env=env, text=True,
                          capture_output=True, timeout=300)


def _port_modules():
    import repro_torch
    names = ["repro_torch"]
    for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(m.name)
    return names


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    names = _port_modules()
    assert {"repro_torch.kernels.ops", "repro_torch.sim.engine",
            "repro_torch.core.allocator", "repro_torch.convert",
            "repro_torch.obs.profile"} <= set(names)
    code = (
        "import importlib, sys\n"
        f"for name in {names!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "assert 'torch' in sys.modules\n"
        "print('clean', len(sys.modules))\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


def test_no_source_line_imports_jax_or_repro():
    import re
    pat = re.compile(r"^\s*(import|from)\s+(jax|repro)\b")
    root = pathlib.Path(SRC) / "repro_torch"
    files = list(root.rglob("*.py")) + [root.parents[1] / "chip_smoke.py"]
    assert len(files) > 30
    hits = [f"{f}:{i}" for f in files if f.exists()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


_DEFAULT_RUN = """
from repro_torch.sim import Simulator, make_scenario, workload_for
from repro_torch.sim.engine import DeadlineAwareAllocation, StaticPlacement
sc = make_scenario("paper", seed=0)
wl = [workload_for(sc, seed=s, n_ai_requests=20)[0] for s in (0, 1)]
try:
    {call}
except RuntimeError as err:
    assert "CUDA" in str(err), err
    print("raised")
else:
    print("ran")
"""


@pytest.mark.parametrize("call", (
    "Simulator(sc).run_batch(wl, lambda b: StaticPlacement(), "
    "lambda b: DeadlineAwareAllocation())",
    "Simulator(sc).run(wl[0], StaticPlacement(), DeadlineAwareAllocation())",
    "Simulator(sc, engine='numpy').run_batch(wl, lambda b: StaticPlacement(),"
    " lambda b: DeadlineAwareAllocation(), engine='cuda')",
    "Simulator(sc, engine='cuda', device='cpu')",
))
def test_default_entry_points_need_cuda_and_say_so(call):
    """No silent CPU run: without a card the device engines raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    proc = _run(_DEFAULT_RUN.format(call=call))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_host_engines_ignore_the_missing_device():
    """engine='numpy' never touches the device, whatever ``device`` says."""
    from repro_torch.sim import Simulator, make_scenario, workload_for
    from repro_torch.sim.engine import (DeadlineAwareAllocation,
                                        StaticPlacement)
    sc = make_scenario("paper", seed=0)
    reqs, _ = workload_for(sc, seed=0, n_ai_requests=30)
    res = Simulator(sc, engine="numpy").run(reqs, StaticPlacement(),
                                            DeadlineAwareAllocation())
    assert res.engine == "numpy" and res.n_events > 0
    with pytest.raises(ValueError, match="unknown"):
        Simulator(sc, engine="jax", device="cpu")
    with pytest.raises(ValueError, match="batched"):
        Simulator(sc, engine="numpy").run_batch(
            [reqs], [StaticPlacement()], [DeadlineAwareAllocation()],
            engine="pallas")


def test_allocate_cluster_use_kernel_on_cpu_tensors_raises():
    code = (
        "import torch\n"
        "from repro_torch.core.allocator import allocate_cluster\n"
        "x = torch.rand(4, 8)\n"
        "cap = torch.full((4,), 10.0)\n"
        "g, c = allocate_cluster(x, x, x, x * 0, x * 0, cap, cap, x > 0.1)\n"
        "assert g.alloc.shape == (4, 8)\n"
        "try:\n"
        "    allocate_cluster(x, x, x, x * 0, x * 0, cap, cap, x > 0.1,\n"
        "                     use_kernel=True)\n"
        "except RuntimeError as err:\n"
        "    assert 'CUDA' in str(err)\n"
        "    print('raised')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


def test_kernel_sources_are_in_the_package_and_build_dir_is_ignored():
    from repro_torch.kernels import _build
    for name in _build.KERNELS:
        assert (_build.CSRC / f"{name}.cu").is_file()
    root = pathlib.Path(SRC).parent
    assert _build.BUILD_DIR == root / "build" / "repro_torch_kernels"
    assert "build/" in (root / ".gitignore").read_text().split()
    assert "-fmad=false" in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
