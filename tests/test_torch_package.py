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
            "repro_torch.core.critic", "repro_torch.core.controller",
            "repro_torch.core.datagen", "repro_torch.faults.retry",
            "repro_torch.sim.tracefile", "repro_torch.exp.artifacts",
            "repro_torch.obs.profile", "repro_torch.models.api",
            "repro_torch.kernels.flash_attention",
            "repro_torch.kernels.ssd_scan",
            "repro_torch.kernels.rmsnorm", "repro_torch.exp.grammar",
            "repro_torch.exp.spec", "repro_torch.exp.provenance",
            "repro_torch.exp.runner", "repro_torch.eval.policies",
            "repro_torch.eval.sweep", "repro_torch.eval.report",
            "repro_torch.eval.cli", "repro_torch.obs.cli",
            "repro_torch.launch.serve", "repro_torch.launch.train",
            "repro_torch.launch.mesh", "repro_torch.train.loop",
            "repro_torch.train.optimizer", "repro_torch.data.pipeline",
            "repro_torch.distributed.checkpoint",
            "repro_torch.distributed.compression",
            "repro_torch.distributed.failure",
            "repro_torch.distributed.sharding",
            "repro_torch.distributed.placement",
            "repro_torch.distributed.hoststaged",
            "repro_torch.launch.dryrun",
            "repro_torch.launch.hlo_analysis",
            "repro_torch.analysis", "repro_torch.analysis.__main__",
            "repro_torch.analysis.cli", "repro_torch.analysis.core",
            "repro_torch.analysis.rules",
            "repro_torch.analysis.rules.determinism",
            "repro_torch.analysis.rules.dtype",
            "repro_torch.analysis.rules.hygiene",
            "repro_torch.analysis.rules.identity",
            "repro_torch.analysis.rules.obs_guard"} <= set(names)
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
    examples = sorted((root.parents[1] / "examples" / "torch").glob("*.py"))
    assert len(examples) == 5
    files = list(root.rglob("*.py")) + [root.parents[1] / "chip_smoke.py"] \
        + examples
    assert len(files) > 30
    hits = [f"{f}:{i}" for f in files if f.exists()
            for i, line in enumerate(f.read_text().splitlines(), 1)
            if pat.match(line)]
    assert not hits, hits


def test_examples_import_neither_jax_nor_repro():
    """Loading every script of ``examples/torch`` (its imports, not its
    ``main``) pulls in no jax and nothing of the reference."""
    examples = pathlib.Path(SRC).parent / "examples" / "torch"
    code = (
        "import importlib.util, pathlib, sys\n"
        f"for path in sorted(pathlib.Path({str(examples)!r}).glob('*.py')):\n"
        "    spec = importlib.util.spec_from_file_location(path.stem, path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.startswith("clean")


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
    "__import__('repro_torch.models.api', fromlist=['api'])"
    ".build_model('qwen2-0.5b', impl='flash')",
    "__import__('repro_torch.models.api', fromlist=['api'])"
    ".build_model('mamba2-130m', impl='pallas', device='cuda')",
    "__import__('repro_torch.convert', fromlist=['convert']).params_from_numpy("
    "__import__('repro_torch.configs', fromlist=['configs'])"
    ".get_config('qwen2-0.5b'), {})",
    "__import__('repro_torch.core.critic', fromlist=['critic']).train_critic("
    "[(__import__('numpy').zeros(40, 'float32'),) * 3] * 4, epochs=1)",
    "__import__('repro_torch.core.datagen', fromlist=['datagen'])"
    ".harvest(sc, bulk_requests=20, probe_requests=20)",
    "__import__('repro_torch.eval', fromlist=['eval']).run_sweep("
    "__import__('repro_torch.eval', fromlist=['eval']).SweepSpec("
    "n_ai_requests=20))",
    "__import__('repro_torch.exp', fromlist=['exp']).run_experiment("
    "__import__('repro_torch.exp', fromlist=['exp']).ExperimentSpec("
    "methods=('haf-static',), scenarios=('paper',), seeds=(0,), "
    "n_ai_requests=20))",
    "__import__('repro_torch.eval', fromlist=['eval']).run_sweep("
    "__import__('repro_torch.eval', fromlist=['eval']).SweepSpec("
    "engine='torch', n_ai_requests=20))",
    "__import__('repro_torch.train.loop', fromlist=['loop']).train("
    "__import__('repro_torch.models.api', fromlist=['api']).build_model("
    "__import__('repro_torch.configs', fromlist=['configs']).smoke_config("
    "'qwen2-0.5b'), device='cpu'), "
    "__import__('repro_torch.data', fromlist=['data']).DataPipeline("
    "vocab_size=256, seq_len=16, global_batch=2), "
    "__import__('repro_torch.train.loop', fromlist=['loop']).TrainConfig("
    "steps=1))",
))
def test_default_entry_points_need_cuda_and_say_so(call):
    """No silent CPU run: without a card the device engines raise."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    proc = _run(_DEFAULT_RUN.format(call=call))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "raised"


@pytest.mark.parametrize("argv", (
    ["repro_torch.eval", "--smoke", "--workers", "1"],
    ["repro_torch.eval", "--spec", "experiments/paper_table3.toml",
     "--requests", "20", "--workers", "1"],
    ["repro_torch.launch.serve", "--requests", "20", "--no-critic"],
    ["repro_torch.launch.train", "--preset", "smoke", "--steps", "1"],
))
def test_default_command_lines_need_cuda_and_say_so(argv, tmp_path):
    """``python -m repro_torch.eval`` with no ``--engine`` (the spec's
    ``cuda``), the serving launcher and the training launcher (no
    ``--device``) raise naming CUDA, write no report and never fall back to
    the host."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the defaults run on it")
    out = tmp_path / "report.json"
    if argv[0] == "repro_torch.eval":
        argv = argv + ["--out", str(out)]
    env = dict(os.environ, PYTHONPATH=SRC, REPRO_ARTIFACTS=str(tmp_path))
    proc = subprocess.run([sys.executable, "-m", *argv], env=env, text=True,
                          capture_output=True, timeout=300,
                          cwd=pathlib.Path(SRC).parent)
    assert proc.returncode != 0
    assert "RuntimeError" in proc.stderr and "CUDA" in proc.stderr
    assert "JOB FAILED" not in proc.stdout
    assert not out.exists()


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
    assert set(_build.SOURCE_FLAGS) == set(_build.KERNELS)
    for name in ("event_step", "alloc_active_set", "ssd_scan"):
        assert "-fmad=false" in _build.nvcc_flags(name)
    for name in ("flash_attention", "rmsnorm"):
        assert "-fmad=false" not in _build.nvcc_flags(name)
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS


def test_build_digest_covers_each_sources_own_flags(monkeypatch):
    """A library is rebuilt when its own flags change, and only then."""
    from repro_torch.kernels import _build
    before = {name: _build._digest(name) for name in _build.KERNELS}
    monkeypatch.setitem(_build.SOURCE_FLAGS, "rmsnorm", ["-fmad=false"])
    after = {name: _build._digest(name) for name in _build.KERNELS}
    assert after["rmsnorm"] != before["rmsnorm"]
    assert {k: v for k, v in after.items() if k != "rmsnorm"} == \
        {k: v for k, v in before.items() if k != "rmsnorm"}


def test_build_digest_covers_every_shared_header(monkeypatch, tmp_path):
    """Every ``csrc/*.cuh`` feeds every library's digest: an edited header
    (``hopper.cuh``, ``common.cuh``) rebuilds each kernel that may include
    it instead of serving a stale library."""
    import shutil

    from repro_torch.kernels import _build
    headers = sorted(p.name for p in _build.CSRC.glob("*.cuh"))
    assert {"common.cuh", "hopper.cuh"} <= set(headers)
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    before = {name: _build._digest(name) for name in _build.KERNELS}
    for header in headers:
        path = csrc / header
        path.write_text(path.read_text() + "\n// edited\n")
        after = {name: _build._digest(name) for name in _build.KERNELS}
        assert all(after[k] != before[k] for k in _build.KERNELS), header
        before = after
