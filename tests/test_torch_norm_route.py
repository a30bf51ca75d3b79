"""The model path's RMSNorm route (``models.common.rms_norm``).

The route follows the model's ``impl``: ``"xla"`` is the eager composite
``kref.rmsnorm_ref``, differentiable, bit for bit the float32 formula the
models ran before the kernel took their norms, and it launches nothing; a
kernel lowering (``"flash"``, ``"pallas"``) sends every norm to
``ops.rmsnorm``, which launches the hand-written ``rmsnorm`` kernel on the
card (reading the weight in its own dtype), runs its plain version on the
CPU, refuses autograd, and on a device mesh norms each rank's whole rows.

The tests marked ``cuda`` skip without a card; on one they run with
``python -m pytest -q -m cuda tests/test_torch_norm_route.py``.  Tolerances
against the composite are the kernels' (``tests/test_torch_kernels.py``):
float32 1e-5, bfloat16 2e-2.
"""
import dataclasses
import json
import socket
from datetime import timedelta

import pytest
import torch
import torch.multiprocessing as mp
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch.dryrun import fake_device_mesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import common
from repro_torch.models.api import build_model

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = (torch.float32, torch.bfloat16)


def _formula(x, weight, eps=1e-5):
    """The models' norm as the composite computes it: float32 statistics,
    the output in x's dtype."""
    x32 = x.float()
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)


def _inputs(shape, dtype, w_dtype=None, device="cpu", seed=0):
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(shape, generator=gen).to(dtype)
    w = (1.0 + 0.1 * torch.randn(shape[-1], generator=gen)).to(
        w_dtype or dtype)
    return x.to(device), w.to(device)


# --------------------------------------------------------------------------- #
# the composite route, on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("impl", ("xla", "flash", "pallas"))
@pytest.mark.parametrize("w_dtype", DTYPES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 7, 64), (1, 5, 896), (3, 4096)])
def test_rms_norm_on_cpu_is_the_composite_bit_for_bit(shape, dtype, w_dtype,
                                                      impl):
    """Every ``impl`` on the CPU: the composite itself, or the kernel
    wrapper's plain version, which is the composite."""
    x, w = _inputs(shape, dtype, w_dtype)
    ops.reset_launch_counts()
    got = common.rms_norm(x, w, 1e-6, impl)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, _formula(x, w, 1e-6))
    assert torch.equal(got, kref.rmsnorm_ref(x, w, 1e-6))
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("dtype", DTYPES)
def test_rms_norm_under_autograd_is_the_composite(dtype):
    """Under ``impl="xla"`` (the default, the training path) gradients flow
    through the composite, and equal the formula's."""
    x, w = _inputs((3, 5, 64), dtype)
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    ops.reset_launch_counts()
    got = common.rms_norm(xg, wg)
    got.float().square().sum().backward()
    xr, wr = x.clone().requires_grad_(), w.clone().requires_grad_()
    want = _formula(xr, wr)
    want.float().square().sum().backward()
    assert torch.equal(got.detach(), want.detach())
    assert torch.equal(xg.grad, xr.grad) and torch.equal(wg.grad, wr.grad)
    assert set(ops.launch_counts().values()) == {0}


@pytest.mark.parametrize("impl", ("flash", "pallas"))
@pytest.mark.parametrize("grad", ("x", "weight"))
def test_rms_norm_of_a_kernel_lowering_refuses_autograd(impl, grad):
    """A kernel lowering's norm raises where a gradient is wanted (the
    kernel has no backward pass), as flash_attention and ssd_scan do, and
    under ``torch.no_grad()`` gives the composite's values."""
    x, w = _inputs((3, 5, 64), torch.bfloat16)
    xg, wg = x.clone(), w.clone()
    (xg if grad == "x" else wg).requires_grad_()
    with pytest.raises(RuntimeError, match="rmsnorm: the kernel has no "
                                           "backward"):
        common.rms_norm(xg, wg, impl=impl)
    with torch.no_grad():
        assert torch.equal(common.rms_norm(xg, wg, impl=impl),
                           kref.rmsnorm_ref(x, w))


def test_rms_norm_of_dtensors_is_the_composite():
    """A ``DTensor`` input on a device mesh under ``impl="xla"`` keeps the
    composite: DTensor runs it on each rank's shard."""
    x, w = _inputs((2, 6, 64), torch.bfloat16)
    ops.reset_launch_counts()
    with fake_device_mesh(MeshShape(("data",), (1,))) as mesh:
        xd = DTensor.from_local(x, mesh, [Replicate()], run_check=False)
        wd = DTensor.from_local(w, mesh, [Replicate()], run_check=False)
        got = common.rms_norm(xd, wd)
        assert isinstance(got, DTensor)
        local = got.to_local()
    assert torch.equal(local, _formula(x, w))
    assert set(ops.launch_counts().values()) == {0}


def test_rmsnorm_binding_matches_the_kernels_interface():
    """The ctypes signature has one argument for each of ``rmsnorm_launch``'s
    parameters, the two dtype codes among them, in the source's order (the
    source is compiled only on the card)."""
    import re
    from repro_torch.kernels import _build
    src = (_build.CSRC / "rmsnorm.cu").read_text()
    params = re.search(r"REPRO_EXPORT int rmsnorm_launch\(([^)]*)\)",
                       src).group(1).split(",")
    names = [q.split()[-1].lstrip("*") for q in params]
    assert names == ["x", "w", "y", "rows", "d", "eps", "x_dtype", "w_dtype",
                     "groups", "stream"]
    assert len(_build._SIGNATURES["rmsnorm_launch"]) == len(names)


@pytest.mark.parametrize("placed,rows", [
    ((Shard(0), Replicate()), (Shard(0), Replicate())),
    ((Shard(0), Shard(1)), (Shard(0), Shard(1))),
    ((Shard(0), Shard(2)), (Shard(0), Replicate())),
    ((Replicate(), Partial()), (Replicate(), Replicate()))])
def test_rms_norm_of_dtensors_under_a_kernel_lowering_norms_whole_rows(
        placed, rows):
    """On a 2×2 mesh a kernel lowering's norm keeps batch and sequence
    shards and gathers a split row or a partial sum first: the result is
    placed as whole rows, each rank's rows normed alone (a fake process
    group: the values of a gather are not real, so only placements, shapes
    and a batch shard's values are held)."""
    x, w = _inputs((4, 6, 64), torch.float32)
    with fake_device_mesh(MeshShape(("data", "model"), (2, 2))) as mesh:
        xd = DTensor.from_local(x, mesh, placed, run_check=False) \
            if placed[1].is_partial() else \
            distribute_tensor(x, mesh, placed, src_data_rank=None)
        wd = distribute_tensor(w, mesh, [Replicate()] * 2,
                               src_data_rank=None)
        ops.reset_launch_counts()
        got = common.rms_norm(xd, wd, impl="flash")
        assert isinstance(got, DTensor)
        assert tuple(got.placements) == rows
        assert got.to_local().shape[-1] == 64
        if placed == rows:
            local = xd.to_local()
            assert torch.equal(got.to_local(), kref.rmsnorm_ref(local, w))
        with pytest.raises(RuntimeError, match="no backward"):
            common.rms_norm(xd.detach().requires_grad_(), wd, impl="flash")
    assert set(ops.launch_counts().values()) == {0}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def _mesh_rank(rank: int, port: int, out: str) -> None:
    """One of two gloo ranks (a 1×2 ``data`` × ``model`` mesh): a norm of
    rows split over ``model``, of a batch split over it, and of a partial
    sum, each gathered whole; rank 0 writes them to ``out``."""
    torch.set_num_threads(1)
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://localhost:{port}", rank=rank,
        world_size=2, timeout=timedelta(seconds=60))
    try:
        from repro_torch.launch.mesh import make_device_mesh
        mesh = make_device_mesh(MeshShape(("data", "model"), (1, 2)), "cpu")
        x, w = _inputs((2, 5, 64), torch.float32)
        wd = distribute_tensor(w, mesh, [Replicate(), Replicate()])
        report = {}
        for name, xd in (
                ("row", distribute_tensor(x, mesh, [Replicate(), Shard(2)])),
                ("batch", distribute_tensor(x, mesh,
                                            [Replicate(), Shard(0)])),
                ("partial", DTensor.from_local(x / 2, mesh,
                                               [Replicate(), Partial()],
                                               run_check=False))):
            got = common.rms_norm(xd, wd, impl="flash")
            report[name] = {"placements": [str(p) for p in got.placements],
                            "full": got.full_tensor().tolist()}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(report, f)
    finally:
        torch.distributed.destroy_process_group()


def test_rms_norm_on_a_gloo_mesh_equals_the_whole_rows_norm(tmp_path):
    """Two gloo ranks: a row split over ``model``, a batch split over it and
    a partial sum are each normed as the composite norms the whole tensor
    (values gathered for real)."""
    out = tmp_path / "report.json"
    mp.start_processes(_mesh_rank, args=(_free_port(), str(out)), nprocs=2,
                       start_method="spawn")
    report = json.loads(out.read_text())
    x, w = _inputs((2, 5, 64), torch.float32)
    want = kref.rmsnorm_ref(x, w)
    placed = {"row": ["R", "R"], "batch": ["R", "S(0)"],
              "partial": ["R", "R"]}
    for name, got in report.items():
        assert got["placements"] == placed[name], name
        torch.testing.assert_close(torch.tensor(got["full"]), want,
                                   rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------- #
# the kernel route, on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the rmsnorm kernel runs only there")
    return torch.device("cuda", 0)


_LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
             "cuLaunchKernelEx")


def _launched(fn):
    """``(fn's result, kernel launches on the host, device kernel names)``
    of one call under ``torch.profiler`` (a short spin kernel first, whose
    launch and record are left out: a trace's first device record is the
    one most often lost; the spans' device-side copies are left out too)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    launches = sum(e.name in _LAUNCHES for e in events) - 1
    names = [e.name for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "spin" not in e.name and not e.name.startswith("repro.")]
    return out, launches, names


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1368, 4096), (1, 8192, 4096),
                                   (4, 64, 896), (2, 33, 2560),
                                   (3, 17, 6144)])
def test_rms_norm_on_the_card_is_one_rmsnorm_launch(card, shape, dtype):
    x, w = _inputs(shape, dtype, device=card, seed=len(shape) + shape[-1])
    before = ops.launch_counts()["rmsnorm"]
    got, launches, names = _launched(
        lambda: common.rms_norm(x, w, impl="flash"))
    assert ops.launch_counts()["rmsnorm"] - before == 1
    assert launches == 1 and names and all("rmsnorm" in n for n in names)
    assert got.dtype == dtype and got.shape == x.shape
    torch.testing.assert_close(got.float(), kref.rmsnorm_ref(x, w).float(),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(64, 4096), (5, 999), (16, 896),
                                   (2, 6144), (7, 4097)])
def test_rmsnorm_bf16_weight_reads_as_its_float32_widening(card, shape,
                                                           dtype):
    """Widening bf16 to float32 is exact, so the kernel's read of a bf16
    weight gives the bits of its float32 copy (the vector route, unaligned
    rows, the long-row route; float32 x takes four bf16 weights a load)."""
    x, w = _inputs(shape, dtype, torch.bfloat16, device=card)
    assert torch.equal(ops.rmsnorm(x, w), ops.rmsnorm(x, w.float()))


@pytest.mark.cuda
def test_rms_norm_of_a_strided_slice_on_the_card(card):
    """deepseek's q / kv norms take a slice of a wider projection: it is
    made contiguous and normed by the kernel."""
    x, w = _inputs((2, 9, 640), torch.bfloat16, device=card)
    wide = x[..., :512]
    before = ops.launch_counts()["rmsnorm"]
    got = common.rms_norm(wide, w[:512], impl="flash")
    assert ops.launch_counts()["rmsnorm"] - before == 1
    torch.testing.assert_close(got.float(),
                               kref.rmsnorm_ref(wide, w[:512]).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.cuda
def test_rms_norm_under_autograd_on_the_card(card):
    """On the card ``impl="xla"`` differentiates the composite and launches
    nothing; a kernel lowering refuses a gradient and launches once under
    ``torch.no_grad()``."""
    x, w = _inputs((4, 8, 4096), torch.bfloat16, device=card)
    xg = x.clone().requires_grad_()
    before = ops.launch_counts()["rmsnorm"]
    got = common.rms_norm(xg, w)
    got.float().sum().backward()
    assert ops.launch_counts()["rmsnorm"] == before
    assert torch.equal(got.detach(), kref.rmsnorm_ref(x, w))
    assert xg.grad is not None and bool(torch.isfinite(xg.grad).all())
    with pytest.raises(RuntimeError, match="no backward"):
        common.rms_norm(xg, w, impl="flash")
    assert ops.launch_counts()["rmsnorm"] == before
    with torch.no_grad():
        common.rms_norm(xg, w, impl="flash")
    assert ops.launch_counts()["rmsnorm"] == before + 1


@pytest.mark.cuda
def test_llava_smoke_prefill_on_the_card_agrees_with_the_composite(
        card, monkeypatch):
    """A bf16 llava prefill (its smoke configuration) under ``impl="flash"``
    launches two norms a layer and the final one, and agrees in logits and
    cache to the bf16 tolerance with the same prefill whose norms are the
    composite (flash_attention on both sides, so the norm alone differs);
    ``impl="xla"`` launches nothing."""
    cfg = dataclasses.replace(smoke_config("llava-next-mistral-7b"),
                              param_dtype="bfloat16",
                              compute_dtype="bfloat16")
    model = build_model(cfg, impl="flash", device=card)
    gen = torch.Generator(device=card).manual_seed(5)
    params = model.init(gen)
    batch = model.make_inputs(ShapeCell("s", 40, 2, "prefill"), gen)
    with torch.no_grad():
        ops.reset_launch_counts()
        logits, cache = model.prefill(params, batch)
        assert ops.launch_counts()["rmsnorm"] == 2 * cfg.num_layers + 1
        ops.reset_launch_counts()
        build_model(cfg, impl="xla", device=card).prefill(params, batch)
        assert set(ops.launch_counts().values()) == {0}
        monkeypatch.setattr(ops, "rmsnorm", lambda x, w, eps, groups=1:
                            kref.rmsnorm_ref(x, w, eps))
        logits_c, cache_c = model.prefill(params, batch)
    assert ops.launch_counts()["rmsnorm"] == 0
    for got, want in ((logits, logits_c),
                      *zip(common.tree_leaves(cache),
                           common.tree_leaves(cache_c))):
        scale = float(want.float().abs().max())
        torch.testing.assert_close(got.float(), want.float(), rtol=2e-2,
                                   atol=2e-2 * scale)


# --------------------------------------------------------------------------- #
# the reading of a traced run: rms_norm.kernel_share (tools/span_readings.py)
# --------------------------------------------------------------------------- #
MS = 1_000_000  # ns


@pytest.fixture
def span_readings(monkeypatch):
    """``tools/span_readings.py`` as a module; the path and environment it
    sets when imported are put back afterwards."""
    import importlib.util
    import pathlib
    import sys
    monkeypatch.setattr(sys, "path", list(sys.path))
    for var in ("TORCH_EXTENSIONS_DIR", "TRITON_CACHE_DIR"):
        monkeypatch.setenv(var, "")
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" \
        / "span_readings.py"
    spec = importlib.util.spec_from_file_location("span_readings", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _trace(module, norms, outside=(), span="repro.rms_norm", parent=None):
    """A profile made by hand: each norm a ``span`` span of 1 ms launching
    the kernels named, each launch's kernel running after the span closed;
    ``outside`` kernels launched outside every span.  ``parent``: a span of
    that name around each, which launches a GEMM of its own after the inner
    span closed."""
    from types import SimpleNamespace
    tr, spans = module.tr, module.spans

    def event(name, start, end, device=torch.autograd.DeviceType.CPU,
              corr=0):
        return SimpleNamespace(
            name=name, start_ns=int(start), duration_ns=int(end - start),
            device_type=device, is_user_annotation=False,
            correlation_id=corr, start_thread_id=7)

    cuda = torch.autograd.DeviceType.CUDA
    out, corr = [event(tr.SPAN, 0, 100 * MS)], 10

    def launch(kernel, call, run):
        nonlocal corr
        corr += 1
        out.append(event("cudaLaunchKernel", call * MS, call * MS + 10_000,
                         corr=corr))
        out.append(event(kernel, run * MS, (run + 0.05) * MS, cuda, corr))

    launches = [(3 * i + 1, kernels) for i, kernels in enumerate(norms)]
    launches.append((90, outside))
    for i, (at, kernels) in enumerate(launches):
        if i < len(norms):
            out.append(event(span, at * MS, (at + 1) * MS))
            if parent:
                out.append(event(parent, (at - 0.5) * MS, (at + 1.5) * MS))
                launch("nvjet_tst_gemm", at + 1.2, at + 2.2)
        for j, kernel in enumerate(kernels):
            launch(kernel, at + 0.1 * (j + 1), at + 1.2 + 0.1 * j)
    return spans.collect(out)


RMS = "void (anonymous namespace)::rmsnorm_rows<__nv_bfloat16, " \
      "__nv_bfloat16, 16>(...)"
EAGER = ("void at::native::elementwise_kernel<128, 2>(...)",
         "void at::native::vectorized_elementwise_kernel<8>(...)")


@pytest.mark.parametrize("norms,share", [
    ([[RMS], [RMS], [RMS]], 1.0),
    ([list(EAGER) * 4, list(EAGER) * 4], 0.0),
    ([[RMS], list(EAGER), [RMS, EAGER[0]], [RMS]], 0.5),
    ([[]], None)])
def test_rms_norm_kernel_share_reads_each_norm_span(span_readings, norms,
                                                    share):
    st = _trace(span_readings, norms, outside=["nvjet_tst_gemm", RMS])
    assert span_readings.kernel_share(st) == share


CONV = "void (anonymous namespace)::causal_conv_silu_kernel<__nv_bfloat16, " \
       "__nv_bfloat16, 4>(...)"


@pytest.mark.parametrize("convs,share", [
    ([[CONV] * 3, [CONV] * 3], 1.0),
    ([list(EAGER) * 7, list(EAGER) * 7], 0.0),
    ([[CONV] * 3, list(EAGER) * 3], 3 / 9),
    ([[]], None)])
def test_ssm_conv_kernel_share_reads_each_conv_span(span_readings, convs,
                                                    share):
    """``ssm.conv.kernel_share``: the ``causal_conv_silu`` records among
    those the ``repro.ssm.conv`` spans launched (the mixer's own GEMM and
    the launches outside every span left out): 1.0 where each convolution
    is the kernel alone."""
    st = _trace(span_readings, convs, outside=[CONV], span="repro.ssm.conv",
                parent="repro.ssm")
    span, kernel = span_readings.KERNEL_SHARES["ssm.conv.kernel_share"]
    assert (span, kernel) == ("repro.ssm.conv", "causal_conv_silu")
    assert span_readings.kernel_share(st, span, kernel) == share


def test_ssm_conv_us_per_token_counts_the_conv_spans_records(span_readings):
    """``ssm.conv.us_per_token``: device µs a prompt position of the records
    launched inside a ``repro.ssm.conv`` span; ``ssm.us_per_token`` counts
    each mixer's GEMM besides (every record 50 µs, 10 positions)."""
    st = _trace(span_readings, [[CONV] * 3, list(EAGER) * 2],
                outside=[CONV], span="repro.ssm.conv", parent="repro.ssm")
    got = span_readings.hybrid_readings(st, 10)
    # (the hand-made records' ends are whole nanoseconds)
    assert got["ssm.conv.us_per_token"] == pytest.approx(7 * 50 / 10,
                                                         rel=1e-4)
    assert got["ssm.us_per_token"] == pytest.approx(9 * 50 / 10, rel=1e-4)
    assert "ssm.scan.us_per_token" not in got
    assert span_readings.INCLUSIVE["ssm.conv.us_per_token"] == \
        ("repro.ssm.conv",)
