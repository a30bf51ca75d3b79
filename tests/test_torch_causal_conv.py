"""Mamba2's causal convolution on the ``causal_conv_silu`` kernel.

``ops.causal_conv_silu(x, w, b)`` is ``silu(b + Σ_k w[k] · x[t − (K−1) +
k])`` per channel, x zero before t = 0.  On the CPU it runs its plain
version, ``kref.causal_conv_silu_ref``: the reference's static shifts
(``ssm._causal_conv``) and the SiLU, bit for bit what the models ran before
the kernel; on the card it launches ``csrc/causal_conv_silu.cu``.  A prefill
under a kernel lowering (``impl`` ``flash`` / ``pallas``) sends each of a
mixer's three convolutions (x, B, C) to it; ``impl="xla"`` (training) keeps
the composite.

The tests marked ``cuda`` skip without a card; on one they run with
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_causal_conv.py``.
There the kernel is held to the float32 composite of the same inputs:
float32 at 1e-5, bf16 within one output rounding (half a bf16 ulp is at
most 2^-8 of the value).
"""
import dataclasses

import pytest
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.launch.dryrun import fake_device_mesh
from repro_torch.launch.mesh import MeshShape
from repro_torch.models import ssm
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves

DTYPES = (torch.float32, torch.bfloat16)
TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (2.0 ** -8, 1e-6)}


def _inputs(B, S, C, dtype, w_dtype=None, K=4, device="cpu", seed=0):
    """x [B,S,C], w [K,C] and a nonzero bias [C]."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(B, S, C, generator=gen).to(dtype)
    w = (0.5 * torch.randn(K, C, generator=gen)).to(w_dtype or dtype)
    b = (0.1 * torch.randn(C, generator=gen)).to(w_dtype or dtype)
    return x.to(device), w.to(device), b.to(device)


def _shifts(x, w, b):
    """The convolution as the models wrote it before the kernel."""
    K = w.shape[0]
    out = x * w[K - 1]
    for i in range(K - 1):
        shift = K - 1 - i
        out = out + F.pad(x, (0, 0, shift, 0))[:, :-shift] * w[i]
    return out + b


# --------------------------------------------------------------------------- #
# the wrapper's plain path and its checks, on the CPU
# --------------------------------------------------------------------------- #
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 8), (2, 2, 16), (3, 3, 24),
                                   (2, 17, 128), (1, 40, 64)])
def test_plain_path_is_the_composite_bit_for_bit(shape, dtype):
    x, w, b = _inputs(*shape, dtype)
    ops.reset_launch_counts()
    got = ops.causal_conv_silu(x, w, b)
    assert got.dtype == dtype and got.shape == x.shape
    assert torch.equal(got, F.silu(ssm._causal_conv(x, w, b)))
    assert torch.equal(got, F.silu(_shifts(x, w, b)))
    assert set(ops.launch_counts().values()) == {0}


def test_plain_path_of_a_float32_weight_rounds_once_to_x_dtype():
    """A bf16 x with a float32 weight: the composite promotes to float32,
    and the result is rounded once to x's dtype, as the kernel writes it."""
    x, w, b = _inputs(2, 9, 32, torch.bfloat16, torch.float32)
    got = ops.causal_conv_silu(x, w, b)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, F.silu(_shifts(x, w, b)).to(torch.bfloat16))


def test_the_convolution_is_causal_and_zero_before_the_start():
    """Each output reads its own row and the K − 1 before it only."""
    x, w, b = _inputs(1, 12, 8, torch.float32, seed=3)
    base = ops.causal_conv_silu(x, w, b)
    x2 = x.clone()
    x2[:, 7] += 1.0
    moved = (ops.causal_conv_silu(x2, w, b) != base).any(dim=-1)[0]
    assert moved.tolist() == [t in (7, 8, 9, 10) for t in range(12)]
    head = ops.causal_conv_silu(x[:, :2], w, b)
    want = F.silu(b + x[:, 0] * w[3])
    assert torch.allclose(head[:, 0], want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("bad,match", [
    ("x2d", "non-empty"), ("empty", "non-empty"), ("w_channels", "expected"),
    ("b_shape", "expected"), ("k3", "width"), ("c12", "multiple of 8"),
    ("x_half", "float32 or bfloat16"), ("w_double", "float32 or bfloat16"),
    ("b_dtype", "must agree")])
def test_the_wrapper_rejects_what_the_kernel_does_not_take(bad, match):
    x, w, b = _inputs(2, 5, 16, torch.float32)
    if bad == "x2d":
        x = x[0]
    elif bad == "empty":
        x = x[:, :0]
    elif bad == "w_channels":
        w = w[:, :8]
    elif bad == "b_shape":
        b = b[:8]
    elif bad == "k3":
        w = w[:3]
    elif bad == "c12":
        x, w, b = x[..., :12], w[:, :12], b[:12]
    elif bad == "x_half":
        x = x.half()
    elif bad == "w_double":
        w, b = w.double(), b.double()
    elif bad == "b_dtype":
        b = b.bfloat16()
    with pytest.raises(ValueError, match=match):
        ops.causal_conv_silu(x, w, b)


@pytest.mark.parametrize("grad", ("x", "w", "b"))
def test_the_wrapper_refuses_autograd(grad):
    """No backward pass: an input that requires grad raises, as the other
    model kernels do; under ``torch.no_grad()`` it is the composite."""
    args = dict(zip("xwb", _inputs(2, 5, 16, torch.bfloat16)))
    args[grad] = args[grad].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="causal_conv_silu: the kernel has "
                                           "no backward"):
        ops.causal_conv_silu(**args)
    with torch.no_grad():
        got = ops.causal_conv_silu(**args)
    assert torch.equal(got, F.silu(_shifts(*(t.detach() for t in
                                             args.values()))))


# --------------------------------------------------------------------------- #
# the model's route, on the CPU
# --------------------------------------------------------------------------- #
def _mixer(seed=0):
    """One Mamba2 mixer of the smoke mamba2 (float32), its convolutions'
    biases made nonzero, and an input [2, 11, d_model]."""
    cfg = smoke_config("mamba2-130m")
    params = build_model(cfg, device="cpu").init(seed)["layers"][0]
    gen = torch.Generator().manual_seed(seed + 1)
    for name in ("conv_bias_x", "conv_bias_B", "conv_bias_C"):
        params[name] = 0.1 * torch.randn(params[name].shape, generator=gen)
    x = torch.randn(2, 11, cfg.d_model, generator=gen)
    return cfg, params, x


def test_xla_mixer_is_the_shifts_composite_bit_for_bit(monkeypatch):
    """``impl="xla"`` runs ``F.silu`` of the shifts, as before the kernel,
    and never reaches the wrapper."""
    cfg, params, x = _mixer()
    monkeypatch.setattr(ops, "causal_conv_silu", None)
    with torch.no_grad():
        got, state = ssm.ssm_forward(params, x, cfg, return_state=True)
    monkeypatch.setattr(ssm, "_conv_silu",
                        lambda x, w, b, impl: F.silu(_shifts(x, w, b)))
    with torch.no_grad():
        want, want_state = ssm.ssm_forward(params, x, cfg, return_state=True)
    assert torch.equal(got, want)
    for key in ("ssm", "conv"):
        assert torch.equal(state[key], want_state[key])


@pytest.mark.parametrize("impl", ("flash", "pallas"))
def test_a_kernel_lowering_sends_each_convolution_to_the_wrapper(
        monkeypatch, impl):
    """Three wrapper calls a mixer, on x's, B's and C's projections; under
    ``flash`` (the chunked scan on the CPU) the mixer equals ``xla``'s bit
    for bit, since the wrapper's plain path is the composite."""
    cfg, params, x = _mixer(seed=4)
    seen = []
    wrapper = ops.causal_conv_silu

    def spy(t, w, b):
        seen.append((t.shape[-1], w.shape, b.shape))
        return wrapper(t, w, b)
    monkeypatch.setattr(ops, "causal_conv_silu", spy)
    with torch.no_grad():
        got = ssm.ssm_forward(params, x, cfg, impl=impl)
        want = ssm.ssm_forward(params, x, cfg)
    d_in, gn = params["conv_x"].shape[1], params["conv_B"].shape[1]
    assert [c for c, _, _ in seen] == [d_in, gn, gn]
    if impl == "flash":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_a_zamba2_prefill_calls_the_wrapper_three_times_a_mixer(monkeypatch):
    """The published Zamba2 at smoke size under ``impl="flash"``: three
    convolutions a Mamba2 layer; ``impl="xla"`` none."""
    cfg = smoke_config("zamba2-7b")
    calls = []
    wrapper = ops.causal_conv_silu
    monkeypatch.setattr(ops, "causal_conv_silu",
                        lambda *a: calls.append(1) or wrapper(*a))
    gen = torch.Generator().manual_seed(2)
    for impl, want in (("flash", 3 * cfg.num_layers), ("xla", 0)):
        model = build_model(cfg, impl=impl, device="cpu")
        params = model.init(1)
        batch = model.make_inputs(ShapeCell("s", 13, 2, "prefill"), gen)
        calls.clear()
        with torch.no_grad():
            model.prefill(params, batch)
        assert len(calls) == want, impl


@pytest.mark.parametrize("impl", ("xla", "flash"))
def test_on_a_device_mesh_each_ranks_convolution_takes_the_route(
        monkeypatch, impl):
    """A ``DTensor`` on a device mesh: each rank's local rows and channels
    go to the wrapper under a kernel lowering (plain tensors), to the
    composite under ``xla``; both give the plain tensor's values."""
    x, w, b = _inputs(2, 9, 16, torch.float32, seed=5)
    seen = []
    wrapper = ops.causal_conv_silu

    def spy(*args):
        seen.append(tuple(type(t) for t in args))
        return wrapper(*args)
    monkeypatch.setattr(ops, "causal_conv_silu", spy)
    with fake_device_mesh(MeshShape(("data", "model"), (1, 1))) as mesh:
        xd, wd, bd = (DTensor.from_local(t, mesh, [Replicate()] * 2,
                                         run_check=False) for t in (x, w, b))
        got = ssm._conv_silu(xd, wd, bd, impl)
        assert isinstance(got, DTensor)
        local = got.to_local()
    assert torch.equal(local, F.silu(_shifts(x, w, b)))
    assert seen == ([] if impl == "xla" else [(torch.Tensor,) * 3])


# --------------------------------------------------------------------------- #
# the kernel, on the card
# --------------------------------------------------------------------------- #
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the causal_conv_silu kernel runs "
                    "only there")
    return torch.device("cuda", 0)


# zamba2-7b's x (7168) and B / C (128) channels, zamba2-2.7b's d_inner
# (5120), mamba2-130m's (1536); one to three positions (under K), one either
# side of the strip edges at 64 and 128 (every strip length divides 64), the
# cell's shortest prompt and its longest
CHANNELS = (7168, 5120, 1536, 128)
LENGTHS = (1, 2, 3, 63, 65, 127, 129, 949, 4095, 4096)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("B", (1, 4))
@pytest.mark.parametrize("S", LENGTHS)
@pytest.mark.parametrize("C", CHANNELS)
def test_kernel_against_the_float32_composite(card, C, S, B, dtype):
    x, w, b = _inputs(B, S, C, dtype, device=card, seed=S + C)
    before = ops.launch_counts()["causal_conv_silu"]
    got = ops.causal_conv_silu(x, w, b)
    assert ops.launch_counts()["causal_conv_silu"] == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    want = kref.causal_conv_silu_ref(x.float(), w.float(), b.float())
    rtol, atol = TOL[dtype]
    torch.testing.assert_close(got.float(), want, rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_kernel_reads_a_bf16_weight_as_its_float32_widening(card, dtype):
    """Widening bf16 is exact, so a bf16 weight and bias give the bits of
    their float32 copies."""
    x, w, b = _inputs(4, 949, 1536, dtype, torch.bfloat16, device=card)
    assert torch.equal(ops.causal_conv_silu(x, w, b),
                       ops.causal_conv_silu(x, w.float(), b.float()))


@pytest.mark.cuda
def test_kernel_of_a_strided_input_and_under_autograd(card):
    """A non-contiguous x is made contiguous first; a gradient is refused
    and nothing launched."""
    x, w, b = _inputs(2, 33, 256, torch.bfloat16, device=card)
    wide = x[..., :128]
    got = ops.causal_conv_silu(wide, w[:, :128], b[:128])
    want = kref.causal_conv_silu_ref(wide.float(), w[:, :128].float(),
                                     b[:128].float())
    torch.testing.assert_close(got.float(), want, rtol=2.0 ** -8, atol=1e-6)
    before = ops.launch_counts()["causal_conv_silu"]
    with pytest.raises(RuntimeError, match="no backward"):
        ops.causal_conv_silu(x.clone().requires_grad_(), w, b)
    assert ops.launch_counts()["causal_conv_silu"] == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES)
def test_a_zamba2_prefill_on_the_card_launches_three_a_mixer(card,
                                                             monkeypatch,
                                                             dtype):
    """A prefill of the published Zamba2 at smoke size: three
    ``causal_conv_silu`` launches a Mamba2 layer under ``impl="flash"``,
    none under ``impl="xla"``.  In float32 its logits and caches agree
    within 1e-4 of each tensor's scale with the same prefill whose
    convolutions are the composite (every other kernel on both sides, so
    the convolution alone differs; ``wq`` / ``wk`` tempered by 1/8 as in
    ``test_torch_hybrid_card.py``).  In bf16 the composite rounds five
    times a convolution and the kernel once, and at random weights the
    smoke model carries that difference to the logits' own scale, so bf16
    is held to finite logits alone."""
    cfg = dataclasses.replace(smoke_config("zamba2-7b"),
                              param_dtype=str(dtype)[6:],
                              compute_dtype=str(dtype)[6:])
    gen = torch.Generator(device=card).manual_seed(5)
    kernels = build_model(cfg, impl="flash", device=card)
    params = kernels.init(gen)
    for block in params["shared"]:
        block["attn"]["wq"].mul_(0.125)
        block["attn"]["wk"].mul_(0.125)
    batch = kernels.make_inputs(ShapeCell("s", 37, 2, "prefill"), gen)
    with torch.inference_mode():
        ops.reset_launch_counts()
        lk, ck = kernels.prefill(params, batch)
        assert ops.launch_counts()["causal_conv_silu"] == 3 * cfg.num_layers
        ops.reset_launch_counts()
        build_model(cfg, impl="xla", device=card).prefill(params, batch)
        assert set(ops.launch_counts().values()) == {0}
        monkeypatch.setattr(ops, "causal_conv_silu",
                            kref.causal_conv_silu_ref)
        lc, cc = kernels.prefill(params, batch)
    assert ops.launch_counts()["causal_conv_silu"] == 0
    assert bool(torch.isfinite(lk).all())
    if dtype == torch.float32:
        for got, want in ((lk, lc), *zip(tree_leaves(ck),
                                         tree_leaves(cc))):
            scale = float(want.abs().max())
            assert float((got - want).abs().max()) <= 1e-4 * scale
