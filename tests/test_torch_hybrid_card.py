"""The published Zamba2's kernel routes on the card.

``flash_attention`` at head dim 224 (``flash_tc224_kernel``, with the
model's own scale) and the grouped ``rmsnorm`` against their plain
versions, and a prefill of the published form (head dim 224, two SSM
groups, irregular hybrid ids) under a kernel lowering: one
``flash_attention`` launch an application, one ``ssd_scan`` call and three
``causal_conv_silu`` launches a layer, its logits and caches in float32 within 1e-4 of the composite
path's scale.
The tests skip without a card; on one they run with ``PYTHONPATH=src
python -m pytest -q -m cuda tests/test_torch_hybrid_card.py``.
"""
import dataclasses

import pytest
import torch

from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.kernels import ops
from repro_torch.kernels import ref as kref
from repro_torch.models.api import build_model
from repro_torch.models.common import tree_leaves

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("shape", [(2, 1, 2, 1, 224), (1, 64, 2, 2, 224),
                                   (1, 129, 2, 2, 224), (2, 333, 8, 2, 224),
                                   (1, 700, 4, 4, 224)])
def test_flash_attention_at_head_dim_224(card, shape, causal, dtype):
    B, S, H, KV, d = shape
    g = torch.Generator(device=card).manual_seed(S + H)
    q = torch.randn(B, S, H, d, generator=g, device=card).to(dtype)
    k = torch.randn(B, S, KV, d, generator=g, device=card).to(dtype)
    v = torch.randn(B, S, KV, d, generator=g, device=card).to(dtype)
    scale = (d / 2) ** -0.5
    got = ops.flash_attention(q, k, v, causal=causal, scale=scale)
    want = kref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                              scale=scale)
    torch.testing.assert_close(got.float(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
@pytest.mark.parametrize("shape,groups", [((4, 37, 7168), 2),
                                          ((3, 48), 3), ((2, 5, 4096), 1)])
def test_grouped_rmsnorm_norms_each_group(card, shape, groups, dtype):
    g = torch.Generator(device=card).manual_seed(shape[-1])
    x = torch.randn(shape, generator=g, device=card).to(dtype)
    w = 1 + 0.1 * torch.randn(shape[-1], generator=g, device=card)
    G = shape[-1] // groups
    got = ops.rmsnorm(x, w.to(dtype), 1e-5, groups)
    want = kref.rmsnorm_ref(x.float().reshape(*shape[:-1], groups, G),
                            w.to(dtype).float().reshape(groups, G)
                            ).reshape(shape)
    torch.testing.assert_close(got.float(), want, rtol=TOL[dtype],
                               atol=TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ("flash", "pallas"))
@pytest.mark.parametrize("length", (24, 21))
def test_a_published_hybrid_prefill_runs_both_kernels(card, impl, length):
    """Float32 (the kernels' float32 routes), so the composite path is held
    to 1e-4 of each tensor's scale, as phase serve of chip_smoke.py holds
    every kernel lowering; 21 positions scan as one chunk (chunk 8).  As
    there, ``wq`` and ``wk`` are scaled by 1/8 after ``init`` (whose fan-in
    of ``wq [D, heads, hd]`` is the head count): untempered scores reach
    ~100 and the softmax turns float32 rounding into 1e-3 of the logits."""
    cfg = dataclasses.replace(smoke_config("zamba2-7b"), num_heads=2,
                              num_kv_heads=2, head_dim=224)
    kernels = build_model(cfg, impl=impl, device=card)
    composite = build_model(cfg, impl="xla", device=card)
    params = kernels.init(7)
    for block in params["shared"]:
        block["attn"]["wq"].mul_(0.125)
        block["attn"]["wk"].mul_(0.125)
    batch = kernels.make_inputs(ShapeCell("s", length, 2, "prefill"),
                                torch.Generator(device=card).manual_seed(8))
    ops.reset_launch_counts()
    with torch.inference_mode():
        lk, ck = kernels.prefill(params, batch)
        counts = ops.launch_counts()
        lx, cx = composite.prefill(params, batch)
    apps, layers = len(cfg.hybrid.layer_ids), cfg.num_layers
    assert counts["flash_attention"] == apps
    assert counts["ssd_scan"] == layers
    # the x, B and C convolutions of each Mamba2 layer
    assert counts["causal_conv_silu"] == 3 * layers
    # two norms an application and a layer, and the final one
    assert counts["rmsnorm"] == 2 * apps + 2 * layers + 1
    for a, b in [(lk, lx)] + list(zip(tree_leaves(ck), tree_leaves(cx))):
        assert float((a - b).abs().max()) <= 1e-4 * float(b.abs().max())
