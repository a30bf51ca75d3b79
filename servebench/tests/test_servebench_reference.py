"""The plain references against the port's composite path (impl="xla") in
float32 at tiny widths, and the yardstick's counts against the values
PERF.md's kernel table and a hand count give."""
import pytest
import torch

from servebench.core import counting, spec
from servebench.core.weights import make_batch, make_params
from servebench.reference import plain, vlm
from servebench.tests.tiny import SIZES, port_config


def _cache(cache, path, index):
    for key in path:
        cache = cache[key]
    return cache[index]


@pytest.mark.parametrize("name,rows,text", [
    ("llava.longdoc", 2, 40), ("llava.longdoc", 1, 21),
    ("llava.chat", 3, 32), ("llava.chat", 2, 1)])
def test_reference_matches_the_ports_composite_path(name, rows, text):
    from repro_torch.models.api import build_model
    cell = spec.load_cell(name)
    sizes = SIZES[cell.config["name"]]
    model = build_model(port_config(name), impl="xla", device="cpu")
    cpu = torch.device("cpu")
    params = make_params(model.param_defs(), 5, torch.float32, cpu)
    batch = make_batch(torch.Generator().manual_seed(6), rows, text,
                       sizes.get("num_patches", 0), sizes["vocab_size"],
                       sizes["d_model"], torch.float32, cpu)
    seen = []

    def on_cache(kind, index, r, t):
        want = _cache(cache, cell.config["cache"][kind]["path"], index)[r]
        assert t.shape == want.shape
        torch.testing.assert_close(t, want, rtol=1e-4, atol=1e-5)
        seen.append(kind)

    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        got = cell.reference().prefill(params, batch, sizes,
                                       on_cache=on_cache)
    torch.testing.assert_close(got, logits[:, -1], rtol=1e-4, atol=1e-4)
    assert set(seen) == set(cell.config["cache"])


def test_fp8_rounding_keeps_three_mantissa_bits():
    t = torch.tensor([[1.0, 1.0625, 1.125, -448.0]])
    got = plain.fp8_e4m3(t, -1)
    assert got[0, 3] == -448.0 and got[0, 2] == 1.125
    assert got[0, 1] in (1.0, 1.125)


@pytest.mark.parametrize("shape,bound_us,by", [
    ((4, 1088, 32, 8, 128), 39.26, "operations"),
])
def test_flash_bound_is_the_kernel_tables(shape, bound_us, by):
    b = counting.bound_of(*counting.flash_bound(*shape, 2))
    assert round(b["bound_ms"] * 1e3, 2) == bound_us and b["bound_by"] == by


@pytest.mark.parametrize("shape,bound_us", [
    ((4, 512, 80, 1, 64, 64, 256), 13.56),     # zamba2
    ((4, 512, 24, 1, 64, 128, 256), 4.57),     # mamba2
])
def test_ssd_bound_is_the_kernel_tables(shape, bound_us):
    b = counting.bound_of(*counting.ssd_bound(*shape, 2))
    assert round(b["bound_ms"] * 1e3, 2) == bound_us
    assert b["bound_by"] == "bytes"


def test_llava_model_flops_by_hand():
    # one prompt of 8192 positions: per layer q 4096x4096, k and v
    # 4096x1024 each, o 4096x4096, MLP 3 x 4096x14336; 32 layers; the
    # unembedding 4096x32000 at the last position; attention 4 x 32 heads x
    # 128 x 8192*8193/2 per layer
    per_layer = 2 * 8192 * (4096 * 4096 * 2 + 4096 * 1024 * 2
                            + 3 * 4096 * 14336)
    linear = 32 * per_layer + 2 * 4096 * 32000
    attention = 32 * 4 * 32 * 128 * (8192 * 8193 // 2)
    w = vlm.work(spec.load_cell("llava.longdoc").numbers, 1, 8192)
    # 218 103 808 weights a layer: 2 x 8192 x that x 32 + 262 144 000
    assert w["linear_flops"] == linear == 114_349_471_432_704
    assert w["model_flops"] == linear + attention
    assert w["attention"] == [(1, 8192, 32, 8, 128, 32)] and w["ssd"] == []
