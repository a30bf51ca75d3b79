"""The weights come from what the program declares of each parameter
(its init and its logical axes), for every family the port has, so a new
configuration needs no change to the harness; and the window keeps no
cache of the calls the check judges."""
import dataclasses
import gc
import math
import weakref

import pytest
import torch

from repro_torch import configs
from repro_torch.models.api import build_model
from repro_torch.models.common import STACKED, tree_leaves
from servebench.core import spec
from servebench.core.traffic import Call
from servebench.core.weights import fan_in, make_params
from servebench.core.window import reserve, serve

CPU = torch.device("cpu")


@pytest.mark.parametrize("name", configs.ARCH_NAMES)
def test_every_family_gets_weights_for_every_declared_leaf(name):
    model = build_model(configs.smoke_config(name), impl="xla", device="cpu")
    defs = model.param_defs()
    params = make_params(defs, 2**31 + 5, torch.float32, CPU)
    assert sorted(params) == sorted(defs)
    for key in defs:
        if key in STACKED:
            layers = tree_leaves(defs[key])[0].shape[0]
            assert isinstance(params[key], list) and \
                len(params[key]) == layers
            got = [t for lp in params[key] for t in tree_leaves(lp)]
            assert len(got) == layers * len(tree_leaves(defs[key]))
        else:
            got = tree_leaves(params[key])
            assert len(got) == len(tree_leaves(defs[key]))
        assert all(bool(torch.isfinite(t).all()) for t in got)


@pytest.mark.parametrize("shape,axes,fan", [
    ((4096, 32, 128), ("d_model", "heads", None), 4096),        # wq
    ((32, 128, 4096), ("heads", None, "d_model"), 32 * 128),    # wo
    ((4096, 14336), ("d_model", "d_ff"), 4096),                  # gate
    ((14336, 4096), ("d_ff", "d_model"), 14336),                 # down
    ((4, 5120), (None, "d_inner"), 4),                           # conv_x
    ((64, 2048, 1408), ("experts", "d_model", "d_ff"), 2048),    # w_gate
    ((512, 16, 256), (None, "heads", None), 512),                # wkv_b
    ((2048,), ("d_model",), 1),
])
def test_fan_in_is_the_dims_a_product_contracts(shape, axes, fan):
    assert fan_in(shape, axes) == fan


def test_each_init_gets_its_distribution():
    model = build_model(configs.smoke_config("llava-next-mistral-7b"),
                        impl="xla", device="cpu")
    defs = model.param_defs()
    p = make_params(defs, 3, torch.float32, CPU)
    layer = defs["layers"]
    gain = torch.stack([lp["ln1"] for lp in p["layers"]])
    assert abs(float(gain.mean()) - 1) < 0.05
    assert abs(float(gain.std()) - 0.1) < 0.03
    assert abs(float(p["embed"].std()) - 1) < 0.05
    wq = torch.stack([lp["attn"]["wq"] for lp in p["layers"]])
    D = layer["attn"]["wq"].shape[1]
    assert abs(float(wq.std()) * math.sqrt(D) - 1) < 0.05


def test_a_size_may_name_a_field_of_a_sub_configuration():
    c = spec.load_cell("llava.longdoc").config
    cfg = spec.port_config(c)
    assert cfg.vlm.num_patches == c["config"]["num_patches"]
    wrong = dict(c, config=dict(c["config"], num_patches=575))
    with pytest.raises(ValueError):
        spec.port_config(wrong)


class _Cache:
    pass


class _Model:
    """Answers ``prefill`` with fixed logits and a fresh cache object."""

    def __init__(self):
        self.caches = []
        self.held = []      # caches still alive at each call's start

    def prefill(self, params, batch):
        self.held.append(sum(c() is not None for c in self.caches))
        cache = _Cache()
        self.caches.append(weakref.ref(cache))
        rows = batch["tokens"].shape[0]
        return torch.arange(6.0).repeat(rows, 1, 1), cache


def test_the_window_keeps_no_cache_and_the_check_serves_it_again():
    model = _Model()
    it = (Call(i, 2, 3 + i % 2, 0) for i in range(100))

    def make(call):
        return {"tokens": torch.full((call.rows, call.text), call.index)}

    win = serve(model, {}, it, make, 0.0, {1}, lambda: None, 2)
    gc.collect()
    assert model.held == [0, 0]
    assert [c() for c in model.caches] == [None] * len(model.caches)
    kept = win.kept[1]
    assert {f.name for f in dataclasses.fields(kept)} == \
        {"served", "batch", "logits"}
    assert kept.batch["tokens"].device.type == "cpu"
    assert kept.logits.tolist() == [[0, 1, 2, 3, 4, 5]] * 2
    batch, cache = reserve(model, {}, kept, CPU)
    assert torch.equal(batch["tokens"], torch.full((2, 4), 1))
    assert cache is model.caches[-1]()
