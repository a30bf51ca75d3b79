"""The model path's spans (``repro_torch.obs.spans``) on the CPU.

Under ``torch.profiler`` a llava prefill (its smoke configuration) shows
one ``repro.prefill`` holding the embedding, one ``repro.layer`` a layer,
the cache stack and the logits; inside each layer two norms, the q / k / v
products, two RoPE calls, attention, its output product and the MLP with
its gating, and nothing else but the residual adds and the positions the
two RoPE calls share.  With no profiler active a span makes no
``record_function`` at all, and the logits do not move by a bit.
"""
import collections

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import ShapeCell, smoke_config
from repro_torch.models.api import build_model
from repro_torch.obs import spans

PREFIX = "repro."
LAYER_CHILDREN = collections.Counter({
    "repro.rms_norm": 2, "repro.attn.qkv": 1, "repro.rope": 2,
    "repro.attn.core": 1, "repro.attn.out": 1, "repro.mlp": 1})
# ATen ops a layer runs outside its child spans: the two residual adds and
# the positions (``arange`` and a view) that the two RoPE calls share
LAYER_SELF = collections.Counter({"aten::add": 2, "aten::arange": 1,
                                  "aten::unsqueeze": 1})
# outside any child of the prefill: the view of the last position
PREFILL_SELF = collections.Counter({"aten::slice": 1})


def _model(name, impl="xla"):
    cfg = smoke_config(name)
    model = build_model(cfg, impl=impl, device="cpu")
    gen = torch.Generator().manual_seed(3)
    params = model.init(gen)
    batch = model.make_inputs(ShapeCell("s", 12, 2, "prefill"), gen)
    return cfg, model, params, batch


def _llava(impl):
    return _model("llava-next-mistral-7b", impl)


def _traced(model, params, batch):
    with torch.inference_mode(), \
            profile(activities=[ProfilerActivity.CPU]) as prof:
        logits, _ = model.prefill(params, batch)
    return logits, prof.events()


def _roots(events, name):
    return [e for e in events if e.name == name and (
        e.cpu_parent is None or not e.cpu_parent.name.startswith(PREFIX))]


def _children(e):
    return collections.Counter(c.name for c in e.cpu_children)


def _self_ops(e):
    return collections.Counter(c.name for c in e.cpu_children
                               if not c.name.startswith(PREFIX))


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_a_prefill_has_the_span_tree(impl):
    cfg, model, params, batch = _llava(impl)
    _, events = _traced(model, params, batch)
    (prefill,) = _roots(events, "repro.prefill")
    assert not [e for e in events if e.name.startswith(PREFIX)
                and e.cpu_parent is None and e is not prefill]
    spans_in = {k: v for k, v in _children(prefill).items()
                if k.startswith(PREFIX)}
    assert spans_in == {"repro.embed": 1, "repro.layer": cfg.num_layers,
                        "repro.cache.stack": 1, "repro.logits": 1}
    assert _self_ops(prefill) == PREFILL_SELF
    layers = [c for c in prefill.cpu_children if c.name == "repro.layer"]
    for layer in layers:
        got = {k: v for k, v in _children(layer).items()
               if k.startswith(PREFIX)}
        assert got == LAYER_CHILDREN
        assert _self_ops(layer) == LAYER_SELF
        (mlp,) = [c for c in layer.cpu_children if c.name == "repro.mlp"]
        assert _children(mlp)["repro.mlp.gate"] == 1
    (logits,) = [c for c in prefill.cpu_children if c.name == "repro.logits"]
    assert _children(logits)["repro.rms_norm"] == 1


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_attention_itself_lies_in_its_core_span(impl):
    _, model, params, batch = _llava(impl)
    _, events = _traced(model, params, batch)
    core = [e for e in events if e.name == "repro.attn.core"]
    assert core and all(_self_ops(e) for e in core)
    # the rest of a layer's products are in the other spans
    for e in events:
        if e.name == "aten::einsum" and e.cpu_parent is not None:
            assert e.cpu_parent.name.startswith(PREFIX), e.cpu_parent.name


@pytest.mark.parametrize("name", ["qwen2-0.5b", "mamba2-130m", "zamba2-2.7b",
                                  "zamba2-7b", "deepseek-v2-lite-16b",
                                  "whisper-medium"])
def test_every_family_opens_one_prefill_span(name):
    cfg, model, params, batch = _model(name)
    _, events = _traced(model, params, batch)
    (prefill,) = _roots(events, "repro.prefill")
    named = [e for e in events if e.name.startswith(PREFIX)]
    assert all(e is prefill or e.time_range.start >= prefill.time_range.start
               and e.time_range.end <= prefill.time_range.end for e in named)
    if cfg.family in ("dense", "moe"):
        assert sum(e.name == "repro.layer" for e in named) == cfg.num_layers


def test_off_a_span_is_one_shared_no_op():
    assert spans.span("repro.a") is spans.span("repro.b")
    with profile(activities=[ProfilerActivity.CPU]):
        on = spans.span("repro.a")
    assert isinstance(on, torch.autograd.profiler.record_function)


def test_off_a_prefill_makes_no_record_function(monkeypatch):
    _, model, params, batch = _llava("flash")
    traced, _ = _traced(model, params, batch)

    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered with no profiler")
    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        refuse)
    with pytest.raises(AssertionError):
        with torch.autograd.profiler.record_function("check"):
            pass
    with torch.inference_mode():
        logits, _ = model.prefill(params, batch)
    assert torch.equal(logits, traced)


SSM_CHILDREN = {"repro.rms_norm", "repro.ssm.in_proj", "repro.ssm.conv",
                "repro.ssm.gate_norm", "repro.ssm.out_proj"}


@pytest.mark.parametrize("length,scan", [(16, "repro.ssm.scan"),
                                         (12, "repro.ssm.scan.whole")])
def test_a_hybrid_prefill_spans_its_mixers_and_shared_blocks(length, scan):
    """The published Zamba2 at smoke size (chunk 8): one ``repro.ssm`` a
    layer holding its pre-norm, products, convolution, scan, gate norm and
    output product, the scan under ``repro.ssm.scan.whole`` where the chunk
    does not divide the prompt; one ``repro.shared`` an application with its
    norm, attention, adapter and linear inside."""
    cfg = smoke_config("zamba2-7b")
    model = build_model(cfg, impl="flash", device="cpu")
    params = model.init(torch.Generator().manual_seed(3))
    batch = model.make_inputs(ShapeCell("s", length, 2, "prefill"),
                              torch.Generator().manual_seed(4))
    _, events = _traced(model, params, batch)
    mixers = [e for e in events if e.name == "repro.ssm"]
    assert len(mixers) == cfg.num_layers
    for e in mixers:
        assert {n for n in _children(e) if n.startswith(PREFIX)} == \
            SSM_CHILDREN | {scan}
    shared = [e for e in events if e.name == "repro.shared"]
    assert len(shared) == len(cfg.hybrid.layer_ids)
    inner = {"repro.shared.norm", "repro.attn.qkv", "repro.attn.core",
             "repro.shared.adapter", "repro.shared.linear"}
    for e in shared:
        names = set()
        stack = list(e.cpu_children)
        while stack:
            c = stack.pop()
            names.add(c.name)
            stack += c.cpu_children
        assert inner <= names
