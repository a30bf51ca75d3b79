"""The published Zamba2 (``zamba2-7b``) against its plain reference on the
CPU, in float32 on seeded random weights at a small size of the published
form: two shared blocks over three applications at irregular ids, two SSM
groups, a head dim that is not d_model / heads, adapters, and prompts whose
length the chunk does not divide.  Also: its configuration file against
the published config, its grouped gate norm against a plain one, its
yardstick's count of the weight products, and a run of the harness on its
cell at that size."""
import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.models.api import build_model
from servebench.core import cli, spec
from servebench.core.control import Control
from servebench.core.weights import make_batch, make_params
from servebench.reference import zamba2

CELL = "zamba2-7b.prefill"
CPU = torch.device("cpu")
SIZES = dict(
    num_layers=7, d_model=32, num_heads=4, num_kv_heads=4, head_dim=16,
    d_ff=64, vocab_size=128, rope_theta=10000.0, norm_eps=1e-5,
    tie_embeddings=True, d_state=8, d_conv=4, expand=2, ssm_head_dim=8,
    n_groups=2, chunk_size=8, shared_attn_blocks=2, layer_ids=[1, 3, 6],
    adapter_rank=4)

# Zamba2-7B-Instruct's config.json: the sizes the port must run
PUBLISHED = {
    "num_hidden_layers": 81, "hidden_size": 3584, "vocab_size": 32000,
    "max_position_embeddings": 4096, "mamba_expand": 2, "mamba_headdim": 64,
    "n_mamba_heads": 112, "mamba_ngroups": 2, "mamba_d_state": 64,
    "mamba_d_conv": 4, "chunk_size": 256, "num_mem_blocks": 2,
    "hybrid_layer_ids": [6, 11, 17, 23, 29, 35, 41, 47, 53, 59, 65, 71, 77],
    "attention_hidden_size": 7168, "num_attention_heads": 32,
    "num_key_value_heads": 32, "attention_head_dim": 224,
    "ffn_hidden_size": 14336, "adapter_rank": 128, "use_mem_rope": True,
    "rope_theta": 10000, "rms_norm_eps": 1e-5, "hidden_act": "gelu",
    "use_shared_mlp_adapter": True, "use_shared_attention_adapter": False,
}


def _model(impl="flash"):
    cell = spec.load_cell(CELL)
    cfg = spec.port_config(cell.config, SIZES)
    cfg = dataclasses.replace(cfg, param_dtype="float32",
                              compute_dtype="float32")
    model = build_model(cfg, impl=impl, device="cpu")
    return cell, model, make_params(model.param_defs(), 2**31 + 9,
                                    torch.float32, CPU)


def _batch(rows, text, seed=3):
    return make_batch(torch.Generator().manual_seed(seed), rows, text, 0,
                      SIZES["vocab_size"], SIZES["d_model"], torch.float32,
                      CPU)


def _cache(cache, path, index):
    for key in path:
        cache = cache[key]
    return cache[index]


@pytest.mark.parametrize("impl,rows,text", [
    ("flash", 2, 21), ("flash", 1, 16), ("xla", 3, 13), ("pallas", 1, 5)])
def test_prefill_logits_and_every_cache_entry_match_the_reference(
        impl, rows, text):
    cell, model, params = _model(impl)
    batch = _batch(rows, text)
    seen = []

    def on_cache(kind, index, r, t):
        want = _cache(cache, cell.config["cache"][kind]["path"], index)[r]
        assert t.shape == want.shape, (kind, index)
        torch.testing.assert_close(t, want, rtol=1e-4, atol=1e-5)
        seen.append((kind, index))

    with torch.no_grad():
        logits, cache = model.prefill(params, batch)
        got = zamba2.prefill(params, batch, SIZES, on_cache=on_cache)
    torch.testing.assert_close(got, logits[:, -1], rtol=1e-4, atol=1e-4)
    apps, layers = len(SIZES["layer_ids"]), SIZES["num_layers"]
    assert sorted(seen) == sorted(
        [(k, j) for k in ("k", "v") for j in range(apps) for _ in range(rows)]
        + [("ssm", i) for i in range(layers) for _ in range(rows)])
    assert cache["attn"]["k"].shape == (apps, rows, text, 4, 16)


def test_prefill_then_decode_through_the_cache_is_the_full_forward():
    """Prefill 11 tokens, then decode 4 through the padded cache: each
    step's logits are the reference's last-position logits of the whole
    prompt so far."""
    _, model, params = _model("flash")
    batch = _batch(2, 15, seed=4)
    tokens = batch["tokens"]
    with torch.no_grad():
        _, cache = model.prefill(params, {"tokens": tokens[:, :11]})
        cache = model.pad_cache(cache, 15)
        for pos in range(11, 15):
            logits, cache = model.decode_step(
                params, cache, {"tokens": tokens[:, pos:pos + 1],
                                "pos": torch.tensor(pos)})
            want = zamba2.prefill(params, {"tokens": tokens[:, :pos + 1]},
                                  SIZES)
            torch.testing.assert_close(logits[:, -1], want, rtol=1e-4,
                                       atol=1e-4)


@pytest.mark.parametrize("impl", ["xla", "flash"])
def test_the_grouped_gate_norm_is_a_norm_of_each_group(impl):
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, 48, generator=g)
    w = 1 + 0.1 * torch.randn(48, generator=g)
    want = torch.cat([
        part * torch.rsqrt(part.square().mean(-1, keepdim=True) + 1e-5)
        for part in x.split(16, dim=-1)], dim=-1) * w
    got = common.rms_norm(x, w, 1e-5, impl, groups=3)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ops.rmsnorm(x, w, 1e-5, 3), want, rtol=1e-6,
                               atol=1e-6)
    assert not torch.allclose(common.rms_norm(x, w, 1e-5, impl), want)


def test_the_configuration_file_is_the_published_config():
    conf = json.loads((spec.ROOT / "servebench/configs/"
                       "zamba2-7b-instruct.json").read_text())
    for key, value in PUBLISHED.items():
        assert conf[key] == value, key
    assert conf["reduced"] == []
    cfg = spec.port_config(conf)          # raises where a size differs
    assert cfg == dataclasses.replace(get_config("zamba2-7b"),
                                      param_dtype="bfloat16",
                                      compute_dtype="bfloat16")
    s, hb = cfg.ssm, cfg.hybrid
    assert (cfg.num_layers, cfg.d_model, cfg.vocab_size) == (81, 3584, 32000)
    assert (s.expand * cfg.d_model, s.n_heads(cfg.d_model), s.head_dim,
            s.n_groups, s.d_state, s.d_conv, s.chunk_size) == \
        (7168, 112, 64, 2, 64, 4, 256)
    assert hb.layer_ids == tuple(PUBLISHED["hybrid_layer_ids"])
    assert (hb.shared_attn_blocks, hb.adapter_rank) == (2, 128)
    assert (cfg.num_heads * cfg.head_dim, cfg.num_heads, cfg.num_kv_heads,
            cfg.head_dim, cfg.d_ff) == (2 * 3584, 32, 32, 224, 14336)
    assert cfg.tie_embeddings and cfg.norm_eps == 1e-5 \
        and cfg.rope_theta == 10000


def test_work_counts_every_weight_product_once():
    """linear_flops is twice the weights of every product a position
    passes through (the tied unembedding once a row), and the kernels'
    calls are the cell's: an attention call a application, an SSD call a
    layer at the configuration's chunk."""
    _, model, _ = _model()
    defs = model.param_defs()
    apps, layers = len(SIZES["layer_ids"]), SIZES["num_layers"]
    mixer = sum(d.shape[1] * d.shape[2] for k, d in
                defs["ssm_layers"].items()
                if k.startswith("in_") or k == "out_proj")
    shared = defs["shared"]
    per_app = sum(common.param_count_tree(shared[k]) for k in
                  ("attn", "mlp")) // SIZES["shared_attn_blocks"] \
        + common.param_count_tree(defs["apps"]) // apps
    per_position = layers * mixer + apps * per_app
    got = zamba2.work(SIZES, 2, 21)
    V, D = SIZES["vocab_size"], SIZES["d_model"]
    assert got["linear_flops"] == 2 * 2 * 21 * per_position + 2 * 2 * D * V
    assert got["attention"] == [(2, 21, 4, 4, 16, apps)]
    assert got["ssd"] == [(2, 21, 8, 2, 8, 8, 8, layers)]
    assert got["model_flops"] > got["linear_flops"]


def _tiny_cell():
    c = spec.load_cell(CELL)
    c.traffic = dict(c.traffic, law={"kind": "choice", "values": [13, 24]},
                     per_pass=2)
    return c


def test_a_sound_run_of_the_cell_is_correct():
    result, verdicts = cli.run_cell(_tiny_cell(), 2**31 + 77, 0.2, False,
                                    CPU, numbers=SIZES)
    assert result["correct"] is True, result["check"]
    assert {v["name"] for v in verdicts} == {"logits_rel", "kv_rel",
                                             "state_rel"}
    assert result["attempted"] % 8 == 0


def test_a_state_left_out_of_the_cache_is_not_correct(monkeypatch):
    """The check reads the SSM states: zeroing them in the served cache
    fails state_rel though the logits hold."""
    import repro_torch.models.api as api
    original = api.Model.prefill

    def prefill(self, params, batch):
        logits, cache = original(self, params, batch)
        cache["ssm_layers"]["ssm"].zero_()
        return logits, cache
    monkeypatch.setattr(api.Model, "prefill", prefill)
    result, verdicts = cli.run_cell(_tiny_cell(), 2**31 + 77, 0.2, False,
                                    CPU, numbers=SIZES)
    assert result["correct"] is False
    bad = {v["name"] for v in verdicts if not v["ok"]}
    assert bad == {"state_rel"}


def test_the_control_is_not_correct(monkeypatch):
    """The reference one precision below the configuration's (float8
    operands) in the program's place fails the cell's limits at this size
    too."""
    import repro_torch.models.api as api
    c = _tiny_cell()
    build = api.build_model
    monkeypatch.setattr(api, "build_model", lambda cfg, **kw: Control(
        build(cfg, **kw), c.reference(), SIZES, c.config["cache"]))
    result, _ = cli.run_cell(c, 3, 0.2, False, CPU, numbers=SIZES)
    assert result["correct"] is False, result["check"]
