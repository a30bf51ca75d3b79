"""Config registry: ``get_config(name)``, shape cells, smoke reductions."""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.configs.base import (ArchConfig, EncDecConfig, HybridConfig,
                                MLAConfig, MoEConfig, SSMConfig, VLMConfig)

_ARCH_MODULES = {
    "mamba2-130m": "mamba2_130m",
    "stablelm-12b": "stablelm_12b",
    "internlm2-20b": "internlm2_20b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2-0.5b": "qwen2_0_5b",
    "zamba2-2.7b": "zamba2_2_7b",
    "zamba2-7b": "zamba2_7b",
    "llava-next-mistral-7b": "llava_next_mistral_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "deepseek-v2-lite-16b": "deepseek_v2_lite_16b",
    "whisper-medium": "whisper_medium",
}

ARCH_NAMES: List[str] = list(_ARCH_MODULES)


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def get_config(name: str) -> ArchConfig:
    if name not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_NAMES}")
    import importlib
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[name]}")
    cfg: ArchConfig = mod.CONFIG
    cfg.validate()
    return cfg


def cells_for(name: str) -> List[ShapeCell]:
    """The shape cells that run for this arch (long_500k: SSM/hybrid only)."""
    cfg = get_config(name)
    cells = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.sub_quadratic:
        cells.append(SHAPES["long_500k"])
    return cells


def all_cells() -> List[Tuple[str, ShapeCell]]:
    return [(a, c) for a in ARCH_NAMES for c in cells_for(a)]


def smoke_config(name: str) -> ArchConfig:
    """Reduced same-family config for CPU smoke tests."""
    cfg = get_config(name)
    kw = dict(
        name=cfg.name + "-smoke",
        num_layers=2,
        d_model=64,
        vocab_size=256,
        param_dtype="float32",
        compute_dtype="float32",
    )
    if cfg.family in ("ssm", "hybrid"):
        kw["ssm"] = SSMConfig(d_state=16, d_conv=4, expand=2, head_dim=16,
                              n_groups=1, chunk_size=8)
    if cfg.family == "hybrid" and cfg.hybrid.published:
        # the published form keeps its irregular ids (gaps 1 and 2: three
        # applications over both blocks), adapters and two SSM groups.  Its
        # head is untied here: with the embeddings at std 0.02 and a norm
        # after each block's attention, the input side's gradient of the
        # embeddings is ~1e3 at init, and a tied head then takes a step of
        # plain SGD (the smoke tests' lr 0.05) far past its minimum.  The
        # tied head is held to the reference at small size in
        # servebench/tests/test_servebench_zamba2.py.
        kw["num_layers"] = 5
        kw["hybrid"] = HybridConfig(shared_attn_blocks=2, layer_ids=(1, 2, 4),
                                    adapter_rank=8)
        kw["ssm"] = dataclasses.replace(kw["ssm"], n_groups=2)
        kw["tie_embeddings"] = False
    elif cfg.family == "hybrid":
        kw["num_layers"] = 4
        kw["hybrid"] = HybridConfig(attn_every=2, shared_attn_blocks=2)
    if cfg.family == "hybrid":
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 4
        kw["head_dim"] = 16
        kw["d_ff"] = 128
    elif cfg.family == "ssm":
        kw["num_heads"] = 0
        kw["num_kv_heads"] = 0
        kw["head_dim"] = 0
        kw["d_ff"] = 0
    else:
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 2 if cfg.num_kv_heads < cfg.num_heads else 4
        kw["head_dim"] = 16
        kw["d_ff"] = 128
    if cfg.moe is not None:
        kw["moe"] = MoEConfig(num_experts=4, top_k=2, d_ff_expert=32,
                              num_shared_experts=min(cfg.moe.num_shared_experts, 1),
                              d_ff_shared=32, capacity_factor=1.5,
                              first_dense_layers=min(cfg.moe.first_dense_layers, 1),
                              d_ff_dense=128)
        kw["d_ff"] = 128
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(q_lora_rank=(32 if cfg.mla.q_lora_rank else 0),
                              kv_lora_rank=32, qk_nope_head_dim=16,
                              qk_rope_head_dim=8, v_head_dim=16)
        kw["num_heads"] = 4
        kw["num_kv_heads"] = 4
    if cfg.encdec is not None:
        kw["encdec"] = EncDecConfig(encoder_layers=2, encoder_frames=16)
    if cfg.vlm is not None:
        kw["vlm"] = VLMConfig(num_patches=8)
    return dataclasses.replace(cfg, **kw)
