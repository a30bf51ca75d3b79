"""Plain float32 reference of the VLM backbone: a Mistral decoder whose
prompt starts with precomputed image-patch embeddings.

Per layer: h += attn(rms_norm(h)), h += swiglu(rms_norm(h)); grouped-query
causal attention with rotary positions over the whole sequence (patches
first, then the text tokens); logits of the last position from the final
norm and the unembedding.  The vision tower is not modelled: the patch
embeddings are inputs, already in the model's width.  A prompt is computed
one row at a time.
"""
from __future__ import annotations

import torch

from servebench.core.counting import causal_attention_flops
from servebench.reference import plain


def prefill(params: dict, batch: dict, cfg: dict, *, on_cache=None,
            quant: plain.Quant = None) -> torch.Tensor:
    """Last-position logits ``[B, V]`` (float32) of ``batch`` (``tokens [B,
    T]``, ``patch_embeds [B, P, D]``).  ``on_cache(kind, index, rows, t)``
    receives the keys and values of layer ``index`` (``kind`` ``"k"`` or
    ``"v"``, ``t [rows, S, KV, hd]``) as a cache holds them."""
    eps, theta = cfg["norm_eps"], cfg["rope_theta"]
    H, KV, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    out = []
    for r in range(batch["tokens"].shape[0]):
        rows = slice(r, r + 1)
        h = torch.cat([batch["patch_embeds"][rows].float(),
                       params["embed"][batch["tokens"][rows]].float()], dim=1)
        for i, lp in enumerate(params["layers"]):
            a, k, v = plain.gqa(lp["attn"], plain.rms_norm(h, lp["ln1"], eps),
                                H, KV, hd, theta, quant)
            if on_cache is not None:
                on_cache("k", i, rows, k)
                on_cache("v", i, rows, v)
            del k, v
            h = h + a
            h = h + plain.swiglu(plain.rms_norm(h, lp["ln2"], eps),
                                 lp["mlp"], quant)
        last = plain.rms_norm(h[:, -1], params["final_norm"], eps)
        out.append(plain.linear(last, params["lm_head"], quant))
    return torch.cat(out)


def work(cfg: dict, rows: int, positions: int) -> dict:
    """The operations a prefill of ``rows`` prompts of ``positions`` must
    do, from the configuration's shapes: ``linear_flops`` (every weight
    product, the unembedding at the last position only), ``model_flops``
    (those and causal attention at S(S+1)/2), and the kernel calls as
    ``attention`` [(B, S, H, KV, hd, calls)] and ``ssd`` [] (none)."""
    D, H, KV, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                    cfg["head_dim"])
    L = cfg["num_layers"]
    per_position = 2 * (D * H * hd + 2 * D * KV * hd + H * hd * D
                        + 3 * D * cfg["d_ff"])
    linear = rows * positions * per_position * L \
        + 2 * rows * D * cfg["vocab_size"]
    attention = L * causal_attention_flops(rows, positions, H, hd)
    return {"linear_flops": linear, "model_flops": linear + attention,
            "attention": [(rows, positions, H, KV, hd, L)], "ssd": []}
