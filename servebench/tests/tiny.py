"""Tiny sizes of each configuration and tiny traffic, for runs of the
harness on the CPU.  The depth is deep enough that the float8 control's
error, which grows with depth, passes the cells' limits at these widths as
it does at full size (8 llava layers: logits 0.10-0.13 against 0.08)."""
import dataclasses

from servebench.core import spec

SIZES = {
    "llava-next-mistral-7b": dict(
        num_layers=8, d_model=128, num_heads=4, num_kv_heads=2, head_dim=32,
        d_ff=256, vocab_size=512, rope_theta=1e6, norm_eps=1e-5,
        num_patches=8),
}
CELLS = ("llava.longdoc", "llava.chat")


def cell(name: str) -> spec.Cell:
    """The cell with its traffic cut to calls of 21 and 40 tokens, at
    most 4 rows a call."""
    c = spec.load_cell(name)
    c.traffic = dict(c.traffic, rows=min(c.traffic["rows"], 4),
                     law={"kind": "choice", "values": [21, 40]},
                     measures="text", per_pass=2)
    return c


def sizes(c: spec.Cell) -> dict:
    return SIZES[c.config["name"]]


def port_config(name: str, dtype: str = "float32"):
    c = spec.load_cell(name)
    cfg = spec.port_config(c.config, SIZES[c.config["name"]])
    return dataclasses.replace(cfg, param_dtype=dtype, compute_dtype=dtype)
