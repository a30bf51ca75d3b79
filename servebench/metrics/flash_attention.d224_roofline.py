"""flash_attention.d224_roofline: the least time the card could take for
the traced window's causal attention calls at head dim 224 (max of bytes
at the HBM rate and operations at the bf16 peak, ``flash_bound`` /
``bound_of`` from their shapes), over the device time of the head-dim-224
flash_attention kernel (``flash_tc224_kernel``) alone, in %."""
import re

from servebench.core.counting import bound_of, flash_bound

PATTERN = re.compile(r"flash_tc224")
HEAD_DIM = 224


def read(trace):
    seconds = trace.seconds_matching(PATTERN)
    if seconds <= 0:
        return None
    bound_ms = sum(bound_of(*flash_bound(B, S, H, KV, d, 2))["bound_ms"] * n
                   for B, S, H, KV, d, n in trace.kernel_calls("attention")
                   if d == HEAD_DIM)
    return 100.0 * bound_ms * 1e-3 / seconds
