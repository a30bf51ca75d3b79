"""prefill_mfu: the model FLOPs of the traced window's prefills, counted
from the configuration's shapes by its reference's ``work`` (weight
products, causal attention at S(S+1)/2, the SSD at the configuration's
chunk), over the traced window's seconds, as a share of the card's bf16
peak, in %."""


def read(trace):
    if not trace.calls or not trace.peaks:
        return None
    return 100.0 * trace.total("model_flops") / trace.window_s \
        / trace.peaks["bf16_flops"]
