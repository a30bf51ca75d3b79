"""gemm.peak_share: the weight products' FLOPs (every linear layer of the
traced prefills, from the configuration's shapes) over the device time of
the GEMM kernels (cuBLAS's nvjet / xmma and CUTLASS kernels, by name), as a
share of the card's bf16 peak, in %.  Where attention runs as batched
products (the composite path), their kernels are GEMMs too and their time
lowers this share."""
import re

PATTERN = re.compile(r"nvjet|gemm|xmma|cutlass|splitk", re.IGNORECASE)


def read(trace):
    seconds = trace.seconds_matching(PATTERN)
    if seconds <= 0 or not trace.peaks:
        return None
    return 100.0 * trace.total("linear_flops") / seconds \
        / trace.peaks["bf16_flops"]
