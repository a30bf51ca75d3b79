"""other_kernels.us_per_token: device microseconds of every operation that
is neither a GEMM nor one of the port's kernels (flash_attention,
ssd_scan): norms, RoPE, gating, the convolution, copies and casts, the
composite attention's softmax and masks; per prompt position of the traced
window."""
import re

NOT_OTHER = re.compile(r"nvjet|gemm|xmma|cutlass|splitk|flash_|ssd_",
                       re.IGNORECASE)


def read(trace):
    if not trace.calls:
        return None
    other = sum(v for k, v in trace.kernel_s.items()
                if not NOT_OTHER.search(k))
    return 1e6 * other / trace.positions
