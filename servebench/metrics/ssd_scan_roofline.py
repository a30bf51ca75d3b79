"""ssd_scan_roofline: the least time the card could take for the traced
window's SSD scans at the configuration's chunk (``ssd_bound`` /
``bound_of`` from their shapes), over the device time of the ssd_scan
kernels, in %."""
import re

from servebench.core.counting import bound_of, ssd_bound

PATTERN = re.compile(r"ssd_")


def read(trace):
    seconds = trace.seconds_matching(PATTERN)
    if seconds <= 0:
        return None
    bound_ms = sum(bound_of(*ssd_bound(*shape, 2))["bound_ms"] * n
                   for *shape, n in trace.kernel_calls("ssd"))
    return 100.0 * bound_ms * 1e-3 / seconds
