"""device_idle_share: the share of the traced window in which no operation
ran on the device (kernels, copies and fills; their union), in %."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
