"""The device's idle share over the traced window: 1 - the union of its
kernel, copy and fill intervals over the window's wall time, both from the
same run."""


def read(trace, run):
    if trace.busy_s <= 0:
        return None
    return 1.0 - trace.busy_s / trace.window_s
