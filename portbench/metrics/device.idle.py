"""``device.idle``: share of the traced window in which the card runs no
kernel and no copy, in percent.  Nothing where the trace holds no device
operation."""


def read(run):
    trace = run.trace
    if trace is None or not trace.ops or trace.window_ns() <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_ns(trace.ops) / trace.window_ns())
