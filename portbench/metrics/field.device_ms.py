"""``field.device_ms``: time in which a kernel of the field runs, a call
(the union of the kernels' intervals inside the calls' spans; copies left
out), from the trace."""
from portbench.devtrace import FIELD


def read(run):
    trace = run.trace
    if trace is None or not trace.calls():
        return None
    ops = [o for o in trace.ops if o.kind == "kernel" and trace.in_span(o, FIELD)]
    if not ops:
        return None
    return trace.busy_ns(ops) / trace.calls() / 1e6
