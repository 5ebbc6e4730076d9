"""``field.readback_ms``: device-to-host copy time a call, inside the calls'
spans (the field's outputs read back to the host), from the trace."""
from portbench.devtrace import FIELD


def read(run):
    trace = run.trace
    if trace is None or not trace.calls():
        return None
    ops = [o for o in trace.ops
           if o.kind == "memcpy" and "DtoH" in o.name and trace.in_span(o, FIELD)]
    if not ops:
        return None
    return trace.busy_ns(ops) / trace.calls() / 1e6
