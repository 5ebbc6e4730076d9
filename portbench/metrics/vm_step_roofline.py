"""``vm_step_roofline``: the least time the card could take for the traced
calls' ``vm_step`` launches (``counts/vm_step.py``: bytes at the peak HBM
rate, or FLOP at the float32 peak, the larger) over the time in which a
``vm_step`` kernel ran, in percent.  Nothing where no such kernel ran or the
card is not in ``peaks.json``."""
from portbench.devtrace import FIELD


def read(run):
    trace, counts, peaks = run.trace, run.vm_step, run.peaks
    if trace is None or counts is None or peaks is None:
        return None
    ops = [o for o in trace.ops
           if o.kind == "kernel" and "vm_step" in o.name and trace.in_span(o, FIELD)]
    busy = trace.busy_ns(ops) / 1e9
    if busy <= 0:
        return None
    bound = max(counts["bytes"] / peaks["hbm_bytes_per_s"],
                counts["flops"] / peaks["fp32_flops_per_s"])
    return 100.0 * bound / busy
