"""``field.host_ms``: time in which the card runs no kernel and no copy
inside the program's own ranges of ``Taper.field`` (its ``field.key`` span
and its evaluation's root span ``invocation.field``, ``torch.profiler``
ranges while the profiler records), an evaluation: the field's host work
between its device operations, from the trace.  Nothing where the trace
holds no device operation, or the program records no such range."""
import bisect

ROOT = "invocation.field"
RANGES = (ROOT, "field.key")


def read(run):
    trace = run.trace
    if trace is None or not trace.ops:
        return None
    ranges = [(a, b, name) for a, b, name in trace.host_ops if name in RANGES]
    calls = sum(name == ROOT for _, _, name in ranges)
    if not calls:
        return None
    busy = trace.busy_intervals(trace.ops)
    starts = [a for a, _ in busy]
    idle = 0
    for a, b, _ in ranges:
        i = max(bisect.bisect_right(starts, a) - 1, 0)
        covered = 0
        while i < len(busy) and busy[i][0] < b:
            covered += max(0, min(b, busy[i][1]) - max(a, busy[i][0]))
            i += 1
        idle += (b - a) - covered
    return idle / calls / 1e6
