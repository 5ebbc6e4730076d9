"""``device.peak_gib``: the allocator's peak over the program's set-up and
the window (``torch.cuda.max_memory_allocated`` after a reset once the
graph maker's buffers are freed), in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.peak_bytes > 0 else None
