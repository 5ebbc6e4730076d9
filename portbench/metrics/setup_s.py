"""``setup_s``: from the start of the benchmark's process to the first timed
call: CUDA, the graph maker, the program's graph, CSR, Taper and trie, the
kernels' build on a checkout's first run, one warm evaluation and draw."""


def read(run):
    return run.setup_s
