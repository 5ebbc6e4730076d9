"""``setup.graph_s``: host seconds of the program's set-up, from the call of
``LabelledGraph.from_undirected_edges`` through ``vm_csr``, ``Taper``, the
trie's compilation and the warm evaluation (its ``_device_inputs`` and the
kernels' first launch), synchronised."""


def read(run):
    return run.graph_s
