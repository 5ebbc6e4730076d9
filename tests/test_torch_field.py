"""The port's extroversion field against the JAX reference.

``backend="torch"`` (the plain fused field, the CPU path) is held to the
reference's ``jnp`` and ``pallas`` backends at the tolerances of
tests/test_swap_parity.py, and — being the same float32 arithmetic in the
same order — to the ``jnp`` backend bitwise.  The kernel backend's depth
chain is exercised on the CPU with the plain ``vm_step`` in place of the
kernel, and the paper's worked-example values are checked directly."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.rpq import parse_rpq as r_parse
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.visitor import extroversion_field as r_field
from repro.graphs.generators import provgen_like as r_provgen_like
from repro.graphs.partition import hash_partition

from repro_torch.convert import from_reference_arrays
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import _field, extroversion_field, vm_cell
from repro_torch.graphs.generators import (paper_example_graph,
                                           paper_example_partition,
                                           provgen_like)

V3, V6 = 2, 5
OUTPUTS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to")


def _setup(seed, queries, k, n, depth_cap=None):
    g, rg = provgen_like(n, seed=seed), r_provgen_like(n, seed=seed)
    w = [(parse_rpq(q), 1.0 / len(queries)) for q in queries]
    rw = [(r_parse(q), 1.0 / len(queries)) for q in queries]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    r_arrays = RTPSTry.from_workload(rw).compile(rg.label_names)
    return g, rg, arrays, r_arrays, hash_partition(g.n, k, seed=seed)


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "two-phase"])
def test_torch_field_matches_reference_backends(dense):
    g, rg, arrays, r_arrays, part = _setup(
        9, ["Entity.Entity.Entity", "Agent.Activity.Entity"], 4, 800)
    f = extroversion_field(g, arrays, part, 4, dense_ext_to=dense,
                           backend="torch", device="cpu")
    for backend in ("jnp", "pallas"):
        r = r_field(rg, r_arrays, part, 4, dense_ext_to=dense, backend=backend)
        for name in ("alpha", "edge_mass", "pr", "extro_mass"):
            np.testing.assert_allclose(getattr(f, name), getattr(r, name),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(f.extroversion, r.extroversion,
                                   rtol=1e-3, atol=1e-6)
        if dense:
            np.testing.assert_allclose(f.ext_to, r.ext_to, rtol=1e-4, atol=1e-6)
        else:
            assert f.ext_to is None and r.ext_to is None
        assert f.total_extroversion == pytest.approx(
            r.total_extroversion, rel=1e-4, abs=1e-6)


@pytest.mark.parametrize("seed,queries,k,depth_cap", [
    (11, ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
          "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"], 8, None),
    (2, ["Entity.Entity.Entity"], 3, 2),
])
def test_torch_field_bitwise_equals_jnp(seed, queries, k, depth_cap):
    g, rg, arrays, r_arrays, part = _setup(seed, queries, k, 1000)
    f = extroversion_field(g, arrays, part, k, depth_cap=depth_cap, device="cpu")
    r = r_field(rg, r_arrays, part, k, depth_cap=depth_cap, backend="jnp")
    for name in OUTPUTS:
        assert np.array_equal(getattr(f, name), getattr(r, name)), name
    assert f.total_extroversion == r.total_extroversion


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "two-phase"])
def test_kernel_depth_chain_equals_fused_field(dense):
    """The ``cuda`` backend's delta-state chain, run on the CPU with the
    plain ``vm_step`` standing in for the kernel, rounds every message and
    sum like the fused field: bitwise equal outputs."""
    g, _, arrays, _, part = _setup(
        7, ["Entity.(Entity)*.Entity", "Entity.Activity.(Agent)*"], 5, 900)
    cpu = torch.device("cpu")
    outs = [_field(g, arrays, part, 5, arrays.max_depth, {}, dense, backend, cpu)
            for backend in ("cuda", "torch")]
    for a, b in zip(*outs):
        if a is None:
            assert b is None
        else:
            assert torch.equal(a, b)


def test_field_device_and_backend_checks():
    g = paper_example_graph()
    arrays = TPSTry.from_workload([(parse_rpq("a.b"), 1.0)]).compile(g.label_names)
    part = paper_example_partition()
    with pytest.raises(ValueError):
        extroversion_field(g, arrays, part, 2, backend="cuda", device="cpu")
    with pytest.raises(ValueError):
        extroversion_field(g, arrays, part, 2, backend="jnp", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            extroversion_field(g, arrays, part, 2)        # default device: cuda


# --- the paper's worked examples (tests/test_visitor_oracle.py values) -------


@pytest.fixture(scope="module")
def paper():
    g = paper_example_graph()
    w = [(parse_rpq("a.(b|c).(c|d)"), 0.5), (parse_rpq("(c|a).c.a"), 0.5)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part = paper_example_partition()
    return g, arrays, part, extroversion_field(g, arrays, part, k=2, device="cpu")


def test_paper_values(paper):
    g, arrays, part, f = paper
    lbl = {s: i for i, s in enumerate(g.label_names)}

    def node_of(path):
        cur = 0
        for sym in path:
            cur = int(arrays.child_index[cur, lbl[sym]])
        return cur

    assert f.alpha[V3, node_of(["c"])] == pytest.approx(0.125, abs=1e-7)
    assert f.alpha[V3, node_of(["c", "c"])] == pytest.approx(0.125, abs=1e-7)
    assert f.alpha[V3, node_of(["a", "c"])] == pytest.approx(0.25, abs=1e-7)
    assert f.pr[V3] == pytest.approx(0.5, abs=1e-7)
    assert f.extro_mass[V3] == pytest.approx(0.0625, abs=1e-7)
    assert f.extroversion[V3] == pytest.approx(0.125, abs=1e-7)
    assert f.introversion[V3] == pytest.approx(0.875, abs=1e-7)
    assert f.ext_to[V3, 0] == pytest.approx(0.0625, abs=1e-7)
    assert f.extro_mass[V6] == pytest.approx(0.0, abs=1e-9)
    np.testing.assert_allclose(f.ext_to.sum(axis=1), f.extro_mass, atol=1e-6)
    np.testing.assert_allclose(vm_cell(g, arrays, [0, 1]),
                               [0, 0, 0.25, 0.5, 0.25, 0], atol=1e-7)


def test_paper_depth_cap(paper, paper_graph, paper_trie, paper_partition):
    """§5.2.2: capping the path length only truncates the field — and the
    capped field equals the reference's (carried over by convert.py)."""
    g, arrays, part, full = paper
    capped = extroversion_field(g, arrays, part, k=2, depth_cap=2, device="cpu")
    assert capped.extro_mass[V3] <= full.extro_mass[V3] + 1e-9
    r_arrays = paper_trie.compile(paper_graph.label_names)
    r = r_field(paper_graph, r_arrays, paper_partition, k=2, depth_cap=2)
    state = from_reference_arrays(trie=vars(r_arrays))
    ported = extroversion_field(g, state.trie, part, k=2, depth_cap=2, device="cpu")
    for name in OUTPUTS:
        np.testing.assert_allclose(getattr(ported, name), getattr(r, name),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
