"""The port's ``embedding_bag`` against the JAX reference: the reference's
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs it)
and its jnp oracle, on the same numpy-seeded inputs.  On the CPU the
wrapper takes the plain torch version; the CUDA kernel itself is checked on
the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.embedding_bag.ops import embedding_bag_pallas
from repro.kernels.embedding_bag.ref import embedding_bag_reference as r_reference

from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

# the JAX sweep's ranges (tests/test_kernels.py): v 10-3000, d in {8, 32, 64},
# b 1-300, h in {1, 2, 8}, sum and mean
_rng = np.random.default_rng(20261018)
SWEEP = [(int(_rng.integers(10, 3001)), d, int(_rng.integers(1, 301)),
          int(_rng.choice([1, 2, 8])), combiner, int(_rng.integers(0, 2**16)))
         for d in (8, 32, 64) for combiner in ("sum", "mean") for _ in range(2)]


@pytest.mark.parametrize("v,d,b,h,combiner,seed", SWEEP)
def test_embedding_bag_sweep_matches_reference(v, d, b, h, combiner, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (b, h)).astype(np.int32)
    out = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                        combiner).numpy()
    pallas = np.asarray(embedding_bag_pallas(
        jnp.asarray(table), jnp.asarray(ids), combiner=combiner,
        block_b=64, block_v=256))
    oracle = np.asarray(r_reference(jnp.asarray(table), jnp.asarray(ids),
                                    combiner))
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-5)


def test_embedding_bag_repeated_ids_count_per_occurrence():
    table = np.eye(8, 4, dtype=np.float32)
    ids = np.array([[2, 2, 2, 0]], np.int32)
    out = embedding_bag(torch.from_numpy(table), torch.from_numpy(ids)).numpy()
    pallas = np.asarray(embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids),
                                             block_b=8, block_v=8))
    assert np.array_equal(out, np.array([[1.0, 0.0, 3.0, 0.0]], np.float32))
    assert np.array_equal(out, pallas)


def test_embedding_bag_out_of_range_ids_add_nothing():
    """The port's rule follows the Pallas kernel: an id outside [0, V) adds
    nothing (the jnp oracle wraps -1 and fills NaN past V instead); mean
    still divides by H, padded slots included."""
    table = np.arange(12, dtype=np.float32).reshape(4, 3)
    ids = np.array([[0, -1], [1, 5]], np.int32)
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    want = np.array([[0, 1, 2], [3, 4, 5]], np.float32)
    assert np.array_equal(embedding_bag(t, i).numpy(), want)
    assert np.array_equal(embedding_bag(t, i, "mean").numpy(), want / 2)
    pallas = np.asarray(embedding_bag_pallas(jnp.asarray(table), jnp.asarray(ids)))
    assert np.array_equal(pallas, want)
    oracle = np.asarray(r_reference(jnp.asarray(table), jnp.asarray(ids)))
    assert not np.array_equal(oracle, want)      # the reference's jnp.take rule


def test_embedding_bag_plain_on_cpu_counts_no_launch():
    before = embedding_bag.launches
    table = torch.rand(10, 4)
    ids = torch.tensor([[1, 2, 3]], dtype=torch.int32)
    out = embedding_bag(table, ids)
    torch.testing.assert_close(out, (table[1] + table[2] + table[3])[None],
                               rtol=1e-6, atol=1e-7)
    assert embedding_bag.launches == before
    assert torch.equal(out, embedding_bag_reference(table, ids))


@pytest.mark.parametrize("bad", [
    (torch.rand(10, 4, dtype=torch.float64), torch.zeros(2, 3, dtype=torch.int32), "sum"),
    (torch.rand(10, 4), torch.zeros(2, 3, dtype=torch.int64), "sum"),
    (torch.rand(10, 4), torch.zeros(6, dtype=torch.int32), "sum"),
    (torch.rand(10, 8)[:, ::2], torch.zeros(2, 3, dtype=torch.int32), "sum"),
    (torch.rand(10, 4), torch.zeros(2, 3, dtype=torch.int32), "max"),
])
def test_embedding_bag_rejects_bad_arguments(bad):
    with pytest.raises(ValueError):
        embedding_bag(*bad)


def test_embedding_bag_has_no_plain_fallback_off_the_cpu():
    """A tensor on a device that is neither the CPU nor CUDA raises: the
    plain version serves CPU tensors only."""
    table = torch.empty(10, 4, device="meta")
    ids = torch.empty(2, 3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        embedding_bag(table, ids)


# ---------------------------------------------------------------------------
# the backward's CSR: what the backward kernel sums over, in what order
# ---------------------------------------------------------------------------


def _emulate_backward(g, row_ptr, bag, runs, lr):
    """The backward kernel's arithmetic on the CPU, from its CSR: each row
    summed in slot order from 0, one float32 add a slot, one gather a run
    of equal bag.  The rows in ``lr`` (up to its first -1) as the long-row
    kernel takes them, from the run list (``run_of`` of the row's first and
    last entries bound its runs; each run's ``run_bag`` added ``run_len``
    times); the others, with at most LONG_SLOTS slots, as the rows kernel
    takes them, from ``bag``, a new gather where the bag changes.  Returns
    the gradient and the gathers made."""
    from repro_torch.kernels.embedding_bag.ops import LONG_SLOTS

    g, row_ptr, bag = g.numpy(), row_ptr.numpy(), bag.numpy()
    run_of, run_bag, run_len = (t.numpy() for t in runs)
    long_set = {int(r) for r in lr.numpy() if r >= 0}
    out = np.zeros((row_ptr.shape[0] - 1, g.shape[1]), np.float32)
    gathers = 0
    for r in np.nonzero(np.diff(row_ptr))[0]:
        e0, e1 = row_ptr[r], row_ptr[r + 1]
        assert (e1 - e0 > LONG_SLOTS) == (int(r) in long_set)   # one path a row
        acc = np.zeros(g.shape[1], np.float32)
        if int(r) in long_set:
            for j in range(run_of[e0], run_of[e1 - 1] + 1):
                cur = g[run_bag[j]]
                gathers += 1
                for _ in range(run_len[j]):
                    acc = acc + cur
        else:
            prev = -1
            for e in range(e0, e1):
                if bag[e] != prev:
                    cur, prev = g[bag[e]], bag[e]
                    gathers += 1
                acc = acc + cur
        out[r] = acc
    return torch.as_tensor(out), gathers


@pytest.mark.parametrize("name", ["repeated", "repeated_d17", "interleaved", "threshold",
                                  "unnamed", "wide"])
def test_backward_csr_holds_the_plain_order(name):
    """``slot_csr`` / ``long_rows`` on the CPU for the CUDA companion test's
    cases (``test_torch_cuda.py::bag_bwd_case``): row r lists the bags of
    the slots naming r in slot order, ids outside the table past row V;
    the runs of equal bag within a row, in entry order, spell ``bag`` out
    again; ``long_rows`` the rows past LONG_SLOTS, longest first (ties by
    row), then -1 to its fixed length; and the kernel's arithmetic over
    them, one gather a run, is the plain backward's bit for bit."""
    from test_torch_cuda import bag_bwd_case

    from repro_torch.kernels.embedding_bag.ops import LONG_SLOTS, long_rows, slot_csr
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_reference

    ids, g, V = bag_bwd_case(name)
    B, H = ids.shape
    row_ptr, bag, runs = slot_csr(ids, V)
    assert row_ptr.dtype == bag.dtype == torch.int32
    assert all(t.dtype == torch.int32 and t.shape == (B * H,) for t in runs)
    assert row_ptr.shape == (V + 1,) and bag.shape == (B * H,)
    flat = ids.reshape(-1).numpy()
    valid = (flat >= 0) & (flat < V)
    assert int(row_ptr[V]) == int(valid.sum())
    for r in np.unique(flat[valid]):
        slots = np.nonzero(flat == r)[0]
        assert np.array_equal(bag[row_ptr[r]:row_ptr[r + 1]].numpy(), slots // H)
    lengths = np.diff(row_ptr.numpy())
    assert int((lengths > 0).sum()) == len(np.unique(flat[valid]))
    lr = long_rows(row_ptr, B * H)
    cap = B * H // (LONG_SLOTS + 1)
    past = np.nonzero(lengths > LONG_SLOTS)[0]
    want = past[np.argsort(-lengths[past], kind="stable")]
    assert lr.dtype == torch.int32 and lr.shape == (cap,)
    assert np.array_equal(lr.numpy(), np.concatenate([want, -np.ones(cap - len(want))]))
    if name == "threshold":
        assert lr.numpy().tolist()[:1] == [4] and 3 not in lr.numpy()
    run_of, run_bag, run_len = (t.numpy() for t in runs)
    n_runs = int(run_of[-1]) + 1 if B * H else 0
    assert np.array_equal(np.repeat(run_bag[:n_runs], run_len[:n_runs]), bag.numpy())
    assert np.array_equal(np.repeat(np.arange(n_runs), run_len[:n_runs]), run_of)
    assert not run_len[n_runs:].any()
    got, gathers = _emulate_backward(g, row_ptr, bag, runs, lr)
    assert torch.equal(got, embedding_bag_backward_reference(g, ids, V))
    if name.startswith("repeated") or name == "wide":
        assert gathers == B                                # one gather a bag
