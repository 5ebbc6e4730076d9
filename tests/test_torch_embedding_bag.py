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
