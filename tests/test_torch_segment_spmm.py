"""The port's ``segment_spmm`` against the JAX reference: the reference's
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs it),
its ``use_pallas=False`` fallback and its jnp oracle, on the same
numpy-seeded inputs.  On the CPU the wrapper takes the plain torch version;
the CUDA kernel itself is checked on the card (tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.kernels.segment_spmm.ops import pack_edges as r_pack_edges
from repro.kernels.segment_spmm.ops import pack_weights as r_pack_weights
from repro.kernels.segment_spmm.ops import segment_spmm as r_segment_spmm
from repro.kernels.segment_spmm.ref import segment_spmm_reference as r_reference

from repro_torch.kernels.segment_spmm.ops import (EdgeCSR, csr_from_edges,
                                                  csr_from_packing, pack_edges,
                                                  pack_weights, packed_dst,
                                                  segment_spmm,
                                                  segment_spmm_csr)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

# the JAX sweep's ranges (tests/test_kernels.py): n 5-400, e 1-1500,
# F in {8, 32, 64}, block_n in {32, 128}, block_e in {64, 256}
_rng = np.random.default_rng(20261019)
SWEEP = [(int(_rng.integers(5, 401)), int(_rng.integers(1, 1501)), f,
          int(_rng.choice([32, 128])), int(_rng.choice([64, 256])),
          int(_rng.integers(0, 2**16)))
         for f in (8, 32, 64) for _ in range(3)]


def _inputs(n, e, f, seed):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    w = rng.normal(size=e).astype(np.float32)
    x = rng.normal(size=(n, f)).astype(np.float32)
    return src, dst, w, x


@pytest.mark.parametrize("n,e,f,block_n,block_e,seed", SWEEP)
def test_segment_spmm_sweep_matches_reference(n, e, f, block_n, block_e, seed):
    src, dst, w, x = _inputs(n, e, f, seed)
    packed = pack_edges(src, dst, n, block_n, block_e)
    out = segment_spmm(torch.from_numpy(x), packed,
                       torch.from_numpy(pack_weights(packed, w)), n).numpy()
    r_packed = r_pack_edges(src, dst, n, block_n, block_e)
    pallas = np.asarray(r_segment_spmm(jnp.asarray(x), r_packed,
                                       r_pack_weights(r_packed, w), n))
    oracle = np.asarray(r_reference(jnp.asarray(x), jnp.asarray(src),
                                    jnp.asarray(dst), jnp.asarray(w), n))
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-4)


def test_segment_spmm_matches_reference_fallback():
    src, dst, w, x = _inputs(100, 400, 16, 1)
    packed = pack_edges(src, dst, 100, 32, 64)
    out = segment_spmm(torch.from_numpy(x), packed,
                       torch.from_numpy(pack_weights(packed, w)), 100).numpy()
    r_packed = r_pack_edges(src, dst, 100, 32, 64)
    fallback = np.asarray(r_segment_spmm(jnp.asarray(x), r_packed,
                                         r_pack_weights(r_packed, w), 100,
                                         use_pallas=False))
    np.testing.assert_allclose(out, fallback, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("n,e,seed", [(5, 1, 0), (64, 0, 1), (400, 1500, 2),
                                      (1000, 20000, 3)])
def test_csr_is_the_stable_destination_order(n, e, seed):
    """The CSR derived from the packing, and the one built on the device,
    are bitwise the stable destination sort of the edge list."""
    src, dst, _, _ = _inputs(n, e, 4, seed)
    order = np.argsort(dst, kind="stable")
    row_ptr = np.concatenate([[0], np.cumsum(np.bincount(dst, minlength=n))])
    packed = pack_edges(src, dst, n, 32, 64)
    from_packing = csr_from_packing(packed, packed_dst(packed), n)
    on_device = csr_from_edges(torch.from_numpy(src), torch.from_numpy(dst), n)
    for csr in (from_packing, on_device):
        got = [np.asarray(a) for a in (csr.row_ptr, csr.src, csr.order)]
        assert got[0].dtype == np.int32 and got[1].dtype == np.int32
        assert np.array_equal(got[0], row_ptr)
        assert np.array_equal(got[1], src[order])
        assert np.array_equal(got[2], order)


def test_segment_spmm_csr_empty_rows_and_zero_weights():
    x = torch.arange(12, dtype=torch.float32).reshape(4, 3)
    row_ptr = torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32)
    src = torch.tensor([1, 3, 0], dtype=torch.int32)
    w = torch.tensor([2.0, 0.0, 0.5])
    before = segment_spmm_csr.launches
    out = segment_spmm_csr(x, EdgeCSR(row_ptr, src, torch.arange(3)), w)
    want = torch.zeros(4, 3)
    want[0] = 2.0 * x[1]
    want[2] = 0.5 * x[0]
    assert torch.equal(out, want)
    assert segment_spmm_csr.launches == before
    dst = torch.tensor([0, 0, 2])
    assert torch.equal(segment_spmm_reference(x, src, dst, w, 4), want)


@pytest.mark.parametrize("i,value", [
    (0, torch.rand(4, 3, dtype=torch.float64)),            # x dtype
    (1, torch.tensor([0, 2, 2, 3, 3], dtype=torch.int64)),  # row_ptr dtype
    (2, torch.tensor([1, 3], dtype=torch.int32)),           # src length
    (3, torch.rand(6)[::2]),                                # non-contiguous
    (2, torch.tensor([1, 4, 0], dtype=torch.int32)),        # id past x's rows
    (2, torch.tensor([1, -1, 0], dtype=torch.int32)),       # negative id
    (1, torch.tensor([0, 2, 2, 3, 2], dtype=torch.int32)),  # ends before len(src)
])
def test_segment_spmm_csr_rejects_bad_arguments(i, value):
    """Bad offsets or ids are refused when the CSR is made, the rest at the
    call."""
    args = [torch.rand(4, 3), torch.tensor([0, 2, 2, 3, 3], dtype=torch.int32),
            torch.tensor([1, 3, 0], dtype=torch.int32), torch.rand(3)]
    args[i] = value
    with pytest.raises(ValueError):
        segment_spmm_csr(args[0], EdgeCSR(args[1], args[2], torch.arange(3)),
                         args[3])


def test_edge_csr_records_its_source_bound():
    """Every builder's CSR is checked once and carries one past its largest
    source id, on the host and on the device alike."""
    src = np.array([4, 0, 2, 9], np.int32)
    dst = np.array([1, 0, 1, 3], np.int32)
    on_device = csr_from_edges(torch.from_numpy(src), torch.from_numpy(dst), 10)
    from_packing = csr_from_packing(pack_edges(src, dst, 10, 4, 4),
                                    packed_dst(pack_edges(src, dst, 10, 4, 4)), 10)
    assert on_device.src_bound == from_packing.src_bound == 10
    empty = csr_from_edges(torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.int32), 3)
    assert empty.src_bound == 0 and empty.row_ptr.tolist() == [0, 0, 0, 0]
    with pytest.raises(ValueError, match="row_ptr"):
        EdgeCSR(np.array([0, 3], np.int32), src, np.arange(4))


def test_segment_spmm_rejects_edges_past_n_out():
    src, dst, w, x = _inputs(50, 200, 8, 5)
    packed = pack_edges(src, dst, 50, 32, 64)
    with pytest.raises(ValueError, match="n_out"):
        segment_spmm(torch.from_numpy(x), packed,
                     torch.from_numpy(pack_weights(packed, w)), int(dst.max()))
