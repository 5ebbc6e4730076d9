"""The port's plain scatter-adds in a fixed order (``segment_spmm.ref``):
on the card ``index_add_`` adds with atomics in no fixed order, so there the
plain versions sum through a stable sort and sequential segment sums.  On
the CPU, where ``index_add_`` adds in edge order, the sorted path must give
its result bit for bit; these tests call the sorted helpers directly (or
put them in place of the module's ``scatter_add``) on CPU tensors."""
import numpy as np
import pytest
import torch

import repro_torch.kernels.segment_spmm.ref as spmm_ref
import repro_torch.kernels.vm_step.ref as vm_ref
import repro_torch.models.gnn.common as common
from repro_torch.kernels.segment_spmm.ref import (scatter_add, scatter_add_sorted,
                                                  segment_spmm_reference,
                                                  segment_spmm_sorted)


def _index_add(values, index, n):
    out = values.new_zeros((n,) + tuple(values.shape[1:]))
    return out.index_add_(0, index.long(), values)


def _edges(seed, n, e, sort, hub=0):
    """Seeded edges over n rows: random (or dst-sorted) destinations, a
    ``hub`` of edges into row 3, rows n/2.. without edges."""
    rng = np.random.default_rng(seed)
    dst = rng.integers(0, n // 2, e)
    dst[:hub] = 3
    rng.shuffle(dst)
    if sort:
        dst = np.sort(dst, kind="stable")
    return rng, torch.as_tensor(dst)


@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5)])
@pytest.mark.parametrize("sort", [False, True])
def test_scatter_add_sorted_is_index_add_bitwise(shape, sort):
    """Float32 terms of mixed sign and scale, a hub of 500 edges, unsorted
    and sorted indices, 1-D to 3-D values: the sorted segment sums are
    ``index_add_``'s sums bit for bit (the sum order matters: the terms do
    not add exactly)."""
    rng, dst = _edges(7 + len(shape), 200, 3000, sort, hub=500)
    vals = torch.as_tensor(rng.normal(size=(3000,) + shape)
                           * 10.0 ** rng.integers(-3, 4, (3000,) + shape),
                           dtype=torch.float32)
    want = _index_add(vals, dst, 200)
    got = scatter_add_sorted(vals, dst, 200)
    assert got.shape == want.shape and torch.equal(got, want)
    assert torch.equal(scatter_add(vals, dst, 200), want)
    # not an order-free sum: another order changes the bits
    perm = torch.as_tensor(rng.permutation(3000))
    assert not torch.equal(_index_add(vals[perm], dst[perm], 200), want)


def test_scatter_add_sorted_no_edges():
    got = scatter_add_sorted(torch.zeros((0, 4)), torch.zeros(0, dtype=torch.int64), 5)
    assert got.shape == (5, 4) and bool((got == 0).all())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("shape", [(), (6,)])
def test_scatter_sum_sorted_path_is_index_add_bitwise(monkeypatch, masked, shape):
    """``scatter_sum`` with the sorted helper in place of its ``scatter_add``
    (the card's path) against itself with ``index_add_`` on the CPU, with
    and without an edge mask (masked edges in the waste bin)."""
    rng, dst = _edges(11, 300, 4000, False, hub=700)
    vals = torch.as_tensor(rng.normal(size=(4000,) + shape), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(4000) < 0.8) if masked else None
    want = common.scatter_sum(vals, dst, 300, mask)
    monkeypatch.setattr(common, "scatter_add", scatter_add_sorted)
    got = common.scatter_sum(vals, dst, 300, mask)
    assert torch.equal(got, want)


def test_degrees_count_without_a_scatter():
    rng, dst = _edges(12, 100, 2000, False)
    mask = torch.as_tensor(rng.random(2000) < 0.7)
    want = _index_add(mask.float(), dst, 100)
    assert torch.equal(common.degrees(dst, 100, mask), want)
    assert torch.equal(common.degrees(dst, 100), _index_add(torch.ones(2000), dst, 100))


@pytest.mark.parametrize("sort", [False, True])
def test_vm_step_reference_sorted_path_is_index_add_bitwise(monkeypatch, sort):
    """``vm_step_reference`` with the sorted helper (the card's path) against
    its ``index_add_`` on the CPU, over a trie column form with 12 columns,
    cut edges and a hub row."""
    rng, dst = _edges(13, 400, 5000, sort, hub=900)
    L, N, n = 3, 12, 400
    args = (torch.as_tensor(rng.random((n, N)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, N, (L, N)), dtype=torch.int32),
            torch.as_tensor(rng.random((L, N)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, n, 5000)), dst,
            torch.as_tensor(np.where(rng.random(5000) < 0.4, 0.0, rng.random(5000)),
                            dtype=torch.float32),
            torch.as_tensor(rng.integers(0, L, 5000)), n)
    want = vm_ref.vm_step_reference(*args)
    monkeypatch.setattr(vm_ref, "scatter_add", scatter_add_sorted)
    assert torch.equal(vm_ref.vm_step_reference(*args), want)


@pytest.mark.parametrize("chunk", [1, 7, 1000, 1 << 22])
@pytest.mark.parametrize("sort", [False, True])
def test_segment_spmm_sorted_is_index_add_bitwise(monkeypatch, chunk, sort):
    """``segment_spmm_sorted`` against the CPU plain version (``index_add_``
    chunk by chunk).  With CHUNK at 1, 7 or 1000 edges the 600-edge hub row
    and many others are split across chunks: each row's running value is
    carried into the next chunk and the sums stay bitwise."""
    monkeypatch.setattr(spmm_ref, "CHUNK", chunk)
    rng, dst = _edges(17, 250, 3000, sort, hub=600)
    src = torch.as_tensor(rng.integers(0, 250, 3000), dtype=torch.int32)
    w = torch.as_tensor(rng.normal(size=3000), dtype=torch.float32)
    w[torch.as_tensor(rng.random(3000) < 0.2)] = 0.0
    x = torch.as_tensor(rng.normal(size=(250, 9)), dtype=torch.float32)
    want = segment_spmm_reference(x, src, dst.to(torch.int32), w, 250)
    got = segment_spmm_sorted(x, src, dst.to(torch.int32), w, 250)
    assert torch.equal(got, want)
    assert bool((got[125:] == 0).all())
    if chunk == 7:                                   # the hub row spans chunks
        order = torch.argsort(dst, stable=True)
        hub = (dst[order] == 3).nonzero()[:, 0]
        assert int(hub[0]) // chunk != int(hub[-1]) // chunk
