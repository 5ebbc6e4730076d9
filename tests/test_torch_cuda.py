"""The port's CUDA kernels on the card (``cuda`` marker).

These tests import nothing of JAX, so they also run on a GPU machine
without it:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Without CUDA they skip."""
import numpy as np
import pytest
import torch

from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.generators import provgen_like
from repro_torch.graphs.partition import hash_partition
from repro_torch.kernels.vm_step.ops import vm_step

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernel")
    return torch.device("cuda")


def _trie_columns(workload, label_names):
    """The column form of a compiled workload trie's transition."""
    from repro_torch.kernels.vm_step.ref import transition_columns

    arrays = TPSTry.from_workload(workload).compile(label_names)
    return transition_columns(arrays.parent, arrays.label, arrays.cond_p,
                              arrays.n_labels)


def _vm_step_args(rng, par, val, n, e, hub=0):
    """Seeded dst-sorted CSR inputs (random alpha, 40% cut edges); ``hub``
    edges point at row 17."""
    L, N = par.shape
    dst = rng.integers(0, n, e)
    dst[:hub] = 17
    dst = np.sort(dst)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    w = rng.random(e).astype(np.float32)
    w[rng.random(e) < 0.4] = 0.0                          # cut edges
    return [torch.as_tensor(rng.random((n, N)), dtype=torch.float32),
            torch.as_tensor(par), torch.as_tensor(val),
            torch.as_tensor(row_ptr, dtype=torch.int32),
            torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32),
            torch.as_tensor(w),
            torch.as_tensor(rng.integers(0, L, n), dtype=torch.int32)]


def test_vm_step_kernel_matches_plain(card):
    par, val = _trie_columns(
        [(parse_rpq(q), f) for q, f in (("Entity.(Entity)*.Entity", 0.4),
                                        ("Entity.Activity.(Agent)*", 0.6))],
        ["Entity", "Activity", "Agent"])
    args = _vm_step_args(np.random.default_rng(1), par, val, 5000, 40000, hub=12000)
    before = vm_step.launches
    out = vm_step(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert vm_step.launches == before + 1
    torch.testing.assert_close(out.cpu(), vm_step(*args), rtol=1e-5, atol=1e-6)


def test_kernel_field_equals_plain_field_bitwise(card):
    g = provgen_like(3000, seed=5)
    w = [(parse_rpq("Entity.(Entity)*.Entity"), 0.6),
         (parse_rpq("Entity.Activity.(Agent)*"), 0.4)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part = hash_partition(g.n, 8, seed=1)
    before = vm_step.launches
    fc = extroversion_field(g, arrays, part, 8, device=card)
    assert vm_step.launches > before                      # default backend: the kernel
    fp = extroversion_field(g, arrays, part, 8, device="cpu")
    for name in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to"):
        assert np.array_equal(getattr(fc, name), getattr(fp, name)), name


@pytest.mark.parametrize("d,H", [(8, 1), (64, 8), (128, 64)])
def test_embedding_bag_kernel_matches_plain(card, d, H):
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

    rng = np.random.default_rng(d + H)
    V, B = 50_000, 3000
    table = torch.as_tensor(rng.normal(size=(V, d)).astype(np.float32), device=card)
    ids = rng.integers(0, V, (B, H))
    ids[::7, 0] = ids[::7, -1]                            # repeated ids
    ids[::5, -1] = -1                                     # pads
    ids[::11, 0] = V + 3                                  # past the table
    ids = torch.as_tensor(ids.astype(np.int32), device=card)
    for combiner in ("sum", "mean"):
        before = embedding_bag.launches
        out = embedding_bag(table, ids, combiner)
        torch.cuda.synchronize()
        assert embedding_bag.launches == before + 1
        torch.testing.assert_close(out, embedding_bag_reference(table, ids, combiner),
                                   rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("F", [8, 16, 100])
def test_segment_spmm_kernel_matches_plain(card, F):
    from repro_torch.kernels.segment_spmm.ops import (EdgeCSR, csr_from_edges,
                                                      segment_spmm_csr)
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

    rng = np.random.default_rng(F)
    n, e = 20_000, 200_000
    dst = rng.integers(0, n // 2, e)                      # rows n/2.. stay empty
    dst[:10_000] = 3                                      # hub row
    src = rng.integers(0, n, e)
    w = rng.normal(size=e).astype(np.float32)
    w[rng.random(e) < 0.2] = 0.0                          # masked edges
    t = lambda a, dt: torch.as_tensor(a, device=card).to(dt)  # noqa: E731
    x = t(rng.normal(size=(n, F)).astype(np.float32), torch.float32)
    csr = csr_from_edges(t(src, torch.int32), t(dst, torch.int32), n)
    wc = t(w, torch.float32)[csr.order].contiguous()
    before = segment_spmm_csr.launches
    out = segment_spmm_csr(x, csr, wc)
    torch.cuda.synchronize()
    assert segment_spmm_csr.launches == before + 1
    ref = segment_spmm_reference(x, t(src, torch.int64), t(dst, torch.int64),
                                 t(w, torch.float32), n)
    torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
    assert bool((out[n // 2:] == 0).all())
    # CSR order on both sides: the kernel sums as the CPU plain version does
    cpu_csr = EdgeCSR(csr.row_ptr.cpu(), csr.src.cpu(), csr.order.cpu())
    cpu = segment_spmm_csr(x.cpu(), cpu_csr, wc.cpu())
    assert torch.equal(out.cpu(), cpu)
    with pytest.raises(ValueError):                       # ids past x's rows
        segment_spmm_csr(x, EdgeCSR(csr.row_ptr, csr.src + n, csr.order), wc)


def test_vm_step_column_kernel_large_trie(card):
    """A 677-node trie (DLRM's row placement): 22 column blocks per row;
    the kernel matches the plain version."""
    from repro_torch.core.rpq import concat, label

    w = [(concat(label(f"F{i}"), label(f"F{j}")), 1.0 / 650)
         for i in range(26) for j in range(26) if i != j]
    par, val = _trie_columns(w, [f"F{f}" for f in range(26)])
    assert par.shape[1] > 64
    args = _vm_step_args(np.random.default_rng(3), par, val, 4000, 60_000)
    out = vm_step(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), vm_step(*args), rtol=1e-5, atol=1e-6)


def test_dlrm_and_gcn_forward_on_the_card(card):
    import dataclasses

    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.graphs import batch_to_device, random_graph_batch
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.models import dlrm
    from repro_torch.models.gnn import api, gcn

    cfg = dataclasses.replace(get_config("dlrm-rm2").reduced(), multi_hot=4)
    params = dlrm.init(cfg, seed=0, device="cpu")
    batch = next(ClickLogPipeline(cfg, 256, seed=1))
    want = dlrm.serve_step(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg)
    on_card = {k: [{n: t.to(card) for n, t in p.items()} for p in v]
               if isinstance(v, list) else v.to(card) for k, v in params.items()}
    got = dlrm.serve_step(on_card, {k: torch.as_tensor(v, device=card)
                                    for k, v in batch.items()}, cfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)

    gcfg = get_config("gcn-cora")
    shape = [s for s in GNN_SHAPES if s.name == "ogb_products"][0]
    gb = random_graph_batch(gcfg, shape, seed=0, scale=1e-2)
    gp = api.init(gcfg, shape, seed=0, device="cpu")
    want = gcn.forward(gp, batch_to_device(gb, "cpu"), gcfg)
    got = gcn.forward({"layers": [{n: t.to(card) for n, t in p.items()}
                                  for p in gp["layers"]]},
                      batch_to_device(gb, card), gcfg)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
