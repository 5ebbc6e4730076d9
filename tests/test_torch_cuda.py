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
from repro_torch.kernels.segment_spmm.ops import EdgeCSR
from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.obs import default_registry

pytestmark = pytest.mark.cuda

#: the kernel's launches in this process (counted at each launch)
_LAUNCHES = default_registry().counter("vm_step_launches_total")


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
    """Seeded dst-sorted CSR inputs (random alpha, 40% cut edges) on the
    CPU, each with a ``.to(device)``; ``hub`` edges point at row 17."""
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
            EdgeCSR(torch.as_tensor(row_ptr, dtype=torch.int32),
                    torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32),
                    torch.arange(e)),
            torch.as_tensor(w),
            torch.as_tensor(rng.integers(0, L, n), dtype=torch.int32)]


def test_vm_step_kernel_matches_plain(card):
    par, val = _trie_columns(
        [(parse_rpq(q), f) for q, f in (("Entity.(Entity)*.Entity", 0.4),
                                        ("Entity.Activity.(Agent)*", 0.6))],
        ["Entity", "Activity", "Agent"])
    args = _vm_step_args(np.random.default_rng(1), par, val, 5000, 40000, hub=12000)
    before = _LAUNCHES.value
    out = vm_step(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert _LAUNCHES.value == before + 1
    torch.testing.assert_close(out.cpu(), vm_step(*args), rtol=1e-5, atol=1e-6)


def test_kernel_field_equals_plain_field_bitwise(card):
    g = provgen_like(3000, seed=5)
    w = [(parse_rpq("Entity.(Entity)*.Entity"), 0.6),
         (parse_rpq("Entity.Activity.(Agent)*"), 0.4)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part = hash_partition(g.n, 8, seed=1)
    before = _LAUNCHES.value
    fc = extroversion_field(g, arrays, part, 8, device=card)
    assert _LAUNCHES.value > before                      # default backend: the kernel
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


def _message_sum_case(rng, F):
    """A message sum's CSR, as the equivariant models launch it: sources
    are edge ids (each x row read once), and rows hold one edge, ~2 edges
    (1-3), none, or 300; 10% of the edges masked (weight 0)."""
    deg = np.concatenate([np.ones(1500, np.int64), rng.integers(1, 4, 1500), [0, 300],
                          rng.integers(1, 4, 40)])
    row_ptr = np.zeros(deg.shape[0] + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    E = int(row_ptr[-1])
    src = rng.permutation(E)
    w = np.ones(E, np.float32)
    w[rng.random(E) < 0.1] = 0.0
    x = rng.normal(size=(E, F)).astype(np.float32)
    return row_ptr, src, w, x


@pytest.mark.parametrize("F", [8, 16, 100, 130, 288, 6272])
def test_segment_spmm_kernel_matches_plain(card, F):
    """The narrow route (F <= 128 in float4 loads) on a random graph with a
    hub row; the wide route (F = 130 in scalar loads, 288 and Equiformer-v2's
    6,272 in float4) on a message sum's rows of one, ~2, no and 300 edges:
    within the raw edge list's sums, and bitwise the plain version over the
    same CSR."""
    from repro_torch.kernels.segment_spmm.ops import (csr_from_edges, segment_spmm_csr,
                                                      vector_width)
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference

    rng = np.random.default_rng(F)
    t = lambda a, dt: torch.as_tensor(a, device=card).to(dt)  # noqa: E731
    if F <= 128:
        n, e = 20_000, 200_000
        dst = rng.integers(0, n // 2, e)                  # rows n/2.. stay empty
        dst[:10_000] = 3                                  # hub row
        src = rng.integers(0, n, e)
        w = rng.normal(size=e).astype(np.float32)
        w[rng.random(e) < 0.2] = 0.0                      # masked edges
        x = t(rng.normal(size=(n, F)).astype(np.float32), torch.float32)
        csr = csr_from_edges(t(src, torch.int32), t(dst, torch.int32), n)
        empty = torch.arange(n // 2, n, device=card)
    else:
        row_ptr, src, w, xh = _message_sum_case(rng, F)
        n = row_ptr.shape[0] - 1
        dst = np.repeat(np.arange(n), np.diff(row_ptr))
        x = t(xh, torch.float32)
        csr = EdgeCSR(t(row_ptr, torch.int32), t(src, torch.int32),
                      torch.arange(src.shape[0], device=card))
        empty = torch.nonzero(t(np.diff(row_ptr) == 0, torch.bool)).squeeze(1)
        assert (F // vector_width(x)) > 32                # the wide route
    wc = t(w, torch.float32)[csr.order].contiguous()
    before = segment_spmm_csr.launches
    out = segment_spmm_csr(x, csr, wc)
    torch.cuda.synchronize()
    assert segment_spmm_csr.launches == before + 1
    # the plain version over the raw edge list, on the CPU: on the card its
    # index_add_ adds in no fixed order (atomics), and on the 10,000-edge hub
    # row two of its own runs differ by up to 4.7e-4
    ref = segment_spmm_reference(x.cpu(), torch.as_tensor(src), torch.as_tensor(dst),
                                 torch.as_tensor(w), n)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
    assert bool((out[empty] == 0).all())
    # CSR order on both sides: the kernel sums as the CPU plain version does
    cpu_csr = EdgeCSR(csr.row_ptr.cpu(), csr.src.cpu(), csr.order.cpu())
    cpu = segment_spmm_csr(x.cpu(), cpu_csr, wc.cpu())
    assert torch.equal(out.cpu(), cpu)
    with pytest.raises(ValueError):                       # ids past x's rows
        segment_spmm_csr(x, EdgeCSR(csr.row_ptr, csr.src + x.shape[0], csr.order), wc)


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


# (b, sq, skv, kv, g, d, causal, window): ragged lengths, one-row and one-key
# sequences, causal rows past the last key, GQA 1/2/4, every head size, and
# (the last case) rows from 116 on that see no key
ATTN_CASES = [
    (1, 1, 1, 1, 1, 32, True, None),
    (2, 1, 300, 2, 4, 64, False, None),
    (1, 300, 1, 1, 2, 128, False, 17),
    (1, 300, 100, 2, 2, 64, True, None),
    (2, 129, 129, 2, 4, 128, True, 1024),
    (1, 257, 257, 1, 4, 256, True, 64),
    (1, 1024, 1024, 2, 4, 128, True, None),
    (1, 150, 100, 2, 2, 32, False, 17),
]


# bf16 only (the tensor-core kernel): every head size with Sq != Skv,
# windows, and lengths that are not multiples of 64 or 128
ATTN_CASES_BF16 = [
    (1, 333, 517, 2, 2, 128, True, 200),
    (3, 77, 190, 1, 2, 32, False, 64),
    (1, 700, 650, 1, 1, 64, True, 129),
    (2, 1000, 1111, 2, 4, 256, False, 300),
    (1, 190, 70, 1, 4, 64, True, None),
    (2, 65, 1025, 2, 2, 32, True, 17),
    (1, 1100, 1100, 2, 4, 128, False, 1),
    (1, 257, 900, 1, 2, 256, True, None),
]


def _attn_inputs(seed, b, sq, skv, kv, g, d, dtype, device):
    rng = np.random.default_rng(seed)
    return (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
            .to(device=device, dtype=dtype)
            for shape in ((b, sq, kv * g, d), (b, skv, kv, d), (b, skv, kv, d)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain(card, dtype):
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=2e-5, atol=2e-5)
    if dtype == torch.bfloat16:
        for i, (b, sq, skv, kv, g, d, causal, window) in enumerate(ATTN_CASES_BF16):
            q, k, v = _attn_inputs(100 + i, b, sq, skv, kv, g, d, dtype, card)
            out = flash_attention(q, k, v, causal=causal, window=window)
            torch.cuda.synchronize()
            ref = flash_attention_reference(q, k, v, causal, window)
            torch.testing.assert_close(out.float(), ref.float(), **tol)
    for i, (b, sq, skv, kv, g, d, causal, window) in enumerate(ATTN_CASES):
        rng = np.random.default_rng(i)
        q, k, v = (torch.as_tensor(rng.normal(size=shape), dtype=torch.float32)
                   .to(device=card, dtype=dtype)
                   for shape in ((b, sq, kv * g, d), (b, skv, kv, d), (b, skv, kv, d)))
        before = flash_attention.launches
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash_attention.launches == before + 1
        ref = flash_attention_reference(q, k, v, causal, window)
        torch.testing.assert_close(out.float(), ref.float(), **tol)
    assert bool((out[:, 116:] == 0).all()) and bool((out[:, :116] != 0).any())


def test_flash_attention_bf16_holds_the_path_gate(card):
    """1 x 4,096 tokens, 32 query and 8 KV heads of 128 (qwen3-4b's), v rows
    sharing a common part (output RMS ~0.5): the kernel within one bf16 step
    plus 1e-3 of the output's RMS of the plain version (chip_smoke.py's
    path gate)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    rng = np.random.default_rng(7)
    q = torch.as_tensor(rng.normal(size=(1, 4096, 32, 128)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 4096, 8, 128)), dtype=torch.float32)
    v = torch.as_tensor(0.5 * rng.normal(size=(1, 1, 8, 128))
                        + 0.3 * rng.normal(size=(1, 4096, 8, 128)), dtype=torch.float32)
    q, k, v = (t.to(device=card, dtype=torch.bfloat16) for t in (q, k, v))
    out = flash_attention(q, k, v).float()
    ref = flash_attention_reference(q, k, v).float()
    rms = float(ref.square().mean().sqrt())
    assert 0.3 < rms < 0.7
    torch.testing.assert_close(out, ref, rtol=2.0 ** -7, atol=1e-3 * rms)


def test_transformer_forward_and_decode_on_the_card(card):
    """Reduced qwen3-4b and gemma3-4b (d_head 32), float32: the forward
    through the kernel and three decode steps on the card against the CPU
    (plain version)."""
    import dataclasses

    import repro_torch.models.transformer as tf
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels.flash_attention.ops import flash_attention

    for arch in ("qwen3-4b", "gemma3-4b"):
        cfg = dataclasses.replace(get_config(arch).reduced_for_port(), global_every=2)
        params = tf.init(cfg, seed=0, device="cpu")
        to_card = lambda t: ({k: to_card(v) for k, v in t.items()}  # noqa: E731
                             if isinstance(t, dict) else t.to(card))
        on_card = to_card(params)
        tokens = torch.as_tensor(np.random.default_rng(1).integers(0, cfg.vocab, (2, 70)))
        before = flash_attention.launches
        got, _, cache = tf.forward(on_card, tokens.to(card), cfg, return_cache=True)
        assert flash_attention.launches == before + cfg.n_layers
        want, _, want_cache = tf.forward(params, tokens, cfg, return_cache=True)
        torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
        for c, cc in ((cache, card), (want_cache, "cpu")):
            full = tf.init_cache(cfg, 2, 73, device=cc)
            full["k"][:, :, :70], full["v"][:, :, :70], full["pos"] = c["k"], c["v"], 70
            c.update(full)
        nxt = want[:, -1:].argmax(-1)
        for _ in range(3):
            got, cache = tf.decode_step(on_card, cache, nxt.to(card), cfg)
            want, want_cache = tf.decode_step(params, want_cache, nxt, cfg)
            torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5)
            nxt = want.argmax(-1)


#: rows of these edge counts sit among short random rows in the bitwise
#: cases: empty, single, around one 32-edge batch, past the long-row
#: threshold (256) and a hub
ROW_LENGTHS = [0, 1, 31, 32, 33, 255, 256, 257, 300, 10_000]


def _csr_of_lengths(rng, n):
    """A CSR of n rows with ROW_LENGTHS at random places, other rows 0-11
    edges; sources uniform over the n rows."""
    deg = rng.integers(0, 12, n)
    deg[rng.random(n) < 0.15] = 0
    deg[rng.choice(n, len(ROW_LENGTHS), replace=False)] = ROW_LENGTHS
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(deg, out=row_ptr[1:])
    src = rng.integers(0, n, int(row_ptr[-1]))
    return (torch.as_tensor(row_ptr, dtype=torch.int32),
            torch.as_tensor(src, dtype=torch.int32), deg)


@pytest.mark.parametrize("F", [1, 3, 4, 16, 17, 100, 128, 130])
@pytest.mark.parametrize("offset", [0, 1])
def test_segment_spmm_kernel_bitwise_vs_cpu(card, F, offset):
    """Every lane layout (float4 and scalar loads, 1 to 32 lanes a row, one
    and several passes over a row's columns), on x at a 16-byte boundary
    and one float past it: the kernel's sums are the CPU plain version's,
    bit for bit."""
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_csr, vector_width

    rng = np.random.default_rng(1000 + F)
    n = 3000
    row_ptr, src, deg = _csr_of_lengths(rng, n)
    E = src.shape[0]
    w = torch.as_tensor(rng.normal(size=E), dtype=torch.float32)
    w[torch.as_tensor(rng.random(E) < 0.2)] = 0.0          # masked edges
    xs = torch.as_tensor(rng.normal(size=(n, F)), dtype=torch.float32)
    buf = torch.zeros(n * F + 4, device=card)
    x = buf[offset:offset + n * F].view(n, F)
    x.copy_(xs)
    assert vector_width(x) == (4 if F % 4 == 0 and offset == 0 else 1)
    csr = EdgeCSR(row_ptr.to(card), src.to(card), torch.arange(E, device=card))
    before = segment_spmm_csr.launches
    out = segment_spmm_csr(x, csr, w.to(card))
    torch.cuda.synchronize()
    assert segment_spmm_csr.launches == before + 1
    cpu = segment_spmm_csr(xs, EdgeCSR(row_ptr, src, torch.arange(E)), w)
    assert torch.equal(out.cpu(), cpu)
    assert bool((out.cpu()[torch.as_tensor(deg == 0)] == 0).all())


@pytest.mark.parametrize("workload", ["provgen", "placement"])
def test_vm_step_long_rows_bitwise_vs_cpu(card, workload):
    """Rows on both sides of the long-row threshold and a 10,000-edge hub,
    under the provgen trie (N = 23, its columns in shared memory) and the
    row placement's (N = 677, 22 column blocks): the kernel's sums, split by
    the CSR's row plan, are the CPU plain version's, bit for bit, launch
    after launch."""
    from repro_torch.core.rpq import concat, label
    from repro_torch.kernels.segment_spmm.ops import LONG_ROW_EDGES

    if workload == "provgen":
        queries = ["Entity.(Entity)*.Entity",
                   "Agent.Activity.Entity.Entity.Activity.Agent",
                   "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
        par, val = _trie_columns([(parse_rpq(q), f) for q, f in
                                  zip(queries, (0.4, 0.2, 0.2, 0.2))],
                                 ["Entity", "Activity", "Agent"])
    else:
        par, val = _trie_columns([(concat(label(f"F{i}"), label(f"F{j}")), 1.0 / 650)
                                  for i in range(26) for j in range(26) if i != j],
                                 [f"F{f}" for f in range(26)])
    assert par.shape[1] == {"provgen": 23, "placement": 677}[workload]
    rng = np.random.default_rng(7)
    n = 4000
    row_ptr, src, deg = _csr_of_lengths(rng, n)
    assert (deg > LONG_ROW_EDGES).sum() == 3
    E = src.shape[0]
    w = torch.as_tensor(rng.random(E), dtype=torch.float32)
    w[torch.as_tensor(rng.random(E) < 0.4)] = 0.0          # cut edges
    args = [torch.as_tensor(rng.random((n, par.shape[1])), dtype=torch.float32),
            torch.as_tensor(par), torch.as_tensor(val),
            EdgeCSR(row_ptr, src, torch.arange(E)), w,
            torch.as_tensor(rng.integers(0, par.shape[0], n), dtype=torch.int32)]
    assert args[3].plan.long_rows.shape[0] == 3
    want = vm_step(*args)
    on_card = [a.to(card) for a in args]
    before = _LAUNCHES.value
    for _ in range(3):
        got = vm_step(*on_card)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert _LAUNCHES.value == before + 3


def test_vm_step_reads_alpha_the_kernel_before_it_wrote(card):
    """Without long rows the short-row kernel is an ordinary launch: each
    step reads the alpha that the kernel just before it on the stream wrote
    (no synchronisation between them), bit for bit as the CPU does."""
    par, val = _trie_columns(
        [(parse_rpq(q), f) for q, f in (("Entity.(Entity)*.Entity", 0.4),
                                        ("Entity.Activity.(Agent)*", 0.6))],
        ["Entity", "Activity", "Agent"])
    args = _vm_step_args(np.random.default_rng(11), par, val, 200_000, 1_100_000)
    assert args[3].plan.long_rows.shape[0] == 0
    base, scales = args[0], [float(2 ** k) for k in range(-4, 4)]
    on_card = [a.to(card) for a in args]
    alpha = torch.empty_like(on_card[0])
    got = []
    for s in scales:
        torch.mul(on_card[0], s, out=alpha)               # writes alpha just before
        got.append(vm_step(alpha, *on_card[1:]))
    torch.cuda.synchronize()
    for s, out in zip(scales, got):
        assert torch.equal(out.cpu(), vm_step(base * s, *args[1:]))


# --- the plain versions repeat on the card ----------------------------------
#
# On the card ``index_add_`` adds with atomics in no fixed order; the port's
# plain scatter-adds sum through a stable sort and sequential segment sums
# there, so two runs agree bit for bit, and with the CPU's ``index_add_``.

def _plain_inputs(which, rng):
    """(function, CPU arguments) of one plain version: unsorted or sorted
    destinations over 3,000 rows (half of them empty), a 10,000-edge hub
    row, 40,000 edges."""
    import repro_torch.models.gnn.common as common
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_reference
    from repro_torch.kernels.vm_step.ref import vm_step_reference

    n, e = 3000, 40_000
    dst = rng.integers(0, n // 2, e)
    dst[:10_000] = 5
    rng.shuffle(dst)
    if which.endswith("sorted"):
        dst = np.sort(dst, kind="stable")
    dst = torch.as_tensor(dst)
    src = torch.as_tensor(rng.integers(0, n, e))
    if which.startswith("scatter_sum"):
        vals = torch.as_tensor(rng.normal(size=(e, 7)), dtype=torch.float32)
        mask = torch.as_tensor(rng.random(e) < 0.7) if "masked" in which else None
        return common.scatter_sum_plain, (vals, dst, n, mask)
    if which.startswith("vm_step"):
        L, N = 3, 23
        return vm_step_reference, (
            torch.as_tensor(rng.random((n, N)), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, N, (L, N)), dtype=torch.int32),
            torch.as_tensor(rng.random((L, N)), dtype=torch.float32), src, dst,
            torch.as_tensor(rng.random(e), dtype=torch.float32),
            torch.as_tensor(rng.integers(0, L, e)), n)
    w = torch.as_tensor(rng.normal(size=e), dtype=torch.float32)
    w[torch.as_tensor(rng.random(e) < 0.2)] = 0.0
    x = torch.as_tensor(rng.normal(size=(n, 100)), dtype=torch.float32)
    return segment_spmm_reference, (x, src.int(), dst.int(), w, n)


@pytest.mark.parametrize("which", ["scatter_sum", "scatter_sum_masked", "vm_step",
                                   "vm_step_sorted", "segment_spmm", "segment_spmm_sorted",
                                   "segment_spmm_chunks"])
def test_plain_versions_repeat_and_equal_the_cpu(card, monkeypatch, which):
    """Each plain scatter-add twice on the card: the two results are equal
    bit for bit, and equal to the CPU's.  ``segment_spmm_chunks`` takes the
    edges 4,999 at a time, so the hub row and many others run across chunk
    boundaries."""
    import repro_torch.kernels.segment_spmm.ref as spmm_ref

    if which == "segment_spmm_chunks":
        monkeypatch.setattr(spmm_ref, "CHUNK", 4999)
    fn, args = _plain_inputs(which, np.random.default_rng(len(which)))
    want = fn(*args)
    on_card = [a.to(card) if isinstance(a, torch.Tensor) else a for a in args]
    first, second = fn(*on_card), fn(*on_card)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first.cpu(), want)


# --- embedding_bag bit for bit against the CPU ------------------------------

@pytest.mark.parametrize("H", [1, 3, 8, 9, 64])
@pytest.mark.parametrize("d", [8, 17, 64, 128, 256])
def test_embedding_bag_kernel_bitwise_vs_cpu(card, d, H):
    """Every lane layout (float4, float2 and scalar rows; 2 to 32 lanes a
    bag, one or two passes over a row), ids in one 16-byte load or one a
    slot, slot tails (H 1, 3, 9), an odd number of bags, the table one and
    two floats past a 16-byte boundary and the output one float past it;
    repeated, -1 and past-the-table ids: the kernel's sums and means are the
    CPU plain version's, bit for bit."""
    from repro_torch.kernels.embedding_bag.kernel import embedding_bag_cuda
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference

    rng = np.random.default_rng(10 * d + H)
    V, B = 20_000, 1001
    table = torch.as_tensor(rng.normal(size=(V, d)), dtype=torch.float32)
    ids = rng.integers(0, V, (B, H))
    ids[::3] = ids[::3, :1]                               # one row in every slot
    ids[::5, -1] = -1                                     # pads
    ids[::7, 0] = V + 11                                  # past the table
    ids = torch.as_tensor(ids.astype(np.int32))
    ids_card = ids.to(card)
    for t_off in (0, 1, 2):
        buf = torch.zeros(V * d + 4, device=card)
        tab = buf[t_off:t_off + V * d].view(V, d)
        tab.copy_(table)
        for combiner in ("sum", "mean"):
            want = embedding_bag_reference(table, ids, combiner)
            before = embedding_bag.launches
            got = embedding_bag(tab, ids_card, combiner)
            assert embedding_bag.launches == before + 1
            obuf = torch.full((B * d + 4,), float("nan"), device=card)
            shifted = embedding_bag_cuda(tab, ids_card, combiner == "mean",
                                         out=obuf[1:1 + B * d].view(B, d))
            torch.cuda.synchronize()
            assert torch.equal(got.cpu(), want), (t_off, combiner)
            assert torch.equal(shifted.cpu(), want), (t_off, combiner)


# --- flash_attention_f32 (3xTF32) on lengths off its tiles ------------------

def test_flash_attention_f32_kernel_off_its_tiles(card):
    """The bf16 cases' shapes (lengths off every tile, Sq != Skv, windows,
    every head size) and qwen3-4b's heads at 1 x 4,096 with v rows sharing a
    common part, in float32: the kernel within 2e-5 of the plain version."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    for i, (b, sq, skv, kv, g, d, causal, window) in enumerate(ATTN_CASES_BF16):
        q, k, v = _attn_inputs(200 + i, b, sq, skv, kv, g, d, torch.float32, card)
        out = flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        ref = flash_attention_reference(q, k, v, causal, window)
        torch.testing.assert_close(out, ref, rtol=2e-5, atol=2e-5)
    rng = np.random.default_rng(8)
    q = torch.as_tensor(rng.normal(size=(1, 4096, 32, 128)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(1, 4096, 8, 128)), dtype=torch.float32)
    v = torch.as_tensor(0.5 * rng.normal(size=(1, 1, 8, 128))
                        + 0.3 * rng.normal(size=(1, 4096, 8, 128)), dtype=torch.float32)
    q, k, v = (t.to(card) for t in (q, k, v))
    torch.testing.assert_close(flash_attention(q, k, v), flash_attention_reference(q, k, v),
                               rtol=2e-5, atol=2e-5)


# --- vm_step on a graph that mutates between invocations ---------------------

def _mutated_provgen():
    """provgen_like(3000) after three mixed mutation batches and a batch
    that gives vertex 17 a long row, with its CSR cached before each."""
    from repro_torch.graphs.graph import MutationBatch
    from repro_torch.workload.stream import GraphMutationStream

    g = provgen_like(3000, seed=5)
    ms = GraphMutationStream("mixed", seed=7, vertices_per_tick=20, edges_per_tick=200)
    for _ in range(3):
        g.vm_csr()
        g.apply_mutations(ms.next_batch(g))
    g.vm_csr()
    g.apply_mutations(MutationBatch(add_edges=[(17, v) for v in range(100, 700)]))
    return g


def test_vm_step_on_a_patched_csr_bitwise_vs_cpu(card):
    """The CSR that apply_mutations leaves behind (re-derived from the
    patched packing, with its row plan, a long row included) equals a fresh
    graph's, and the kernel over it is the CPU plain version bit for bit."""
    from repro_torch.graphs.graph import LabelledGraph

    g = _mutated_provgen()
    csr = g.vm_csr()
    fresh = LabelledGraph(n=g.n, labels=g.labels, label_names=g.label_names,
                          src=g.src, dst=g.dst).vm_csr()
    for a, b in ((csr.row_ptr, fresh.row_ptr), (csr.src, fresh.src),
                 (csr.order, fresh.order), (csr.plan.runs, fresh.plan.runs),
                 (csr.plan.long_rows, fresh.plan.long_rows)):
        assert np.array_equal(a, b)
    assert csr.plan.long_rows.shape[0] >= 1
    par, val = _trie_columns(
        [(parse_rpq(q), f) for q, f in (("Entity.(Entity)*.Entity", 0.4),
                                        ("Entity.Activity.(Agent)*", 0.6))],
        g.label_names)
    rng = np.random.default_rng(3)
    E = csr.src.shape[0]
    w = rng.random(E).astype(np.float32)
    w[rng.random(E) < 0.4] = 0.0
    args = [torch.as_tensor(rng.random((g.n, par.shape[1])), dtype=torch.float32),
            torch.as_tensor(par), torch.as_tensor(val), csr.to("cpu"),
            torch.as_tensor(w), torch.as_tensor(g.labels, dtype=torch.int32)]
    want = vm_step(*args)
    before = _LAUNCHES.value
    got = vm_step(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert _LAUNCHES.value == before + 1
    assert torch.equal(got.cpu(), want)


def test_device_inputs_reupload_once_per_version(card):
    """A Taper's device buffers are uploaded once per graph version: reused
    within a version, replaced (and the old ones freed) after a mutation,
    and the kernel field on the mutated graph equals the CPU plain field
    bit for bit."""
    import gc
    import weakref

    from repro_torch.core.taper import Taper
    from repro_torch.graphs.graph import MutationBatch

    g = provgen_like(3000, seed=5)
    w = [(parse_rpq("Entity.(Entity)*.Entity"), 0.6),
         (parse_rpq("Entity.Activity.(Agent)*"), 0.4)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part = hash_partition(g.n, 8, seed=1)
    taper = Taper(g, 8, device=card)
    taper.field(part, arrays)
    dev0 = taper._pre["_dev"]
    taper.field(part[::-1].copy(), arrays)
    assert taper._pre["_dev"] is dev0 and taper._pre["_dev_key"] == (0, card)
    old_src = weakref.ref(dev0["src"])
    del dev0
    g.apply_mutations(MutationBatch(add_vertex_labels=[0, 1],
                                    add_edges=[(3000, 5), (3001, 3000), (7, 9)],
                                    remove_edges=[(int(g.src[0]), int(g.dst[0]))]))
    part = np.concatenate([part, [0, 1]]).astype(np.int32)
    f = taper.field(part, arrays)
    gc.collect()
    assert old_src() is None
    dev1 = taper._pre["_dev"]
    assert taper._pre["_dev_key"] == (1, card)
    taper.field(part[::-1].copy(), arrays)
    assert taper._pre["_dev"] is dev1
    fp = extroversion_field(g, arrays, part, 8, backend="torch", device="cpu")
    for name in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion", "ext_to"):
        assert np.array_equal(getattr(f, name), getattr(fp, name)), name


def test_vm_step_kernel_reads_a_halo_extended_input(card):
    """One shard of a sharded packing: alpha holds the shard's rows and then
    its exchanged rows (n_in > n_out); the kernel equals the plain version
    on the CPU bit for bit."""
    from repro_torch.graphs.partition import metis_like_partition
    from repro_torch.graphs.sharded_packing import partition_shard_order
    from repro_torch.kernels.segment_spmm.ops import csr_from_shard

    g = provgen_like(6000, seed=3)
    par, val = _trie_columns(
        [(parse_rpq(q), f) for q, f in (("Entity.(Entity)*.Entity", 0.4),
                                        ("Entity.Activity.(Agent)*", 0.6))],
        g.label_names)
    order = partition_shard_order(metis_like_partition(g, 3, seed=0), 3)
    sp = g.vm_packing_sharded(3, order=order, order_token="partition:0")
    rng = np.random.default_rng(2)
    for s in range(3):
        for exchange in ("sliced", "psum"):
            csr = csr_from_shard(sp, s, exchange)
            n_in = int(csr.src_bound) + 5
            args = [torch.as_tensor(rng.random((n_in, par.shape[1])), dtype=torch.float32),
                    torch.as_tensor(par), torch.as_tensor(val), csr.to("cpu"),
                    torch.as_tensor(sp.inv_cnt[s][csr.order]
                                    * (rng.random(csr.order.shape[0]) < 0.6)).float(),
                    torch.as_tensor(np.maximum(sp.vlabels[s], 0).astype(np.int32))]
            assert n_in > sp.n_local_pad
            want = vm_step(*args)
            before = _LAUNCHES.value
            got = vm_step(*(a.to(card) for a in args))
            torch.cuda.synchronize()
            assert _LAUNCHES.value == before + 1
            assert got.shape == (sp.n_local_pad, par.shape[1])
            assert torch.equal(got.cpu(), want)


def test_cuda_sharded_one_rank_equals_cuda(card):
    """``cuda_sharded`` on a one-rank NCCL group, and on a one-rank gloo
    group (CUDA tensors staged through pinned host buffers), equals the
    ``cuda`` field bit for bit under both exchanges and every shard map."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_smoke_group

    g = provgen_like(3000, seed=5)
    w = [(parse_rpq("Entity.(Entity)*.Entity"), 0.6),
         (parse_rpq("Entity.Activity.(Agent)*"), 0.4)]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    part = hash_partition(g.n, 8, seed=1)
    fc = extroversion_field(g, arrays, part, 8, backend="cuda", device=card)
    groups = {"default": make_smoke_group(card), "gloo": dist.new_group([0], backend="gloo")}
    for name, group in groups.items():
        for source in ("stripe", "partition", "bfs"):
            for exchange in ("sliced", "psum"):
                pre = {"_group": group}
                before = _LAUNCHES.value
                fs = extroversion_field(g, arrays, part, 8, _precomputed=pre,
                                        backend="cuda_sharded", device=card,
                                        shard_map_source=source,
                                        halo_exchange=exchange)
                assert _LAUNCHES.value - before == arrays.max_depth - 1
                assert ("pinned" in pre["_shard_exchange"]["transport"]) == (
                    str(dist.get_backend(group)) == "gloo")
                for f in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion",
                          "ext_to"):
                    assert np.array_equal(getattr(fs, f), getattr(fc, f)), (name, f)


# ---------------------------------------------------------------------------
# the serving loop on the card
# ---------------------------------------------------------------------------


def _serve_policy(**kw):
    from repro_torch.core.online import OnlinePolicy

    base = dict(bootstrap_after_ticks=0, cadence=1, min_interval=0, dirty_fraction=2.0,
                drift_l1=9e9, ipt_regression=9e9)
    base.update(kw)
    return OnlinePolicy(**base)


def test_backend_fallback_and_probe_recovery_on_the_card(card):
    """The twin of tests/test_faults.py's ladder test: four injected
    invocation faults walk cuda -> torch (the torch rung's field on the
    card), one healthy commit probes back to cuda, and the next commit
    launches the kernel."""
    import repro_torch.core.visitor as visitor
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.serve import ServeLoopConfig, ServingLoop
    from repro_torch.serve.faults import SITE_INVOCATION, FaultInjector, InjectedFault

    mq1 = parse_rpq("Area.Artist.(Artist|Label).Area")
    fi = FaultInjector()
    loop = ServingLoop(
        musicbrainz_like(300, seed=21), 4,
        taper_config=TaperConfig(max_iterations=2, field_backend="cuda"),
        policy=_serve_policy(),
        config=ServeLoopConfig(micro_batch=4, overlap_invocations=False, faults=fi,
                               invocation_retry_backoff_s=0.0, backend_fallback_after=2,
                               backend_probe_after=1),
        device=card)
    seen, field = [], visitor._field

    def traced(*args, **kwargs):
        out = field(*args, **kwargs)
        seen.append((args[7], out[0].device.type))
        return out

    def pump_until(cond):
        for _ in range(200):
            if cond():
                return
            loop.submit(mq1)
            try:
                loop.pump()
            except InjectedFault:
                pass
        raise AssertionError("the loop did not get there in 200 rounds")

    visitor._field = traced
    try:
        fi.arm(SITE_INVOCATION, times=4)
        pump_until(lambda: fi.fired_total() >= 4)
        s = loop.stats()
        assert s["field_backend"] == "torch" and s["backend_fallbacks"] == 1
        assert s["degraded"] == 1 and s["healthy"] == 0
        assert loop.metrics.invocation_failures == 4
        n = len(seen)
        pump_until(lambda: loop.stats()["backend_recoveries"] >= 1)
        assert seen[n:] and all(s == ("torch", "cuda") for s in seen[n:])
        s = loop.stats()
        assert s["field_backend"] == "cuda" and s["degraded"] == 0 and s["healthy"] == 1
        before, inv = _LAUNCHES.value, loop.ot.invocations
        pump_until(lambda: loop.ot.invocations > inv)
        assert _LAUNCHES.value > before
    finally:
        visitor._field = field
    loop.stop()


def test_shard_upload_fault_survivable_then_degrades_on_the_card(card):
    """The twin of tests/test_faults.py's shard-upload test: one failed
    upload is survivable, a second walks cuda_sharded -> cuda."""
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.graphs.graph import MutationBatch
    from repro_torch.serve import ServeLoopConfig, ServingLoop
    from repro_torch.serve.faults import SITE_SHARD_UPLOAD, FaultInjector

    mq1 = parse_rpq("Area.Artist.(Artist|Label).Area")
    g = musicbrainz_like(300, seed=26)
    fi = FaultInjector()
    loop = ServingLoop(
        g, 4, taper_config=TaperConfig(max_iterations=2, field_backend="cuda_sharded"),
        policy=_serve_policy(bootstrap_after_ticks=None, cadence=10 ** 9),
        config=ServeLoopConfig(micro_batch=4, overlap_invocations=False, faults=fi,
                               invocation_retry_backoff_s=0.0, backend_fallback_after=2),
        device=card)
    fi.arm(SITE_SHARD_UPLOAD, times=1)
    v0, n0 = g.version, g.n
    assert loop.submit_mutations(MutationBatch(add_vertex_labels=[0],
                                               add_edges=[(1, n0)])) is True
    loop.pump()
    s = loop.stats()
    assert g.version == v0 + 1 and s["upload_failures"] == 1 and s["degraded"] == 0
    loop.submit(mq1)
    assert loop.pump() == 1
    fi.arm(SITE_SHARD_UPLOAD, times=1)
    assert loop.submit_mutations(MutationBatch(add_vertex_labels=[0],
                                               add_edges=[(2, n0 + 1)])) is True
    loop.pump()
    s = loop.stats()
    assert s["upload_failures"] == 2 and s["backend_fallbacks"] == 1
    assert s["field_backend"] == "cuda" and s["degraded"] == 1
    loop.submit(mq1)
    assert loop.pump() == 1
    loop.stop()


def test_overlapped_serving_on_the_card_equals_the_cpu(card):
    """Overlapped invocations launched from the loop's invocation thread
    run the kernel, and the partitions they commit equal those of the same
    inline stream on the CPU's torch field."""
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.graphs.graph import MutationBatch
    from repro_torch.serve import ServeLoopConfig, ServingLoop

    mq1, mq3 = (parse_rpq(q) for q in ("Area.Artist.(Artist|Label).Area",
                                       "Artist.Credit.Track.Medium"))
    parts = {}
    for name, device, backend in (("card", card, "cuda"), ("cpu", "cpu", "torch")):
        g = musicbrainz_like(700, seed=5)
        loop = ServingLoop(
            g, 4, taper_config=TaperConfig(max_iterations=2, field_backend=backend),
            policy=_serve_policy(cadence=10 ** 9, dirty_fraction=1e-9),
            config=ServeLoopConfig(micro_batch=8, overlap_invocations=True), device=device)
        before = _LAUNCHES.value
        out = []
        for step in range(3):
            for i in range(8):
                loop.submit(mq1 if i % 3 else mq3)
            loop.pump()
            assert loop.invocation_in_flight
            assert loop._invocation_done.wait(120)
            loop.pump()                       # commits, then applies ingest
            out.append(loop.part.copy())
            loop.submit_mutations(MutationBatch(add_vertex_labels=[step % 3],
                                                add_edges=[(g.n, step), (7, 11 + step)]))
            loop.pump()
        stats = loop.stop()
        assert stats["invocation_error"] == "" and stats["backend_fallbacks"] == 0
        assert stats["field_backend"] == backend
        parts[name] = (out, _LAUNCHES.value - before)
    assert parts["card"][1] > 0 and parts["cpu"][1] == 0
    assert all(np.array_equal(a, b) for a, b in zip(parts["card"][0], parts["cpu"][0]))


#: the crash-storm scenario's digest (the JAX package's, and the CPU's)
CRASH_STORM_DIGEST = "4758df45327b1c4f1551edd36bf76eb4ff4d0ea131e77f421f1aa90c1f14a717"


def test_chaos_scenario_on_the_card_equals_the_cpu(card, tmp_path):
    """The crash-storm scenario with its cluster on the card: green, its
    invocations launch ``vm_step`` on the ``cuda`` rung, and its digest is
    the CPU run's (and the reference's)."""
    from repro_torch.serve.chaos import run_scenario

    digests = {}
    for name, device in (("card", card), ("cpu", "cpu")):
        before = _LAUNCHES.value
        r = run_scenario(tmp_path / name, "crash_storm", device=device)
        assert r.ok, (r.invariant_errors, r.staleness_violations)
        assert r.stats["backend_fallbacks"] == 0
        digests[name] = (r.digest, _LAUNCHES.value - before)
    assert digests["card"][1] > 0 and digests["cpu"][1] == 0
    assert digests["card"][0] == digests["cpu"][0] == CRASH_STORM_DIGEST


def test_failover_drill_on_the_card_equals_the_cpu(card, tmp_path):
    """A cluster on the card keeps every node there; after a primary crash
    the promoted follower runs its next invocation on the ``cuda`` rung,
    and the promoted state, routed reads and rejoined node equal the same
    drill on the CPU."""
    import time

    from repro_torch.core.online import OnlinePolicy
    from repro_torch.core.taper import TaperConfig
    from repro_torch.graphs.generators import musicbrainz_like
    from repro_torch.graphs.graph import MutationBatch
    from repro_torch.serve import (ClusterConfig, ClusterCoordinator, ServeLoopConfig,
                                   ServingLoop)

    mq1, mq3 = (parse_rpq(q) for q in ("Area.Artist.(Artist|Label).Area",
                                       "Artist.Credit.Track.Medium"))

    def policy():
        return OnlinePolicy(bootstrap_after_ticks=0, cadence=6, min_interval=0,
                            dirty_fraction=0.02, drift_l1=9e9, ipt_regression=9e9)

    def drive(coord, rounds, seed):
        rng = np.random.default_rng(seed)
        n = coord.primary.g.n
        for i in range(rounds):
            coord.serve([mq1 if i % 3 else mq3], cls="hot")
            if rng.random() < 0.5:
                coord.submit_mutations(MutationBatch(
                    add_vertex_labels=[int(rng.integers(0, 4))],
                    add_edges=[(int(rng.integers(0, n)), n)]))
                n += 1
            coord.pump()

    def state(ot):
        return [ot.g.labels, ot.g.src, ot.g.dst, ot.g.row_ptr, ot.part, ot._dirty,
                ot.g.version, ot.invocations, ot.taper._rng.bit_generator.state]

    out = {}
    for name, device in (("card", card), ("cpu", "cpu")):
        primary = ServingLoop(
            musicbrainz_like(400, seed=7), 4, taper_config=TaperConfig(max_iterations=2),
            policy=policy(), config=ServeLoopConfig(
                micro_batch=8, overlap_invocations=False, snapshot_dir=str(tmp_path / name)),
            device=device)
        coord = ClusterCoordinator(primary, ClusterConfig(n_followers=2,
                                                          heartbeat_timeout_s=0.05),
                                   policy(), TaperConfig(max_iterations=2))
        try:
            kind = torch.device(device).type
            assert {f.ot.taper.device.type for f in coord.followers.values()} == {kind}
            drive(coord, 18, seed=3)
            old_slot = coord.primary_slot
            coord.crash_primary()
            time.sleep(0.06)
            coord.pump()
            assert coord.failovers == 1 and coord.primary._epoch == 2
            assert coord.primary.ot.taper.device.type == kind
            promoted = state(coord.primary.ot)
            routed = coord.serve([mq1, mq3], cls="hot")
            before = _LAUNCHES.value
            inv0 = coord.primary.ot.invocations
            drive(coord, 12, seed=4)
            assert coord.primary.ot.invocations > inv0
            launches = _LAUNCHES.value - before
            f = coord.rejoin_demoted(slot=old_slot, reuse_state=False)
            assert f.ot.taper.device.type == kind
            f.catch_up()
            st = coord.stats()
            assert st["backend_fallbacks"] == 0
            out[name] = (promoted, routed, state(f.ot), state(coord.primary.ot), launches,
                         st["field_backend"])
        finally:
            coord.stop()
    card_out, cpu_out = out["card"], out["cpu"]
    assert card_out[4] > 0 and cpu_out[4] == 0
    assert (card_out[5], cpu_out[5]) == ("cuda", "torch")
    for a, b in zip(card_out[:4], cpu_out[:4]):
        for x, y in zip(a, b):
            assert np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y


def _moe_case(E=16, K=4, T=300, d=64, seed=11, dtype=torch.float32):
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models import moe

    cfg = MoEConfig(n_experts=E, top_k=K, d_expert_ff=32, n_shared=1)
    params = moe.init(d, cfg, dtype=dtype, seed=seed, device="cpu")
    x = torch.as_tensor(np.random.default_rng(seed).normal(size=(T, d)),
                        dtype=torch.float32).to(dtype)
    return cfg, params, x


def _to(tree, device):
    return ({k: _to(v, device) for k, v in tree.items()} if isinstance(tree, dict)
            else tree.to(device))


def test_moe_apply_on_the_card_equals_the_cpu(card):
    """Routing equal to the CPU's, the output within the reference suite's
    2e-5 (float32), and the dispatch and combine repeating bit for bit over
    three runs on the card."""
    from repro_torch.device import resolve_device
    from repro_torch.models import moe

    resolve_device(card)                           # TF32 off
    cfg, params, x = _moe_case()
    on_card = _to(params, card)
    for capacity in (None, 7):
        want, want_aux = moe.apply(params, x, cfg, capacity)
        r_cpu = moe.route(params, x, cfg)
        r_card = moe.route(on_card, x.to(card), cfg)
        assert torch.equal(r_card.experts.cpu(), r_cpu.experts)
        runs = [moe.apply(on_card, x.to(card), cfg, capacity) for _ in range(3)]
        torch.cuda.synchronize()
        got, aux = runs[0]
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5, atol=2e-5)
        assert float(aux["moe_dropped_frac"]) == float(want_aux["moe_dropped_frac"])
        assert all(torch.equal(o, got) for o, _ in runs[1:])
        assert torch.equal(moe.kept(r_card.experts, cfg, capacity).cpu(),
                           moe.kept(r_cpu.experts, cfg, capacity))


def test_moe_bf16_repeats_on_the_card(card):
    """bf16, olmoe's top-8 of 64 experts over 4,096 tokens: three runs bit
    for bit equal (no atomics in dispatch or combine)."""
    from repro_torch.models import moe

    cfg, params, x = _moe_case(E=64, K=8, T=4096, d=256, dtype=torch.bfloat16)
    on_card, xc = _to(params, card), x.to(card)
    runs = [moe.apply(on_card, xc, cfg)[0] for _ in range(3)]
    assert all(torch.equal(o, runs[0]) for o in runs[1:])
    assert torch.isfinite(runs[0]).all()


def test_moe_top_k_ties_on_the_card(card):
    """Exact ties go to the lower expert id on the card, as on the CPU."""
    from repro_torch.models import moe

    cfg, params, x = _moe_case(E=8, K=3)
    w = params["router"]["w"]
    w[:, 5] = w[:, 2]
    w[:, 7] = w[:, 1]
    x[:4] = 0.0                                    # all eight experts tie
    got = moe.route(_to(params, card), x.to(card), cfg).experts.cpu()
    assert torch.equal(got, moe.route(params, x, cfg).experts)
    assert (got[:4] == torch.tensor([0, 1, 2])).all()


def test_olmoe_reduced_forward_through_the_kernel(card):
    """Reduced olmoe-1b-7b (H = KV, QK-norm, MoE FFN) in float32: the forward
    through the kernel against the forward through the plain attention on
    the card and against the CPU, one launch per layer, and a decode step."""
    import repro_torch.models.transformer as tf
    from repro_torch.configs.registry import get_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    resolve_device(card)
    cfg = get_config("olmoe-1b-7b").reduced_for_port()
    params = tf.init(cfg, seed=0, device="cpu")
    on_card = _to(params, card)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, cfg.vocab, (2, 70)))
    before = flash_attention.launches
    got, aux, cache = tf.forward(on_card, tokens.to(card), cfg, return_cache=True)
    assert flash_attention.launches == before + cfg.n_layers
    tf.flash_attention = lambda q, k, v, causal=True, window=None: (  # noqa: E731
        flash_attention_reference(q, k, v, causal, window))
    try:
        plain, plain_aux = tf.forward(on_card, tokens.to(card), cfg)
    finally:
        tf.flash_attention = flash_attention
    want, want_aux = tf.forward(params, tokens, cfg)
    for other, other_aux in ((plain.cpu(), plain_aux), (want, want_aux)):
        torch.testing.assert_close(got.cpu(), other, rtol=1e-4, atol=1e-5)
        assert float(aux["moe_dropped_frac"]) == float(other_aux["moe_dropped_frac"])
    full = tf.init_cache(cfg, 2, 71, device=card)
    full["k"][:, :, :70], full["v"][:, :, :70], full["pos"] = cache["k"], cache["v"], 70
    nxt = want[:, -1:].argmax(-1)
    step, _ = tf.decode_step(on_card, full, nxt.to(card), cfg)
    cpu_cache = tf.init_cache(cfg, 2, 71, device="cpu")
    _, _, pre = tf.forward(params, tokens, cfg, return_cache=True)
    cpu_cache["k"][:, :, :70], cpu_cache["v"][:, :, :70], cpu_cache["pos"] = (
        pre["k"], pre["v"], 70)
    want_step, _ = tf.decode_step(params, cpu_cache, nxt, cfg)
    torch.testing.assert_close(step.cpu(), want_step, rtol=1e-4, atol=1e-5)


def test_expert_placement_on_the_card_equals_the_cpu(card):
    """``plan_expert_placement(device="cuda")`` launches ``vm_step`` and
    gives the ``torch`` field's placement, moves and iterations."""
    from repro_torch.core.expert_placement import plan_expert_placement

    ids = np.random.default_rng(3).integers(0, 32, (512, 6, 4))
    before = _LAUNCHES.value
    on_card = plan_expert_placement(ids, 32, 4, device=card)
    assert _LAUNCHES.value > before
    on_cpu = plan_expert_placement(ids, 32, 4, device="cpu")
    assert np.array_equal(on_card["placement"], on_cpu["placement"])
    for k in ("cross_mass_before", "cross_mass_after", "moves", "iterations"):
        assert on_card[k] == on_cpu[k], k


# --- the training slice: backward kernels -----------------------------------

#: (b, sq, skv, kv, g, d, causal, window): every mask the forward takes, GQA,
#: Sq != Skv both ways, every head size, rows that see no key (window 17
#: past Skv; window 0 masks every row)
ATTN_BWD_CASES = [
    (1, 1, 1, 1, 1, 32, True, None),
    (2, 77, 77, 2, 2, 32, True, None),
    (1, 130, 70, 2, 4, 64, True, None),
    (1, 70, 130, 1, 2, 64, False, 17),
    (1, 150, 100, 2, 2, 32, False, 17),
    (1, 200, 200, 2, 4, 128, True, 64),
    (2, 129, 257, 1, 1, 128, False, None),
    (1, 100, 100, 1, 2, 256, True, 33),
    (1, 97, 97, 2, 2, 256, False, None),
    (1, 64, 64, 1, 1, 64, True, 0),
]
#: the backward kernel against the plain backward on the same inputs, as a
#: share of the largest plain gradient: float32 sums in other orders; bf16
#: outputs rounded once each (one bf16 step of the largest value)
ATTN_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_backward_kernel_matches_plain(card, dtype):
    """Through autograd: the output has a grad_fn, the forward kernel
    writes the row log-sum-exp (against the plain version's), the backward
    kernel launches once and gives the plain backward's dq, dk and dv on
    the same q, k, v, o, lse and output gradient; rows with no valid key
    get exactly zero dq."""
    from repro_torch.kernels.flash_attention.ops import (flash_attention,
                                                         flash_attention_backward)
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference, flash_attention_reference)

    for i, (b, sq, skv, kv, g, d, causal, window) in enumerate(ATTN_BWD_CASES):
        q, k, v = (t.requires_grad_() for t in
                   _attn_inputs(300 + i, b, sq, skv, kv, g, d, dtype, card))
        do = next(_attn_inputs(400 + i, b, sq, sq, kv * g, 1, d, dtype, card))
        fwd, bwd = flash_attention.launches, flash_attention_backward.launches
        out = flash_attention(q, k, v, causal=causal, window=window)
        assert out.grad_fn is not None
        lse_k = out.grad_fn.saved_tensors[4]
        out.backward(do)
        torch.cuda.synchronize()
        assert flash_attention.launches == fwd + 1
        assert flash_attention_backward.launches == bwd + 1
        _, lse = flash_attention_reference(q.detach(), k.detach(), v.detach(), causal,
                                           window, return_lse=True)
        live = torch.isfinite(lse)
        assert torch.equal(live, torch.isfinite(lse_k)), i
        torch.testing.assert_close(lse_k[live], lse[live], rtol=1e-5, atol=1e-5)
        args = (q.detach(), k.detach(), v.detach(), out.detach(), lse_k, do)
        want = flash_attention_backward_reference(*args, causal, window)
        got = flash_attention_backward(*args, causal, window)
        for name, x, y, auto in zip("qkv", got, want, (q.grad, k.grad, v.grad)):
            assert torch.equal(x, auto), (i, name)      # autograd ran the kernel
            scale = float(y.float().abs().max())
            err = float((x.float() - y.float()).abs().max())
            assert err <= ATTN_BWD_TOL[dtype] * scale + 1e-6, (i, name, err, scale)
        dead = ~live[0, 0].cpu()
        assert bool((q.grad[:, dead.to(card)] == 0).all()), i


#: the bf16 backward's tiles (128 keys a dv / dk block, q tiles of 128 and
#: 64 rows, 128 q rows a dq block over 64-key stages) cut off the edge:
#: Sq and Skv off the tiles and Sq != Skv both ways, windows across a tile
#: edge, G = 1 / 2 / 4 / 8 at D = 64 and 128, rows that see no key
#: (window 17 ends past Skv = 100; window 2 leaves the diagonal and one),
#: and G = 8 at D = 64 with a non-causal window and Sq < Skv; run in
#: float32 too (the mma.sync route's tiles: 64-row blocks, steps of 32 or
#: 16 rows)
ATTN_BWD_TILE_CASES = [
    (1, 300, 200, 2, 1, 128, True, None),
    (1, 200, 300, 1, 2, 64, True, None),
    (2, 257, 385, 2, 4, 128, False, 100),
    (1, 385, 257, 1, 8, 64, True, 130),
    (1, 300, 100, 2, 2, 128, False, 17),
    (1, 129, 129, 4, 8, 128, True, 2),
    (1, 513, 640, 1, 4, 64, True, 256),
    (1, 250, 390, 2, 8, 64, False, 100),
]
#: the mma.sync route's tiles (float32 at every head size, bf16 at 256)
#: cut off the edge: Sq and Skv off the 64-row blocks and the 16- or
#: 32-row steps both ways, windows across a step's edge, G = 1 / 2 / 4 /
#: 8, rows that see no key (window 17 past Skv = 100, window 0, a window
#: of 2 beside Sq > Skv: rows past Skv see none)
ATTN_BWD_MMA_CASES = [
    (1, 300, 200, 2, 1, 32, True, None, torch.float32),
    (2, 97, 161, 2, 4, 32, False, 40, torch.float32),
    (1, 200, 300, 1, 2, 64, True, None, torch.float32),
    (1, 150, 100, 1, 8, 64, False, 17, torch.float32),
    (1, 129, 129, 4, 8, 128, True, 2, torch.float32),
    (1, 79, 47, 2, 2, 128, True, 2, torch.float32),
    (2, 257, 385, 2, 4, 256, True, 130, torch.float32),
    (1, 150, 100, 1, 8, 256, False, 17, torch.float32),
    (1, 300, 200, 2, 1, 256, True, None, torch.bfloat16),
    (1, 200, 300, 1, 2, 256, False, 100, torch.bfloat16),
    (2, 257, 385, 2, 4, 256, True, 130, torch.bfloat16),
    (1, 150, 100, 1, 8, 256, False, 17, torch.bfloat16),
    (1, 64, 64, 1, 1, 256, True, 0, torch.bfloat16),
]


def _backward_off_the_edge(card, b, sq, skv, kv, g, d, causal, window, dtype):
    """The backward kernel against the plain backward on the same q, k, v,
    o, lse and output gradient, within ATTN_BWD_TOL; rows with no valid key
    get exactly zero dq; a second launch on the same inputs gives the same
    bits."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    from repro_torch.kernels.flash_attention.ref import (
        flash_attention_backward_reference, flash_attention_reference)

    q, k, v = _attn_inputs(500 + sq, b, sq, skv, kv, g, d, dtype, card)
    do = next(_attn_inputs(600 + sq, b, sq, sq, kv * g, 1, d, dtype, card))
    o, lse = flash_attention_reference(q, k, v, causal, window, return_lse=True)
    args = (q, k, v, o, lse, do, causal, window)
    got = flash_attention_backward(*args)
    again = flash_attention_backward(*args)
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(*args)
    for name, x, y, z in zip("qkv", got, want, again):
        assert torch.equal(x, z), name
        scale = float(y.float().abs().max())
        err = float((x.float() - y.float()).abs().max())
        assert err <= ATTN_BWD_TOL[dtype] * scale + 1e-6, (name, err, scale)
    dead = ~torch.isfinite(lse[0, 0])
    assert bool((got[0][:, dead] == 0).all())
    if window in (17, 0):
        assert bool(dead.any())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("case", ATTN_BWD_TILE_CASES)
def test_flash_attention_backward_tiles_off_the_edge(card, case, dtype):
    """The backward (bf16: wgmma + TMA at D <= 128; float32: 3xTF32
    mma.sync) on the bf16 route's edge cases: within ATTN_BWD_TOL of the
    plain backward, zero dq on rows with no key, bitwise on a second
    launch."""
    _backward_off_the_edge(card, *case, dtype)


@pytest.mark.parametrize("case", ATTN_BWD_MMA_CASES)
def test_flash_attention_backward_mma_tiles_off_the_edge(card, case):
    """The mma.sync route (float32 at D 32-256, bf16 at 256) on its own
    tiles' edge cases, as above."""
    _backward_off_the_edge(card, *case)


@pytest.mark.parametrize("d", [64, 17, 300])
def test_embedding_bag_backward_kernel_bitwise_vs_cpu(card, d):
    """The table's gradient through the backward kernel
    (``csrc/embedding_bag_bwd.cu`` over the id-sorted slots): the CPU plain
    backward's, bit for bit, for sum and mean, with repeated, -1 and
    past-the-table ids, unnamed rows, and hot rows past LONG_SLOTS on the
    long-row kernel (float4 and scalar rows, a row wider than a long-row
    block)."""
    from repro_torch.kernels.embedding_bag.ops import (LONG_SLOTS, embedding_bag,
                                                       embedding_bag_backward)

    rng = np.random.default_rng(21 + d)
    V, B, H = 5000, 6001, 8
    ids = rng.integers(0, V // 2, (B, H))
    ids[::3] = ids[::3, :1]
    ids[:, 1] = 7                                          # a hot row: B slots
    ids[::2, 2] = 11                                       # and a second one
    ids[::5, -1] = -1
    ids[::7, 0] = V + 3
    assert B > LONG_SLOTS
    ids = torch.as_tensor(ids.astype(np.int32))
    g = torch.as_tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    for combiner in ("sum", "mean"):
        want = embedding_bag_backward(g, ids, V, combiner)
        table = torch.zeros((V, d), device=card, requires_grad=True)
        before = embedding_bag_backward.launches
        out = embedding_bag(table, ids.to(card), combiner)
        assert out.grad_fn is not None
        out.backward(g.to(card))
        torch.cuda.synchronize()
        assert embedding_bag_backward.launches == before + 1
        assert torch.equal(table.grad.cpu(), want), combiner
        assert bool((want[V // 2:] == 0).all())


#: the bag backward's companion cases (:func:`bag_bwd_case`), also held on
#: the CPU to the plain backward's order (``test_torch_embedding_bag.py``)
BAG_BWD_CASES = ("repeated", "repeated_d17", "interleaved", "threshold", "unnamed", "wide")


def bag_bwd_case(name):
    """``(ids (B, H) int32, g (B, d) float32, V)`` on the CPU, seeded:
    * ``repeated``: ClickLogPipeline's shape, each bag's one id in all H = 8
      slots (a row's entries in runs of 8), half the bags' ids zipf-like
      over the first 400 rows so two rows pass LONG_SLOTS, and most rows
      unnamed; ``repeated_d17`` the same at d = 17 (scalar lanes);
    * ``interleaved``: a long row (id 5) whose runs of 4 interleave with
      single slots and with other rows' slots;
    * ``threshold``: rows of exactly LONG_SLOTS slots (id 3) and one past
      it (id 4), one under it (id 6), at random slots (some bags hold the
      same id twice: runs of 2);
    * ``unnamed``: only -1 and past-the-table ids: no row is named;
    * ``wide``: ``repeated`` at d = 300, wider than a long-row task."""
    from repro_torch.kernels.embedding_bag.ops import LONG_SLOTS

    rng = np.random.default_rng(BAG_BWD_CASES.index(name) + 40)
    d = {"repeated_d17": 17, "wide": 300}.get(name, 64)
    if name in ("repeated", "repeated_d17", "wide"):
        V, B, H = 4000, 8000, 8
        row = np.where(np.arange(B) % 2 == 0, (400 * rng.random(B) ** 3).astype(np.int64),
                       rng.integers(0, V, B))
        ids = np.repeat(row[:, None], H, axis=1)
    elif name == "interleaved":
        V, B, H = 3000, 2400, 4
        ids = rng.integers(0, V, (B, H))
        ids[0::3] = 5                                      # runs of 4
        ids[1::3, 0] = 5                                   # single slots
    elif name == "threshold":
        V, B, H = 2000, 2000, 2
        flat = rng.integers(10, V, B * H)
        at = rng.permutation(B * H)                        # bags with both slots
        n = (LONG_SLOTS, LONG_SLOTS + 1, LONG_SLOTS - 1)   # on one id make runs of 2
        flat[at[:n[0]]] = 3
        flat[at[n[0]:n[0] + n[1]]] = 4
        flat[at[n[0] + n[1]:sum(n)]] = 6
        ids = flat.reshape(B, H)
    else:
        V, B, H = 1000, 500, 3
        ids = np.where(rng.random((B, H)) < 0.5, -1, V + rng.integers(0, 9, (B, H)))
    g = torch.as_tensor(rng.normal(size=(B, d)), dtype=torch.float32)
    return torch.as_tensor(ids.astype(np.int32)), g, V


@pytest.mark.parametrize("name", BAG_BWD_CASES)
def test_embedding_bag_backward_kernel_cases_bitwise_vs_cpu(card, name):
    """The backward kernel on each of :func:`bag_bwd_case`'s cases: the CPU
    plain backward's bits, for sum and mean, one launch each."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag_backward
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_reference

    ids, g, V = bag_bwd_case(name)
    for combiner in ("sum", "mean"):
        want = embedding_bag_backward_reference(g, ids, V, combiner)
        before = embedding_bag_backward.launches
        got = embedding_bag_backward(g.to(card), ids.to(card), V, combiner)
        torch.cuda.synchronize()
        assert embedding_bag_backward.launches == before + 1
        assert torch.equal(got.cpu(), want), (name, combiner)


@pytest.mark.parametrize("F", [16, 100, 17])
def test_segment_spmm_backward_kernel_bitwise_vs_cpu(card, F):
    """x's gradient through the kernel over the transposed CSR (cached on
    the EdgeCSR): the CPU plain backward's, bit for bit; a weight that
    requires grad raises."""
    from repro_torch.kernels.segment_spmm.ops import (csr_from_edges, segment_spmm_csr,
                                                      segment_spmm_csr_backward)

    rng = np.random.default_rng(F)
    n, e = 3000, 40000
    src = torch.as_tensor(rng.integers(0, n, e))
    src[:5000] = 11                                        # a hub source
    dst = torch.as_tensor(rng.integers(0, n, e))
    w = torch.as_tensor(rng.random(e), dtype=torch.float32)
    w[::9] = 0.0
    csr = csr_from_edges(src, dst, n)
    g = torch.as_tensor(rng.normal(size=(n, F)), dtype=torch.float32)
    want = segment_spmm_csr_backward(g, csr, w[csr.order].contiguous(), n)
    csr_c = csr_from_edges(src.to(card), dst.to(card), n)
    wc = w.to(card)[csr_c.order].contiguous()
    x = torch.zeros((n, F), device=card, requires_grad=True)
    before = segment_spmm_csr_backward.launches
    out = segment_spmm_csr(x, csr_c, wc)
    assert out.grad_fn is not None
    out.backward(g.to(card))
    torch.cuda.synchronize()
    assert segment_spmm_csr_backward.launches == before + 1
    assert torch.equal(x.grad.cpu(), want)
    with pytest.raises(ValueError):
        segment_spmm_csr(x, csr_c, wc.clone().requires_grad_())


@pytest.mark.parametrize("F", [7, 64, 6272])
def test_scatter_sum_kernel_bitwise_vs_plain(card, F):
    """``scatter_sum`` on the card is one ``segment_spmm`` launch over the
    edge-id CSR, bitwise the plain scatter's on the card and on the CPU;
    masked edges hold NaN and reach no sum; the gradient of the values is
    one backward launch, bitwise the plain backward's."""
    import repro_torch.models.gnn.common as common
    from repro_torch.kernels.segment_spmm.ops import segment_spmm_csr, segment_spmm_csr_backward

    rng = np.random.default_rng(F)
    n, e = 500, 6000 if F > 1000 else 40000
    idx = rng.integers(0, n - 50, e)                       # the last 50 rows stay empty
    idx[:e // 8] = 3                                       # a hub row
    vals = torch.as_tensor(rng.normal(size=(e, F)), dtype=torch.float32)
    mask = torch.as_tensor(rng.random(e) < 0.8)
    vals[~mask] = float("nan")
    index = torch.as_tensor(idx)
    want = common.scatter_sum_plain(vals, index, n, mask)
    v_c, i_c, m_c = vals.to(card), index.to(card), mask.to(card)
    before = segment_spmm_csr.launches
    got = common.scatter_sum(v_c, i_c, n, m_c)
    torch.cuda.synchronize()
    assert segment_spmm_csr.launches == before + 1
    assert torch.equal(got.cpu(), want) and not torch.isnan(got).any()
    assert torch.equal(got, common.scatter_sum_plain(v_c, i_c, n, m_c))
    # no mask: every edge live
    assert torch.equal(common.scatter_sum(v_c.nan_to_num(), i_c, n).cpu(),
                       common.scatter_sum_plain(vals.nan_to_num(), index, n))
    # the values' gradient: the output gradient gathered at each live edge
    x = v_c.nan_to_num().requires_grad_()
    g = torch.as_tensor(rng.normal(size=(n, F)), dtype=torch.float32, device=card)
    before = segment_spmm_csr_backward.launches
    common.scatter_sum(x, i_c, n, m_c).backward(g)
    torch.cuda.synchronize()
    assert segment_spmm_csr_backward.launches == before + 1
    want_g = torch.where(m_c[:, None], g[i_c], 0.0)
    assert torch.equal(x.grad, want_g)


def test_gin_forward_and_backward_bitwise_vs_plain(card, monkeypatch):
    """GIN (gin-tu, reduced, node-level and pooled) through the kernel
    against the same model with every ``segment_spmm`` call (forward and
    backward) on its plain version on the card: logits, loss and every
    gradient leaf bit for bit."""
    import repro_torch.kernels.segment_spmm.ops as spmm_ops
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.graphs import batch_to_device, random_graph_batch
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_reference
    from repro_torch.models.gnn import api
    from repro_torch.utils import tree

    cfg = get_config("gin-tu").reduced()
    shapes = {s.name: s for s in GNN_SHAPES}

    def run(cell):
        shape = shapes[cell]
        batch = batch_to_device(random_graph_batch(cfg, shape, seed=2, scale=0.05), card)
        params = api.init(cfg, shape, seed=0, device=card)
        (loss, _), grads = tree.value_and_grad(
            lambda p: api.loss_fn(p, batch, cfg, shape), params)
        return [loss] + tree.leaves(grads)

    for cell in ("molecule", "full_graph_sm"):
        before = (spmm_ops.segment_spmm_csr.launches,
                  spmm_ops.segment_spmm_csr_backward.launches)
        kernel = run(cell)
        assert spmm_ops.segment_spmm_csr.launches > before[0]
        assert spmm_ops.segment_spmm_csr_backward.launches > before[1]
        with monkeypatch.context() as m:
            m.setattr(spmm_ops, "_spmm", lambda x, csr, w, counter:
                      segment_spmm_csr_reference(x, csr.row_ptr, csr.src, w))
            plain = run(cell)
        assert all(torch.equal(a, b) for a, b in zip(kernel, plain)), cell


def test_kernel_wrapper_outputs_have_a_grad_fn(card):
    """Each kernel wrapper's output has a grad_fn exactly when autograd
    records and an input requires grad (and none under no_grad)."""
    from repro_torch.kernels.embedding_bag.ops import embedding_bag
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.segment_spmm.ops import csr_from_edges, segment_spmm_csr

    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attn_inputs(1, 1, 40, 40, 1, 2, 64, dtype, card)
        assert flash_attention(q, k, v).grad_fn is None
        for t in (q, k, v):
            t.requires_grad_()
            assert flash_attention(q, k, v).grad_fn is not None
            with torch.no_grad():
                assert flash_attention(q, k, v).grad_fn is None
            t.requires_grad_(False)
    table = torch.randn((100, 8), device=card)
    ids = torch.randint(0, 100, (5, 3), dtype=torch.int32, device=card)
    assert embedding_bag(table, ids).grad_fn is None
    assert embedding_bag(table.requires_grad_(), ids).grad_fn is not None
    csr = csr_from_edges(torch.arange(10, device=card), torch.arange(10, device=card) % 4, 4)
    x, w = torch.randn((10, 4), device=card), torch.ones(10, device=card)
    assert segment_spmm_csr(x, csr, w).grad_fn is None
    assert segment_spmm_csr(x.requires_grad_(), csr, w).grad_fn is not None


def test_trainer_resume_on_the_card_is_bitwise(card, tmp_path):
    """Reduced qwen3-4b (float32) trained on the card through the launcher's
    Trainer for 6 steps, checkpoint every 2: a run that fails at step 3 and
    resumes from step 2 ends with the uninterrupted run's parameters and
    optimizer state bit for bit (every kernel and every scatter on the path
    sums in a fixed order)."""
    from repro_torch.kernels.flash_attention.ops import flash_attention_backward
    from repro_torch.launch.train import build_trainer
    from repro_torch.utils import tree

    def trainer(ckdir, fail_at=None):
        t = build_trainer(steps=6, batch=2, seq_len=64, ckpt_dir=str(ckdir), device=card,
                          checkpoint_every=2)
        t.cfg.fail_at_step = fail_at
        return t

    before = flash_attention_backward.launches
    ref = trainer(tmp_path / "a")
    ref.run()
    assert flash_attention_backward.launches > before
    crash = trainer(tmp_path / "b", fail_at=3)
    with pytest.raises(RuntimeError, match="injected failure"):
        crash.run()
    resumed = trainer(tmp_path / "b")
    assert resumed.try_resume() and resumed.step == 2
    for _ in range(2):                      # the batches of steps 0 and 1
        next(resumed.data)
    resumed.run()
    for a, b in zip(tree.leaves((ref.params, ref.opt_state)),
                    tree.leaves((resumed.params, resumed.opt_state))):
        assert torch.equal(a, b)


@pytest.mark.parametrize("start", ["hash", "block"])
def test_taper_paper_refine_step_on_the_card(card, start):
    """The ``taper_paper`` refine step at n = 200,000, k = 512 (the
    configuration's trie, ``dense_ext_to=False``) and with the MQ1-3 trie,
    whose depth 5 holds two nodes of one label: the kernel field bitwise
    the plain field on the card and on the CPU."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.tpstry import synthetic_trie
    from repro_torch.graphs.generators import musicbrainz_like

    cfg = get_config("taper_paper")
    g = musicbrainz_like(200_000, avg_degree=cfg.avg_degree, seed=0)
    k = cfg.k_partitions
    if start == "hash":
        part = hash_partition(g.n, k, seed=1)
    else:
        count = np.bincount(g.labels)
        first = np.concatenate([[0], np.cumsum(count)[:-1]])
        part = (((np.arange(g.n) - first[g.labels]) * k) // count[g.labels]).astype(np.int32)
    mq = [(parse_rpq("Area.Artist.(Artist|Label).Area"), 0.2),
          (parse_rpq("Artist.Credit.(Track|Recording).Credit.Artist"), 0.3),
          (parse_rpq("Artist.Credit.Track.Medium"), 0.5)]
    for trie in (synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2),
                 TPSTry.from_workload(mq).compile(g.label_names)):
        pre = {}
        before = _LAUNCHES.value
        fc = extroversion_field(g, trie, part, k, device=card, dense_ext_to=False,
                                _precomputed=pre)
        assert _LAUNCHES.value - before == trie.max_depth - 1
        fp = extroversion_field(g, trie, part, k, device=card, backend="torch",
                                dense_ext_to=False, _precomputed=pre)
        fcpu = extroversion_field(g, trie, part, k, device="cpu", dense_ext_to=False)
        for name in ("alpha", "pr", "edge_mass", "extro_mass", "extroversion"):
            assert np.array_equal(getattr(fc, name), getattr(fp, name)), name
            assert np.array_equal(getattr(fc, name), getattr(fcpu, name)), name
        assert fc.ext_to is None
