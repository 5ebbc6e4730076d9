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
    from repro_torch.kernels.segment_spmm.ops import csr_from_edges, segment_spmm_csr
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
    # the plain version over the raw edge list, on the CPU: on the card its
    # index_add_ adds in no fixed order (atomics), and on the 10,000-edge hub
    # row two of its own runs differ by up to 4.7e-4
    ref = segment_spmm_reference(x.cpu(), torch.as_tensor(src), torch.as_tensor(dst),
                                 torch.as_tensor(w), n)
    torch.testing.assert_close(out.cpu(), ref, rtol=1e-4, atol=1e-4)
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
    before = vm_step.launches
    for _ in range(3):
        got = vm_step(*on_card)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want)
    assert vm_step.launches == before + 3


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
        return common.scatter_sum, (vals, dst, n, mask)
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
    before = vm_step.launches
    got = vm_step(*(a.to(card) for a in args))
    torch.cuda.synchronize()
    assert vm_step.launches == before + 1
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
            before = vm_step.launches
            got = vm_step(*(a.to(card) for a in args))
            torch.cuda.synchronize()
            assert vm_step.launches == before + 1
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
                before = vm_step.launches
                fs = extroversion_field(g, arrays, part, 8, _precomputed=pre,
                                        backend="cuda_sharded", device=card,
                                        shard_map_source=source,
                                        halo_exchange=exchange)
                assert vm_step.launches - before == arrays.max_depth - 1
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
        before, inv = vm_step.launches, loop.ot.invocations
        pump_until(lambda: loop.ot.invocations > inv)
        assert vm_step.launches > before
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
        before = vm_step.launches
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
        parts[name] = (out, vm_step.launches - before)
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
        before = vm_step.launches
        r = run_scenario(tmp_path / name, "crash_storm", device=device)
        assert r.ok, (r.invariant_errors, r.staleness_violations)
        assert r.stats["backend_fallbacks"] == 0
        digests[name] = (r.digest, vm_step.launches - before)
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
            before = vm_step.launches
            inv0 = coord.primary.ot.invocations
            drive(coord, 12, seed=4)
            assert coord.primary.ot.invocations > inv0
            launches = vm_step.launches - before
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
