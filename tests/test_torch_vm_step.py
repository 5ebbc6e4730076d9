"""The port's ``vm_step`` against the JAX reference: the reference's Pallas
kernel (interpret mode on the CPU, as tests/test_kernels.py runs it) and its
jnp oracle, on the same numpy-seeded inputs.  On the CPU the wrapper takes
the plain torch version; the CUDA kernel itself is checked on the card
(tests/test_torch_cuda.py)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.tpstry import synthetic_trie
from repro.core.visitor import extroversion_field as r_field
from repro.kernels.vm_step.ops import pack_vm_inputs as r_pack_vm_inputs
from repro.kernels.vm_step.ops import vm_step as r_vm_step
from repro.kernels.vm_step.ref import build_transition as r_build_transition
from repro.kernels.vm_step.ref import vm_step_reference as r_vm_step_reference

from repro_torch.convert import from_reference_arrays
from repro_torch.core.visitor import extroversion_field
from repro_torch.kernels.vm_step.ops import (csr_from_packing, pack_vm_inputs,
                                             vm_step)
from repro_torch.kernels.vm_step.ref import transition_columns

_rng = np.random.default_rng(20261017)
SWEEP = [(int(_rng.integers(10, 301)), int(_rng.integers(5, 1201)), L,
          int(_rng.integers(0, 2**16)))
         for L in (3, 6, 12) for _ in range(3)]


def _csr_inputs(src, dst, labels, cnt, n, block_n=64, block_e=128):
    """The port's kernel inputs (dst-sorted CSR, per-edge 1/cnt) as tensors."""
    packed, _, inv_cnt = pack_vm_inputs(src, dst, labels, cnt, n, block_n, block_e)
    dst_global = (np.repeat(packed.meta[:, 0], block_e) * block_n
                  + packed.dst_local)
    csr = csr_from_packing(packed, dst_global, n)
    return (torch.from_numpy(csr.row_ptr), torch.from_numpy(csr.src),
            torch.from_numpy(inv_cnt[packed.pad_mask]),
            torch.from_numpy(np.asarray(labels, np.int32)))


@pytest.mark.parametrize("n,e,n_labels,seed", SWEEP)
def test_vm_step_sweep_matches_reference(n, e, n_labels, seed):
    rng = np.random.default_rng(seed)
    trie = synthetic_trie(n_labels, 3, 2, n_first=min(3, n_labels),
                          seed=int(rng.integers(1e6)))
    N = trie.n_nodes
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    labels = rng.integers(0, n_labels, n).astype(np.int32)
    cnt = rng.integers(1, 5, (n, n_labels)).astype(np.int32)
    alpha = rng.random((n, N)).astype(np.float32)
    T = r_build_transition(trie.parent, trie.label, trie.cond_p, n_labels)
    par, val = transition_columns(trie.parent, trie.label, trie.cond_p, n_labels)

    out = vm_step(torch.from_numpy(alpha), torch.from_numpy(par),
                  torch.from_numpy(val),
                  *_csr_inputs(src, dst, labels, cnt, n)).numpy()

    packed, dst_label, inv_cnt = r_pack_vm_inputs(src, dst, labels, cnt, n,
                                                  block_n=64, block_e=128)
    pallas = np.asarray(r_vm_step(jnp.asarray(alpha), jnp.asarray(T), packed,
                                  dst_label, inv_cnt, n))
    inv_ref = (1.0 / np.maximum(cnt[src, labels[dst]], 1.0)).astype(np.float32)
    oracle = np.asarray(r_vm_step_reference(
        jnp.asarray(alpha), jnp.asarray(T), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(inv_ref), jnp.asarray(labels[dst]), n))
    np.testing.assert_allclose(out, pallas, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(out, oracle, rtol=1e-4, atol=1e-5)


def test_vm_step_matches_visitor_dp(paper_graph, paper_trie, paper_partition):
    """Applying the step to the paper graph's depth-1 priors over its local
    edges reproduces the depth-2 alpha states of the §5.4 worked example —
    the port's field and the reference's alike."""
    arrays = paper_trie.compile(paper_graph.label_names)
    state = from_reference_arrays(
        graph=dict(n=paper_graph.n, labels=paper_graph.labels,
                   label_names=paper_graph.label_names, src=paper_graph.src,
                   dst=paper_graph.dst),
        trie=vars(arrays), part=paper_partition)
    g, trie, part = state.graph, state.trie, state.part
    fld = extroversion_field(g, trie, part, k=2, device="cpu")
    ref = r_field(paper_graph, arrays, paper_partition, k=2)

    N = trie.n_nodes
    alpha0 = np.zeros((g.n, N), np.float32)
    d1 = trie.depth == 1
    alpha0[:, d1] = fld.alpha[:, d1]
    local = part[g.src] == part[g.dst]
    src, dst = g.src[local], g.dst[local]
    par, val = transition_columns(trie.parent, trie.label, trie.cond_p,
                                  trie.n_labels)
    out = vm_step(torch.from_numpy(alpha0), torch.from_numpy(par),
                  torch.from_numpy(val),
                  *_csr_inputs(src, dst, g.labels, g.neighbor_label_counts(),
                               g.n, block_n=8, block_e=8)).numpy()
    d2 = trie.depth == 2
    np.testing.assert_allclose(out[:, d2], fld.alpha[:, d2], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(out[:, d2], ref.alpha[:, d2], rtol=1e-5, atol=1e-6)


def _small_args():
    alpha = torch.rand(4, 3)
    par = torch.tensor([[0, 0, 1], [0, 0, 0]], dtype=torch.int32)
    val = torch.tensor([[0.0, 0.5, 0.25], [0.0, 0.0, 0.75]])
    row_ptr = torch.tensor([0, 1, 1, 3, 3], dtype=torch.int32)
    src = torch.tensor([2, 0, 3], dtype=torch.int32)
    w = torch.tensor([0.5, 1.0, 0.0])
    row_label = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    return [alpha, par, val, row_ptr, src, w, row_label]


def test_vm_step_plain_on_cpu_counts_no_launch():
    before = vm_step.launches
    args = _small_args()
    out = vm_step(*args)
    alpha, par, val = args[:3]
    T = torch.zeros(2, 3, 3).scatter_(1, par.long()[:, None, :], val[:, None, :])
    want = torch.zeros(4, 3)
    want[0] = (alpha[2] @ T[0]) * 0.5
    want[2] = (alpha[0] @ T[1]) * 1.0
    torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-7)
    assert vm_step.launches == before


@pytest.mark.parametrize("bad", [
    (0, torch.rand(4, 3, dtype=torch.float64)),           # dtype
    (1, torch.zeros(2, 4, dtype=torch.int32)),            # par width != N
    (2, torch.zeros(3, 3)),                               # val shape != par's
    (1, torch.zeros(2, 3, dtype=torch.int64)),            # column-form dtype
    (3, torch.tensor([0, 1, 3, 3], dtype=torch.int32)),   # row_ptr length
    (4, torch.tensor([2, 0, 3], dtype=torch.int64)),      # index dtype
    (5, torch.rand(6)[::2]),                              # non-contiguous
])
def test_vm_step_rejects_bad_arguments(bad):
    args = _small_args()
    i, value = bad
    args[i] = value
    with pytest.raises(ValueError):
        vm_step(*args)


def test_kernel_build_needs_nvcc(monkeypatch, tmp_path):
    """Without a CUDA toolchain the build raises (no silent fall back);
    the library goes to the build directory, named by its source hash."""
    from repro_torch.kernels import build

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.os.path, "exists", lambda path: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build_all()
    lib = build._target(build.CSRC / "vm_step.cu")
    assert lib.parent == tmp_path / "build" and lib.name.startswith("libvm_step-")


@pytest.mark.parametrize("n_labels,depth,branch", [(3, 3, 2), (12, 3, 3), (26, 2, 26)])
def test_transition_columns_rebuild_the_trie_transition(n_labels, depth, branch):
    """The column form the kernel takes holds every nonzero of the JAX
    package's dense T: scattering it back gives T bitwise."""
    trie = synthetic_trie(n_labels, depth, branch, n_first=min(3, n_labels), seed=7)
    T = torch.from_numpy(r_build_transition(trie.parent, trie.label, trie.cond_p,
                                            n_labels))
    par, val = map(torch.from_numpy, transition_columns(
        trie.parent, trie.label, trie.cond_p, n_labels))
    assert par.dtype == torch.int32 and par.shape == val.shape == T.shape[::2]
    back = torch.zeros_like(T).scatter_(1, par.long()[:, None, :], val[:, None, :])
    assert torch.equal(back, T)
