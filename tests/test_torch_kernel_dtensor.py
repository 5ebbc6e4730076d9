"""The kernel wrappers on real DTensors, which go through each kernel's
custom op (``kernels.traced``): a CSR of DTensors is checked and planned
whole, its plan replicated on its mesh, and ``vm_step`` and
``segment_spmm_csr`` give the plain tensors' results, on a one-rank mesh
of this process's group (gloo on the CPU, NCCL on the card).  The port's
modules import no ``torch.distributed.tensor`` until a DTensor exists."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.kernels.segment_spmm.ops import EdgeCSR, segment_spmm_csr
from repro_torch.kernels.vm_step.ops import vm_step
from repro_torch.kernels.vm_step.ref import transition_columns
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.obs import default_registry

#: the kernel's launches in this process (counted at each launch)
_LAUNCHES = default_registry().counter("vm_step_launches_total")


def _inputs(n=600, e=5000, N=9, L=3, seed=0):
    """Seeded dst-sorted CSR inputs on the CPU: alpha, par, val, row_ptr,
    src, w (30% cut edges), row labels, and a trie's column form."""
    rng = np.random.default_rng(seed)
    parent = np.r_[-1, rng.integers(0, np.arange(1, N))].astype(np.int32)
    label = rng.integers(0, L, N).astype(np.int32)
    par, val = transition_columns(parent, label, rng.random(N).astype(np.float32), L)
    dst = np.sort(rng.integers(0, n, e))
    dst[:700] = 11                                   # one long row
    dst = np.sort(dst)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    w = rng.random(e).astype(np.float32)
    w[rng.random(e) < 0.3] = 0.0
    t = torch.as_tensor
    return dict(alpha=t(rng.random((n, N)), dtype=torch.float32), par=t(par), val=t(val),
                row_ptr=t(row_ptr, dtype=torch.int32),
                src=t(rng.integers(0, n, e), dtype=torch.int32), w=t(w),
                row_label=t(rng.integers(0, L, n), dtype=torch.int32))


def _on_mesh(a, mesh, x_placements):
    """The inputs as DTensors: every one replicated, alpha laid out by
    ``x_placements``."""
    rep = [Replicate()] * mesh.ndim
    out = {k: distribute_tensor(v, mesh, rep) for k, v in a.items()}
    out["alpha"] = distribute_tensor(a["alpha"], mesh, x_placements)
    return out


def _dtensor_kernels_equal_plain(device, x_placements):
    a = {k: v.to(device) for k, v in _inputs().items()}
    mesh = make_smoke_mesh(device=device)
    d = _on_mesh(a, mesh, x_placements)
    csr = EdgeCSR(row_ptr=a["row_ptr"], src=a["src"], order=torch.arange(a["src"].shape[0]))
    dcsr = EdgeCSR(row_ptr=d["row_ptr"], src=d["src"], order=csr.order)
    # checked and planned whole: the plain CSR's plan, replicated on the mesh
    assert dcsr.src_bound == csr.src_bound
    for got, want in zip((dcsr.plan.runs, dcsr.plan.long_rows),
                         (csr.plan.runs, csr.plan.long_rows)):
        assert isinstance(got, DTensor) and got.placements == tuple(Replicate()
                                                                    for _ in range(mesh.ndim))
        assert torch.equal(got.to_local(), want)
    assert csr.plan.long_rows.numel() == 1               # the long row's own path runs too

    before = _LAUNCHES.value
    out = vm_step(d["alpha"], d["par"], d["val"], dcsr, d["w"], d["row_label"])
    plain = vm_step(a["alpha"], a["par"], a["val"], csr, a["w"], a["row_label"])
    assert isinstance(out, DTensor) and torch.equal(out.full_tensor(), plain)
    assert _LAUNCHES.value - before == (2 if device == "cuda" else 0)
    spmm = segment_spmm_csr(d["alpha"], dcsr, d["w"])
    assert torch.equal(spmm.full_tensor(), segment_spmm_csr(a["alpha"], csr, a["w"]))
    return out.full_tensor(), spmm.full_tensor(), a


@pytest.mark.parametrize("x", ["replicated", "columns"])
def test_dtensor_csr_kernels_equal_plain_cpu(x):
    placements = [Replicate(), Replicate() if x == "replicated" else Shard(1)]
    out, spmm, a = _dtensor_kernels_equal_plain("cpu", placements)
    assert float(out.abs().sum()) > 0 and float(spmm.abs().sum()) > 0
    # a DTensor CSR is checked: offsets that do not start at 0 fail
    mesh = make_smoke_mesh(device="cpu")
    bad = distribute_tensor(a["row_ptr"] + 1, mesh, [Replicate()] * mesh.ndim)
    with pytest.raises(ValueError, match="row_ptr must start at 0"):
        EdgeCSR(row_ptr=bad, src=distribute_tensor(a["src"], mesh, [Replicate()] * mesh.ndim),
                order=torch.arange(a["src"].shape[0]))


@pytest.mark.cuda
def test_dtensor_csr_kernels_equal_plain_card():
    """On the card: the custom op launches the kernels on the local tensors
    (one ``vm_step`` launch each for the DTensor and the plain call), bitwise
    the kernel on plain tensors, and within the kernel test's tolerance of
    the plain version on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (and nvcc) to build and run the kernel")
    out, spmm, a = _dtensor_kernels_equal_plain("cuda", [Replicate(), Replicate()])
    cpu = {k: v.cpu() for k, v in a.items()}
    csr = EdgeCSR(row_ptr=cpu["row_ptr"], src=cpu["src"], order=torch.arange(cpu["src"].shape[0]))
    torch.testing.assert_close(out.cpu(), vm_step(cpu["alpha"], cpu["par"], cpu["val"], csr,
                                                  cpu["w"], cpu["row_label"]),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(spmm.cpu(), segment_spmm_csr(cpu["alpha"], csr, cpu["w"]))


def test_port_imports_no_dtensor_module():
    """The port's entry points import no ``torch.distributed.tensor`` (seconds
    on a slow host, in every process a path spawns): no DTensor can exist
    before it is imported, so the wrappers detect DTensors without it and
    register their sharding rules when they first meet one."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    probe = ("import sys\n"
             "import repro_torch.core.taper, repro_torch.launch.serve, repro_torch.optim.adamw\n"
             "import repro_torch.models.transformer, repro_torch.models.dlrm\n"
             "import repro_torch.models.gnn.api, repro_torch.kernels.embedding_bag.ops\n"
             "assert 'torch.distributed.tensor' not in sys.modules, 'imported'\n")
    root = Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                         text=True, env=dict(os.environ, PYTHONPATH=str(root / "src")))
    assert out.returncode == 0, out.stderr[-2000:]
