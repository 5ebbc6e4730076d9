"""The port's CUDA kernel on the card (``cuda`` marker).

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


def test_vm_step_kernel_matches_plain(card):
    rng = np.random.default_rng(1)
    n, e, L, N = 5000, 40000, 3, 23
    dst = np.sort(rng.integers(0, n, e))
    dst[:12000] = 17                                      # hub row
    dst = np.sort(dst)
    row_ptr = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=n), out=row_ptr[1:])
    w = rng.random(e).astype(np.float32)
    w[rng.random(e) < 0.4] = 0.0                          # cut edges
    args = [torch.as_tensor(rng.random((n, N)), dtype=torch.float32),
            torch.as_tensor(rng.random((L, N, N)) / N, dtype=torch.float32),
            torch.as_tensor(row_ptr, dtype=torch.int32),
            torch.as_tensor(rng.integers(0, n, e), dtype=torch.int32),
            torch.as_tensor(w),
            torch.as_tensor(rng.integers(0, L, n), dtype=torch.int32)]
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
