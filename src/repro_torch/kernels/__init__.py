"""Hand-written Hopper kernels for the port's compute hot spots.

Each kernel package keeps the JAX package's three parts:
  kernel.py — binding of the CUDA C++ kernel (``csrc/*.cu``, built at first
              use by ``kernels/build.py``)
  ops.py    — wrapper: host-side packing, argument checks, launch counter;
              launches the kernel for CUDA tensors and uses the plain
              version only for CPU tensors
  ref.py    — plain PyTorch version of the same function: the CPU path and
              the kernel's yardstick on the card

Kernels (CUDA C++ for ``sm_90a``; each replaces one TPU kernel):
  vm_step       — TAPER's Visitor-Matrix DP depth step over the trie
                  transition's column form (replaces
                  ``src/repro/kernels/vm_step/kernel.py::_vm_kernel``)
  embedding_bag — DLRM's multi-hot bag sum/mean (replaces
                  ``src/repro/kernels/embedding_bag/kernel.py::_bag_kernel``)
  segment_spmm  — GNN message passing ``out[dst] += w * x[src]`` over a
                  dst-sorted CSR (replaces
                  ``src/repro/kernels/segment_spmm/kernel.py::_spmm_kernel``)
  flash_attention — the LM's prefill attention: blocked online softmax,
                  top-left causal and one-sided window masks, GQA; two
                  kernels by input type, ``flash_attention_bf16`` on the
                  tensor cores (wgmma, TMA, mbarriers) and
                  ``flash_attention_f32`` as three TF32 mma.sync products
                  per product (replace
                  ``src/repro/kernels/flash_attention/kernel.py::_attn_kernel``)

Every TPU kernel of the JAX package has its counterpart here.

Training adds backward kernels (the JAX package has none: it takes
``jax.value_and_grad`` through its plain ``jnp`` functions), each behind a
``torch.autograd.Function`` in its wrapper, with its own launch count:
  flash_attention_bwd — dq, dk, dv from the forward kernel's output and row
                  log-sum-exp (``csrc/flash_attention_bwd.cu``: bf16 at
                  D <= 128 on wgmma + TMA, the rest on the CUDA cores)
  embedding_bag_backward — the table's dense gradient over a CSR of the
                  id-sorted slots (``csrc/embedding_bag_bwd.cu``: a lane
                  group a row, a block a hot row)
  segment_spmm_csr_backward — x's gradient, as ``segment_spmm`` over the
                  transposed CSR (cached on the ``EdgeCSR``)
"""
import sys
import threading

import torch
from torch._subclasses.fake_tensor import is_fake

#: guards every wrapper's launch counter: a kernel may launch from several
#: threads (the serving loop runs its invocations' fields on a thread of
#: their own), and a counter read under this lock sees every launch so far
LAUNCH_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel did not build, load or launch.

    Callers that degrade on other faults (the serving loop's backend
    ladder) let this one through: a broken kernel must fail loudly, never
    be served around by its plain version."""


#: inputs that each kernel's op reads only through an index (by position):
#: the dry-run's compulsory bytes count those tensors' indices, not the
#: tensors themselves (``launch/hlo_analysis.py``)
GATHERED_INPUTS = {}


#: each kernel's function that registers its custom op's DTensor sharding
#: rules (:func:`sharding_rules`), all run the first time a wrapper meets a
#: DTensor
_SHARDING_RULES = []
_RULES_LOCK = threading.Lock()
_rules_registered = False


def sharding_rules(fn):
    """Decorator: ``fn`` registers a kernel's DTensor sharding rules.  They
    are registered when a wrapper first meets a DTensor (at once, if one
    already has): importing ``torch.distributed.tensor`` takes seconds on a
    slow host, which a process that holds no DTensor need not pay."""
    with _RULES_LOCK:
        _SHARDING_RULES.append(fn)
        if _rules_registered:
            fn()
    return fn


def _register_sharding_rules() -> None:
    global _rules_registered
    with _RULES_LOCK:
        if not _rules_registered:
            for fn in _SHARDING_RULES:
                fn()
            _rules_registered = True


def is_dtensor(t) -> bool:
    """``t`` is a ``torch.distributed.tensor.DTensor``.  No DTensor exists
    before that module is imported, so this imports nothing."""
    module = sys.modules.get("torch.distributed.tensor")
    return module is not None and isinstance(t, module.DTensor)


def traced(*tensors) -> bool:
    """True where a tensor is a fake tensor or a
    ``torch.distributed.tensor.DTensor``: a wrapper then calls its kernel's
    custom op (``repro_torch::<name>``), whose fake route returns empty
    outputs of the right shapes and whose sharding rule lets a DTensor
    through (on a real DTensor the op launches the kernel, or runs the plain
    version, on the local tensors).  Plain CPU and CUDA tensors skip the op:
    a tensor on any other device (``meta`` included) must raise, where the
    op would answer it from its fake route, and the op's dispatch costs a
    host call more than the direct route (``tools/op_dispatch_time.py``
    times both)."""
    hit = False
    for t in tensors:
        if type(t) is torch.Tensor:
            continue
        if is_dtensor(t):
            _register_sharding_rules()
            return True
        hit = hit or is_fake(t)
    return hit


def fake(*tensors) -> bool:
    """True where a tensor is a fake tensor, or a DTensor of fake local
    tensors: it holds shapes alone, so nothing can be checked or planned
    from its values."""
    return any(is_fake(t) for t in tensors)
