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
import threading

#: guards every wrapper's launch counter: a kernel may launch from several
#: threads (the serving loop runs its invocations' fields on a thread of
#: their own), and a counter read under this lock sees every launch so far
LAUNCH_LOCK = threading.Lock()


class KernelError(RuntimeError):
    """A hand-written kernel did not build, load or launch.

    Callers that degrade on other faults (the serving loop's backend
    ladder) let this one through: a broken kernel must fail loudly, never
    be served around by its plain version."""
