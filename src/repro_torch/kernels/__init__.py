"""Hand-written Hopper kernels for the port's compute hot spots.

Each kernel package keeps the JAX package's three parts:
  kernel.py — binding of the CUDA C++ kernel (``csrc/*.cu``, built at first
              use by ``kernels/build.py``)
  ops.py    — wrapper: host-side packing, argument checks, launch counter;
              launches the kernel for CUDA tensors and uses the plain
              version only for CPU tensors
  ref.py    — plain PyTorch version of the same function: the CPU path and
              the kernel's yardstick on the card

Kernels:
  vm_step — TAPER's Visitor-Matrix DP depth step (replaces the TPU kernel
            ``src/repro/kernels/vm_step/kernel.py::_vm_kernel``)
"""
