"""PyTorch + CUDA port of the TAPER reproduction.

Mirrors the JAX package one file for one file (``repro/core/visitor.py`` ↔
``repro_torch/core/visitor.py``); host-side logic stays numpy, device
arrays are torch tensors, and the Visitor-Matrix DP step runs as a
hand-written CUDA kernel on Hopper (``kernels/csrc/vm_step.cu``).
"""
