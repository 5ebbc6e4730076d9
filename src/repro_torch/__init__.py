"""PyTorch + CUDA port of the TAPER reproduction.

Mirrors the JAX package one file for one file (``repro/core/visitor.py`` ↔
``repro_torch/core/visitor.py``); host-side logic stays numpy, device
arrays are torch tensors, and the kernels are hand-written CUDA for Hopper
(``kernels/csrc/``): the Visitor-Matrix DP step of a TAPER invocation,
DLRM's embedding bag, GCN's message-passing SpMM and the LM's prefill
attention.
"""
