"""Plain PyTorch version of one Visitor-Matrix DP edge-propagation step.

Given alpha (n, N_trie) and the per-destination-label trie transition
matrices T (L, N, N) with T[l][p, c] = cond_p(c) iff child(p, l) == c:

    alpha_out[w, :] = sum over edges (u, w):
        (alpha[u] @ T[label(w)]) * inv_cnt[u, label(w)]

This is the depth-advancing update of ``repro_torch.core.visitor``'s field,
expressed for ALL depths at once (the transition matrix is depth-stratified
so one matmul advances every state by one step).  It is the CPU path of
``ops.vm_step`` and the CUDA kernel's yardstick on the card.
"""
from __future__ import annotations

import numpy as np
import torch


def build_transition(trie_parent, trie_label, trie_cond_p, n_labels: int):
    """(L, N, N) float32 transition tensor from TrieArrays fields (numpy)."""
    N = len(trie_parent)
    T = np.zeros((n_labels, N, N), np.float32)
    for c in range(N):
        p, l = int(trie_parent[c]), int(trie_label[c])
        if p >= 0:
            T[l, p, c] = float(trie_cond_p[c])
    return T


def vm_step_reference(
    alpha: torch.Tensor,       # (n, N)
    T: torch.Tensor,           # (L, N, N)
    edge_src: torch.Tensor,    # (E,) int
    edge_dst: torch.Tensor,    # (E,) int
    inv_cnt_e: torch.Tensor,   # (E,) 1 / cnt[src, label(dst)], 0 on cut edges
    dst_label: torch.Tensor,   # (E,) int
    n: int,
) -> torch.Tensor:
    """Gather, ``torch.bmm`` by ``T[dst_label]``, scale, ``index_add_``."""
    msgs = torch.bmm(alpha[edge_src].unsqueeze(1), T[dst_label]).squeeze(1)
    msgs = msgs * inv_cnt_e[:, None]
    out = torch.zeros((n, alpha.shape[1]), dtype=alpha.dtype, device=alpha.device)
    return out.index_add_(0, edge_dst, msgs)
