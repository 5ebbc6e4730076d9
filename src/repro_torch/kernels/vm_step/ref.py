"""Plain PyTorch version of one Visitor-Matrix DP edge-propagation step.

Given alpha (n, N_trie) and the per-destination-label trie transition
matrices T (L, N, N) with T[l][p, c] = cond_p(c) iff child(p, l) == c:

    alpha_out[w, :] = sum over edges (u, w):
        (alpha[u] @ T[label(w)]) * inv_cnt[u, label(w)]

This is the depth-advancing update of ``repro_torch.core.visitor``'s field,
expressed for ALL depths at once (the transition matrix is depth-stratified
so one matmul advances every state by one step).  A trie's T has at most
one nonzero per column, so the port keeps it in its column form
(:func:`transition_columns`): ``par[l, c]`` the nonzero's row and
``val[l, c]`` its value.  The matmul is then one gather and one multiply
per column.  This is the CPU path of ``ops.vm_step`` and the CUDA kernel's
yardstick on the card; on both it adds each row's messages in edge order
from 0 (``segment_spmm.ref.scatter_add``), so it repeats bitwise on the card
and gives the CPU's bits there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.segment_spmm.ref import scatter_add


def transition_columns(trie_parent, trie_label, trie_cond_p, n_labels: int):
    """T's column form from TrieArrays fields (numpy): ``(par, val)``, each
    ``(L, N)``, int32 and float32.  Column ``c`` of ``T[label(c)]`` holds
    ``cond_p(c)`` in row ``parent(c)``; every other column of every label is
    empty (row 0, value 0), the root's too."""
    parent = np.asarray(trie_parent)
    label = np.asarray(trie_label)
    N = parent.shape[0]
    par = np.zeros((n_labels, N), np.int32)
    val = np.zeros((n_labels, N), np.float32)
    c = np.nonzero(parent >= 0)[0]
    par[label[c], c] = parent[c]
    val[label[c], c] = np.asarray(trie_cond_p, np.float32)[c]
    return par, val


def vm_step_reference(
    alpha: torch.Tensor,       # (n_in, N), n_in may exceed n_out
    par: torch.Tensor,         # (L, N) int: row of each column's nonzero
    val: torch.Tensor,         # (L, N) value of each column's nonzero
    edge_src: torch.Tensor,    # (E,) int
    edge_dst: torch.Tensor,    # (E,) int
    inv_cnt_e: torch.Tensor,   # (E,) 1 / cnt[src, label(dst)], 0 on cut edges
    dst_label: torch.Tensor,   # (E,) int
    n_out: int,
) -> torch.Tensor:
    """Gather ``alpha[src, par[label]]``, multiply by ``val[label]``, scale,
    scatter-add by destination into ``(n_out, N)``: one (E, N) message
    tensor.  ``alpha`` may have more rows than the output (a shard's rows
    and its halo); sources index ``alpha``, destinations the output."""
    lab = dst_label.long()
    msgs = alpha[edge_src.long()[:, None], par.long()[lab]] * val[lab]
    msgs = msgs * inv_cnt_e[:, None]
    return scatter_add(msgs, edge_dst, n_out)
