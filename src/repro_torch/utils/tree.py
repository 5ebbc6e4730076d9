"""Parameter trees: nested dicts, lists and tuples of tensors.

The port's stand-in for the part of ``jax.tree_util`` the JAX package's
optimizer, compressor and checkpointer use.  Leaves come in JAX's flatten
order — dict keys sorted, sequences in order — and a leaf's path is spelt as
``jax.tree_util.tree_flatten_with_path`` spells it (``['params']/['w']/[0]``),
so checkpoints name their arrays alike in both packages.  ``None`` is an
empty subtree, as in JAX.  ``value_and_grad`` is ``jax.value_and_grad(fn,
has_aux=True)`` over such a tree, by ``torch.autograd.grad``.
"""
from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch


def _children(tree):
    """(key text, child) pairs of a node in flatten order, or None for a
    leaf."""
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        return [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def flatten_with_paths(tree) -> Tuple[List[str], List[Any]]:
    """``(paths, leaves)`` in JAX's flatten order."""
    paths, leaves = [], []

    def walk(node, path):
        if node is None:
            return
        kids = _children(node)
        if kids is None:
            paths.append("/".join(path))
            leaves.append(node)
            return
        for key, child in kids:
            walk(child, path + [key])

    walk(tree, [])
    return paths, leaves


def leaves(tree) -> List[Any]:
    return flatten_with_paths(tree)[1]


def unflatten(like, values) -> Any:
    """A tree of ``like``'s structure holding ``values`` in flatten order."""
    it = iter(values)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            return {k: v for k, v in ((k, build(node[k])) for k in sorted(node))}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("unflatten: more values than the tree has leaves")
    return out


def map_leaves(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and of trees of its structure."""
    return unflatten(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])


def value_and_grad(fn: Callable, params):
    """``((value, aux), grads)`` of ``fn(params) -> (value, aux dict)`` with
    respect to every leaf of ``params`` (all floating point), as
    ``jax.value_and_grad(fn, has_aux=True)``; the leaves are not copied
    (``fn`` sees detached aliases that require grad)."""
    flat = leaves(params)
    if not all(t.is_floating_point() for t in flat):
        raise ValueError("value_and_grad: every parameter must be floating point")
    live = [t.detach().requires_grad_() for t in flat]
    with torch.enable_grad():
        value, aux = fn(unflatten(params, live))
        grads = torch.autograd.grad(value, live)
    aux = {k: v.detach() for k, v in aux.items()}
    return (value.detach(), aux), unflatten(params, list(grads))
