"""Plain reference of the workload trie (paper §4): the label strings of each
regular path query and each trie node's probability, worked out from the
query texts and frequencies alone.

Queries are over vertex labels: ``E ::= label | E.E | (E|E) | (E+E) | E*``.
A Kleene star expands to at most ``star_max`` repetitions; the trie holds
every prefix of every string up to the longest string of the workload.  A
node's probability is ``p(n) = sum_Q f(Q) * Pr(reach n | Q)``, where within a
query the next label at a prefix is uniform over the distinct next labels
that query admits there.  Nodes are keyed by their label path.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence, Tuple

Path = Tuple[str, ...]


def _tokens(text: str) -> List[str]:
    toks, i = [], 0
    text = text.replace("·", ".")
    while i < len(text):
        c = text[i]
        if c.isspace():
            i += 1
        elif c in ".|+*()":
            toks.append(c)
            i += 1
        elif c.isalnum() or c == "_":
            j = i
            while j < len(text) and (text[j].isalnum() or text[j] == "_"):
                j += 1
            toks.append(text[i:j])
            i = j
        else:
            raise ValueError(f"bad character {c!r} in {text!r}")
    return toks


def strings(text: str, star_max: int) -> FrozenSet[Path]:
    """The label strings of one query (its Kleene stars bounded)."""
    toks, pos = _tokens(text), [0]

    def peek() -> str:
        return toks[pos[0]] if pos[0] < len(toks) else ""

    def union() -> FrozenSet[Path]:
        acc = concat()
        while peek() in ("|", "+"):
            pos[0] += 1
            acc = acc | concat()
        return acc

    def concat() -> FrozenSet[Path]:
        acc = postfix()
        while peek() and peek() not in (")", "|", "+"):
            if peek() == ".":
                pos[0] += 1
            nxt = postfix()
            acc = frozenset(a + b for a in acc for b in nxt)
        return acc

    def postfix() -> FrozenSet[Path]:
        base = atom()
        while peek() == "*":
            pos[0] += 1
            acc, reps = frozenset({()}), frozenset({()})
            for _ in range(star_max):
                reps = frozenset(a + b for a in reps for b in base)
                acc = acc | reps
            base = acc
        return base

    def atom() -> FrozenSet[Path]:
        tok = peek()
        pos[0] += 1
        if tok == "(":
            inner = union()
            if peek() != ")":
                raise ValueError(f"missing ')' in {text!r}")
            pos[0] += 1
            return inner
        if not tok or not (tok[0].isalpha() or tok[0] == "_"):
            raise ValueError(f"unexpected token {tok!r} in {text!r}")
        return frozenset({(tok,)})

    out = union()
    if pos[0] != len(toks):
        raise ValueError(f"trailing tokens in {text!r}")
    return frozenset(s for s in out if s)


@dataclass
class Trie:
    """Nodes in order of (depth, path); the root is node 0 with path ``()``."""

    paths: List[Path]
    parent: List[int]
    p: List[float]
    cond_p: List[float]
    is_leaf: List[bool]

    @property
    def depth(self) -> List[int]:
        return [len(s) for s in self.paths]

    @property
    def max_depth(self) -> int:
        return max(self.depth)

    def index(self) -> Dict[Path, int]:
        return {s: i for i, s in enumerate(self.paths)}


def build(workload: Sequence[Tuple[str, float]], star_max: int) -> Trie:
    """The trie of ``[(query text, frequency), ...]``."""
    total = sum(max(float(f), 0.0) for _, f in workload)
    per_query = [(strings(q, star_max), max(float(f), 0.0) / total) for q, f in workload]
    per_query = [(s, f) for s, f in per_query if f > 0.0]
    nodes = {()}
    for strs, _ in per_query:
        for s in strs:
            nodes.update(s[:i] for i in range(1, len(s) + 1))
    paths = sorted(nodes, key=lambda s: (len(s), s))
    index = {s: i for i, s in enumerate(paths)}
    p = [0.0] * len(paths)
    p[0] = 1.0
    for strs, f in per_query:
        prefixes = {s[:i] for s in strs for i in range(len(s) + 1)}
        reach = {(): 1.0}
        for depth in range(max(len(s) for s in strs)):
            for pre in [q for q in reach if len(q) == depth]:
                kids = sorted({s for s in prefixes if len(s) == depth + 1 and s[:depth] == pre})
                for kid in kids:
                    reach[kid] = reach[pre] / len(kids)
        for s, r in reach.items():
            if s:
                p[index[s]] += f * r
    parent = [-1] + [index[s[:-1]] for s in paths[1:]]
    cond_p = [0.0] + [p[i] / max(p[parent[i]], 1e-30) for i in range(1, len(paths))]
    has_child = {s[:-1] for s in paths if s}
    return Trie(paths=paths, parent=parent, p=p, cond_p=cond_p,
                is_leaf=[s not in has_child for s in paths])
