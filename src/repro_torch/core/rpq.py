"""Regular Path Queries over vertex labels (paper §2, expression language (3)).

    E ::= tau | (E . E) | (E + E) | (E | E) | E*

``+`` (union) and ``|`` (exclusive disjunction) expand identically to a set of
label strings (paper §4: ``str(e1 | e2) = str(e1) ∪ str(e2)``); the Kleene
closure is expanded to a bounded number of repetitions
(``str(e^N) = str(e.e...e) N times``, paper §4) — the bound is the workload's
maximum pattern length ``t``.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import FrozenSet, List, Sequence, Tuple, Union


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class RPQ:
    """Node of an RPQ expression tree."""

    op: str  # "label" | "concat" | "union" | "star"
    children: Tuple["RPQ", ...] = ()
    symbol: str = ""

    # -- constructors ------------------------------------------------------
    def __mul__(self, other: "RPQ") -> "RPQ":  # q1 * q2 == concat
        return concat(self, other)

    def __or__(self, other: "RPQ") -> "RPQ":
        return union(self, other)

    # -- expansion ----------------------------------------------------------
    def strings(self, max_len: int, star_max: int = 3) -> FrozenSet[Tuple[str, ...]]:
        """``str(Q)``: the set of label strings described by the expression,
        with Kleene stars bounded to ``star_max`` repetitions and results
        truncated to ``max_len`` symbols."""
        out = {s for s in self._strings(star_max) if 0 < len(s) <= max_len}
        return frozenset(out)

    def _strings(self, star_max: int) -> FrozenSet[Tuple[str, ...]]:
        if self.op == "label":
            return frozenset({(self.symbol,)})
        if self.op == "union":
            acc: FrozenSet[Tuple[str, ...]] = frozenset()
            for c in self.children:
                acc = acc | c._strings(star_max)
            return acc
        if self.op == "concat":
            acc = frozenset({()})
            for c in self.children:
                nxt = c._strings(star_max)
                acc = frozenset(a + b for a in acc for b in nxt)
            return acc
        if self.op == "star":
            base = self.children[0]._strings(star_max)
            acc = frozenset({()})
            reps: FrozenSet[Tuple[str, ...]] = frozenset({()})
            for _ in range(star_max):
                reps = frozenset(a + b for a in reps for b in base)
                acc = acc | reps
            return acc
        raise ValueError(f"unknown op {self.op}")

    # -- identity ------------------------------------------------------------
    def to_text(self) -> str:
        if self.op == "label":
            return self.symbol
        if self.op == "union":
            return "(" + "|".join(c.to_text() for c in self.children) + ")"
        if self.op == "concat":
            return ".".join(
                c.to_text() if c.op in ("label", "star", "union") else f"({c.to_text()})"
                for c in self.children
            )
        if self.op == "star":
            inner = self.children[0].to_text()
            return f"({inner})*"
        raise ValueError(self.op)

    @property
    def qhash(self) -> str:
        """Unique query label (paper §4: 'hashes of the expressions')."""
        return hashlib.sha1(self.to_text().encode()).hexdigest()[:12]

    def __repr__(self) -> str:  # pragma: no cover
        return f"RPQ({self.to_text()})"


def label(symbol: str) -> RPQ:
    return RPQ("label", symbol=symbol)


def concat(*qs: RPQ) -> RPQ:
    flat: List[RPQ] = []
    for q in qs:
        flat.extend(q.children if q.op == "concat" else (q,))
    return RPQ("concat", tuple(flat))


def union(*qs: RPQ) -> RPQ:
    flat: List[RPQ] = []
    for q in qs:
        flat.extend(q.children if q.op == "union" else (q,))
    return RPQ("union", tuple(flat))


def star(q: RPQ) -> RPQ:
    return RPQ("star", (q,))


# ---------------------------------------------------------------------------
# Parser  (tokens: identifiers, '.', '|', '+', '*', parentheses)
# ---------------------------------------------------------------------------


def parse_rpq(text: str) -> RPQ:
    """Parse an RPQ expression, e.g. ``"Artist.Credit.(Track|Recording)"``
    or ``"Entity.(Entity)*.Activity"`` (paper's MQ/PQ notation; the middle
    dot ``·`` is accepted as ``.``)."""
    toks = _tokenize(text)
    pos = [0]

    def peek() -> str:
        return toks[pos[0]] if pos[0] < len(toks) else ""

    def eat(tok: str = "") -> str:
        cur = peek()
        if tok and cur != tok:
            raise ValueError(f"expected {tok!r}, got {cur!r} in {text!r}")
        pos[0] += 1
        return cur

    def parse_union() -> RPQ:
        terms = [parse_concat()]
        while peek() in ("|", "+"):
            eat()
            terms.append(parse_concat())
        return terms[0] if len(terms) == 1 else union(*terms)

    def parse_concat() -> RPQ:
        factors = [parse_postfix()]
        while True:
            if peek() == ".":
                eat()
                factors.append(parse_postfix())
            elif peek() and peek() not in (")", "|", "+"):
                factors.append(parse_postfix())
            else:
                break
        return factors[0] if len(factors) == 1 else concat(*factors)

    def parse_postfix() -> RPQ:
        node = parse_atom()
        while peek() == "*":
            eat()
            node = star(node)
        return node

    def parse_atom() -> RPQ:
        if peek() == "(":
            eat("(")
            node = parse_union()
            eat(")")
            return node
        tok = eat()
        if not tok or not (tok[0].isalpha() or tok[0] == "_"):
            raise ValueError(f"unexpected token {tok!r} in {text!r}")
        return label(tok)

    node = parse_union()
    if pos[0] != len(toks):
        raise ValueError(f"trailing tokens in {text!r}")
    return node


def _tokenize(text: str) -> List[str]:
    text = text.replace("·", ".")  # middle dot
    toks: List[str] = []
    i = 0
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
