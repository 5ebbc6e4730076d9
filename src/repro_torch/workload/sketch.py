"""Query-frequency tracking over a sliding window (paper §5.3: "frequencies
are approximated using a sketch datastructure which samples the occurrences
of each query within a sliding window of time t").

We use an exponential-decay counter — O(#distinct queries) space — with
*lazy* timestamp-based decay: ``observe`` touches only the observed query's
counter (O(1)); every counter remembers the tick it was last updated at and
the pending decay ``d^(now - then)`` is applied when the counter is next
touched or read.  This matches the eager formulation (decay every counter on
every observation) exactly up to float rounding, without the
O(#distinct-queries) scan per observation the eager version needs.

``observe_batch`` advances the clock once for the whole batch: a batch is
one time step of the sliding window, so its queries land with equal weight
and the decay horizon is measured in batches (the online driver's tick)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable

from repro_torch.core.rpq import RPQ


@dataclass
class FrequencySketch:
    """Exponentially decayed query counts -> relative frequencies."""

    half_life: float = 100.0           # ticks until weight halves
    counts: Dict[str, float] = field(default_factory=dict)
    queries: Dict[str, RPQ] = field(default_factory=dict)
    _ticks: int = 0
    _stamp: Dict[str, int] = field(default_factory=dict)

    @property
    def decay(self) -> float:
        return 0.5 ** (1.0 / self.half_life)

    def _bump(self, qh: str, q: RPQ, weight: float) -> None:
        """Bring one counter up to the current tick, then add ``weight``."""
        prev = self.counts.get(qh, 0.0)
        if prev:
            # .get: counts seeded through the dataclass init carry stamp 0
            prev *= self.decay ** (self._ticks - self._stamp.get(qh, 0))
        self.counts[qh] = prev + weight
        self._stamp[qh] = self._ticks
        self.queries[qh] = q

    def observe(self, q: RPQ, weight: float = 1.0) -> None:
        """O(1): advance the clock one tick and credit ``q``; other counters
        decay lazily (their pending ``d^dt`` is applied on next touch/read)."""
        self._ticks += 1
        self._bump(q.qhash, q, weight)

    def observe_batch(self, batch: Iterable[RPQ]) -> None:
        """Credit a whole batch under a *single* decay tick (one batch = one
        time step of the sliding window), touching each distinct query once."""
        weights: Dict[str, float] = {}
        qs: Dict[str, RPQ] = {}
        for q in batch:
            qh = q.qhash
            weights[qh] = weights.get(qh, 0.0) + 1.0
            qs[qh] = q
        if not weights:
            return
        self._ticks += 1
        for qh, w in weights.items():
            self._bump(qh, qs[qh], w)

    def _decayed(self) -> Dict[str, float]:
        d, now = self.decay, self._ticks
        return {
            k: v * d ** (now - self._stamp.get(k, 0))
            for k, v in self.counts.items()
        }

    def frequencies(self, min_freq: float = 1e-4) -> Dict[str, float]:
        vals = self._decayed()
        total = sum(vals.values())
        if total <= 0:
            return {}
        out = {k: v / total for k, v in vals.items()}
        return {k: (v if v >= min_freq else 0.0) for k, v in out.items()}

    def workload(self, min_freq: float = 1e-4):
        """[(RPQ, freq)] snapshot for TAPER invocation."""
        freqs = self.frequencies(min_freq)
        return [(self.queries[k], f) for k, f in freqs.items() if f > 0]

    # -- persistence ---------------------------------------------------------
    def state_dict(self) -> Dict:
        """JSON-serializable state: counters plus the query expressions as
        text (``parse_rpq(to_text(q))`` round-trips the AST, and ``qhash``
        is derived from the text, so keys survive the round trip)."""
        order = list(self.counts)
        return {
            "half_life": self.half_life,
            "ticks": self._ticks,
            "qhashes": order,
            "counts": [self.counts[k] for k in order],
            "stamps": [int(self._stamp.get(k, 0)) for k in order],
            "queries": [self.queries[k].to_text() for k in order],
        }

    @classmethod
    def from_state(cls, state: Dict) -> "FrequencySketch":
        from repro_torch.core.rpq import parse_rpq

        sk = cls(half_life=float(state["half_life"]))
        sk._ticks = int(state["ticks"])
        for qh, c, st, text in zip(state["qhashes"], state["counts"],
                                   state["stamps"], state["queries"]):
            sk.counts[qh] = float(c)
            sk._stamp[qh] = int(st)
            sk.queries[qh] = parse_rpq(text)
        return sk
