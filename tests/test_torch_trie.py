"""Port parity (bitwise) of the workload layer: RPQ expansion and the
compiled TPSTry arrays.  Trie numbering follows the process's string-hash
seed, so both packages are compared in one process."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.rpq import parse_rpq as r_parse
from repro.core.tpstry import TPSTry as RTPSTry
from repro.graphs.generators import MUSICBRAINZ_LABELS, PROV_LABELS

from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry

PAPER = (["a.(b|c).(c|d)", "(c|a).c.a"], (0.5, 0.5), ["a", "b", "c", "d"])
MQ = (["Area.Artist.(Artist|Label).Area",
       "Artist.Credit.(Track|Recording).Credit.Artist",
       "Artist.Credit.Track.Medium"], (0.2, 0.3, 0.5), MUSICBRAINZ_LABELS)
PQ = (["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
       "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"],
      (0.4, 0.2, 0.2, 0.2), PROV_LABELS)
FIELDS = ("parent", "label", "depth", "p", "cond_p", "child_index", "is_leaf")


def _same_arrays(a, b):
    for f in FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        assert x.dtype == y.dtype and np.array_equal(x, y), f
    assert a.n_labels == b.n_labels
    assert a.topology_signature() == b.topology_signature()


@pytest.mark.parametrize("workload", [PAPER, MQ, PQ], ids=["paper", "MQ", "PQ"])
@pytest.mark.parametrize("max_len,star_max", [(None, 3), (6, 2)])
def test_trie_arrays_bitwise(workload, max_len, star_max):
    texts, freqs, names = workload
    pw = [(parse_rpq(t), f) for t, f in zip(texts, freqs)]
    rw = [(r_parse(t), f) for t, f in zip(texts, freqs)]
    for (pq, _), (rq, _) in zip(pw, rw):
        assert pq.qhash == rq.qhash and pq.to_text() == rq.to_text()
        # same frozenset, iterated in the same order
        assert list(pq.strings(6)) == list(rq.strings(6))
    pt = TPSTry.from_workload(pw, max_len=max_len, star_max=star_max)
    rt = RTPSTry.from_workload(rw, max_len=max_len, star_max=star_max)
    assert [nd.p for nd in pt.nodes] == [nd.p for nd in rt.nodes]
    _same_arrays(pt.compile(names), rt.compile(names))


def test_trie_frequency_drift_bitwise():
    texts, freqs, names = PQ
    pt = TPSTry.from_workload([(parse_rpq(t), f) for t, f in zip(texts, freqs)])
    rt = RTPSTry.from_workload([(r_parse(t), f) for t, f in zip(texts, freqs)])
    drift = {parse_rpq(texts[0]).qhash: 0.7, parse_rpq(texts[2]).qhash: 0.3}
    pt.set_frequencies(drift)
    rt.set_frequencies(drift)
    _same_arrays(pt.compile(names), rt.compile(names))

