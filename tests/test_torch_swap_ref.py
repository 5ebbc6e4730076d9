"""The port's seed swap (``core/swap_ref.py``) against the reference's.

Twin of ``tests/test_swap_parity.py``'s swap cases: on one field, the
port's ``swap_iteration_reference`` gives the reference's partition and
stats bitwise, and so does the port's frontier-batched ``swap_iteration``,
over random labelled graphs, both ``ext_to`` modes, chained iterations and
a non-default configuration."""
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.core.swap import SwapConfig as RSwapConfig
from repro.core.swap_ref import swap_iteration_reference as r_swap_ref
from repro.core.visitor import ExtroversionResult as RField
from repro.graphs.generators import musicbrainz_like as r_musicbrainz_like
from repro.graphs.generators import provgen_like as r_provgen_like

from repro_torch.core.rpq import parse_rpq
from repro_torch.core.swap import SwapConfig, swap_iteration
from repro_torch.core.swap_ref import swap_iteration_reference
from repro_torch.core.tpstry import TPSTry
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.generators import musicbrainz_like, provgen_like
from repro_torch.graphs.partition import hash_partition

CASES = [
    # (seed, generator, queries, k): tests/test_swap_parity.py's
    (7, "provgen", ["Entity.Entity.Entity", "Agent.Activity.Entity"], 4),
    (3, "musicbrainz", ["Area.Artist.(Artist|Label).Area"], 8),
    (11, "provgen", ["Entity.Activity.Agent", "Entity.(Entity)*.Entity"], 3),
]
GENS = {"provgen": (provgen_like, r_provgen_like),
        "musicbrainz": (musicbrainz_like, r_musicbrainz_like)}


def _setup(seed, gen, queries, k, n=1200):
    port_gen, ref_gen = GENS[gen]
    g, rg = port_gen(n, seed=seed), ref_gen(n, seed=seed)
    w = [(parse_rpq(q), 1.0 / len(queries)) for q in queries]
    arrays = TPSTry.from_workload(w).compile(g.label_names)
    return g, rg, arrays, hash_partition(g.n, k, seed=seed)


def _ref_field(f):
    """The port's field as the reference's dataclass (same numpy arrays)."""
    return RField(**{fl.name: getattr(f, fl.name)
                     for fl in dataclasses.fields(RField)})


def _three(g, rg, part, fld, k, cfg, rcfg):
    """Partitions and stats of the three swaps on one field."""
    p_ref, s_ref = r_swap_ref(rg, part, _ref_field(fld), k, rcfg,
                              np.random.default_rng(0))
    p_old, s_old = swap_iteration_reference(g, part, fld, k, cfg,
                                            np.random.default_rng(0))
    p_new, s_new = swap_iteration(g, part, fld, k, cfg,
                                  np.random.default_rng(0))
    assert np.array_equal(p_old, p_ref) and p_old.dtype == p_ref.dtype
    assert dataclasses.asdict(s_old) == dataclasses.asdict(s_ref)
    assert np.array_equal(p_new, p_old)
    assert s_new == s_old
    return p_old, s_old


@pytest.mark.parametrize("case", CASES, ids=[f"seed{c[0]}" for c in CASES])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "two-phase"])
def test_seed_swap_bitwise_the_reference_and_the_batched_swap(case, dense):
    seed, gen, queries, k = case
    g, rg, arrays, part = _setup(seed, gen, queries, k)
    # chain three iterations so later ones start from swapped state
    for _ in range(3):
        fld = extroversion_field(g, arrays, part, k, dense_ext_to=dense,
                                 backend="torch", device="cpu")
        p, s = _three(g, rg, part, fld, k, SwapConfig(), RSwapConfig())
        if s.moves == 0:
            break
        part = p


def test_seed_swap_nondefault_config():
    """Capped queues, tighter balance, small families, mass ranking."""
    g, rg, arrays, part = _setup(5, "provgen", ["Entity.Activity.Agent"], 5)
    fld = extroversion_field(g, arrays, part, 5, dense_ext_to=True,
                             backend="torch", device="cpu")
    kw = dict(candidates_per_part=40, balance_eps=0.02, family_max_size=4,
              min_gain=1e-6, rank_by="mass", max_scan_neighbors=8)
    _, s = _three(g, rg, part, fld, 5, SwapConfig(**kw), RSwapConfig(**kw))
    assert s.moves > 0
