"""The port's schema-constrained generators against the JAX package's:
``schema_graph``, ``musicbrainz_like`` and ``provgen_like`` bitwise (labels,
``src``, ``dst``, ``row_ptr``).  The port indexes each (label, layer,
community) cell by one stable sort of the class's community column where
the reference scans the column once per community; the random draws and
their order are the same, so the graphs are too."""
import numpy as np
import pytest

from repro.graphs import generators as R

from repro_torch.graphs import generators as T

ARRAYS = ("labels", "src", "dst", "row_ptr")


def _same(a, b):
    assert (a.n, a.m) == (b.n, b.m)
    assert a.label_names == b.label_names
    for name in ARRAYS:
        assert np.array_equal(getattr(a, name), getattr(b, name)), name


# n // 250 < 8 (the default's floor of 8 communities) for the small n;
# 1,999 and 20,011 leave uneven stripes
@pytest.mark.parametrize("n", [40, 500, 1999, 4000, 20_011])
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("fn", ["musicbrainz_like", "provgen_like"])
def test_dataset_generators_bitwise(fn, n, seed):
    _same(getattr(T, fn)(n, seed=seed), getattr(R, fn)(n, seed=seed))


@pytest.mark.parametrize("avg_degree", [2.0, 9.5])
def test_musicbrainz_avg_degree_bitwise(avg_degree):
    _same(T.musicbrainz_like(6000, avg_degree=avg_degree, seed=3),
          R.musicbrainz_like(6000, avg_degree=avg_degree, seed=3))


# n_communities given: fewer cells than a class has vertices, more (empty
# cells for the small classes), and one; p_intra from all-global to
# all-intra
@pytest.mark.parametrize("n_communities", [None, 1, 5, 64, 3000])
@pytest.mark.parametrize("p_intra", [0.0, 0.5, 0.9, 1.0])
@pytest.mark.parametrize("seed", [1, 2])
def test_schema_graph_bitwise(n_communities, p_intra, seed):
    kw = dict(avg_degree=5.0, skew=1.3, seed=seed, n_communities=n_communities,
              p_intra=p_intra)
    args = (3000, T.MUSICBRAINZ_LABELS, T._MB_PROPS, T._MB_SCHEMA)
    _same(T.schema_graph(*args, **kw), R.schema_graph(*args, **kw))


def test_schema_graph_three_layers_bitwise():
    """A schema with three community layers, one a self-loop type."""
    schema = [("A", "B", 2.0, 0), ("B", "C", 1.0, 1), ("C", "C", 1.0, 2),
              ("A", "A", 0.5)]
    args = (2500, ["A", "B", "C"], [0.5, 0.3, 0.2], schema)
    _same(T.schema_graph(*args, seed=4, n_communities=12),
          R.schema_graph(*args, seed=4, n_communities=12))
