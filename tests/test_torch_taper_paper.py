"""The paper's own cell in the port: ``TaperSystemConfig`` / ``taper_paper``
against the JAX package's, and its refine step (one extroversion-field
evaluation over a musicbrainz-like graph, ``synthetic_trie(12, 4,
branching=2)``, ``dense_ext_to=False``) on the CPU bitwise the reference's
``jnp`` field, under a hash start and a label-rank block start.  The
synthetic trie's label pairs are none of musicbrainz's edge types, so its
field is 0 past the depth-1 priors in both packages; the MQ1-3 workload's
trie, as ``chip_smoke.py`` adds it on the card, checks values past them."""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.registry import get_config as r_get_config
from repro.configs.registry import list_archs as r_list_archs
from repro.configs.registry import shapes_for as r_shapes_for
from repro.core.rpq import parse_rpq as r_parse_rpq
from repro.core.tpstry import TPSTry as RTPSTry
from repro.core.tpstry import synthetic_trie as r_synthetic_trie
from repro.core.visitor import extroversion_field as r_field
from repro.graphs.generators import musicbrainz_like as r_musicbrainz_like

from repro_torch.configs import ArchConfig, TaperSystemConfig
from repro_torch.configs.registry import get_config, list_archs, shapes_for
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry, synthetic_trie
from repro_torch.core.visitor import extroversion_field
from repro_torch.graphs.generators import musicbrainz_like
from repro_torch.graphs.partition import hash_partition

OUTPUTS = ("alpha", "pr", "edge_mass", "extro_mass", "extroversion")
#: MQ1-3 (the musicbrainz workload of chip_smoke.py and the benchmarks)
MQ = [("Area.Artist.(Artist|Label).Area", 0.2),
      ("Artist.Credit.(Track|Recording).Credit.Artist", 0.3),
      ("Artist.Credit.Track.Medium", 0.5)]


def block_start(labels: np.ndarray, k: int) -> np.ndarray:
    """Each vertex's rank within its label class, cut into k blocks: the
    generator stripes each class over its communities in id order, so the
    blocks keep layer-0 communities together (``chip_smoke.py``'s start)."""
    count = np.bincount(labels)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    rank = np.arange(labels.size) - first[labels]
    return ((rank * k) // count[labels]).astype(np.int32)


def test_taper_paper_arch_registered():
    cfg = get_config("taper_paper")
    assert cfg.family == "taper"
    red = cfg.reduced()
    assert red.n_vertices == 2000
    assert isinstance(cfg, TaperSystemConfig) and isinstance(cfg, ArchConfig)


def test_all_archs_listed():
    assert len(list_archs()) == 11  # 10 assigned + taper_paper
    assert list_archs() == r_list_archs()
    for arch in list_archs():
        cfg = get_config(arch)
        assert cfg.name.replace(".", "") or True
        assert len(shapes_for(arch)) >= 1


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
def test_taper_paper_config_equals_reference(reduced):
    cfg, r_cfg = get_config("taper_paper"), r_get_config("taper_paper")
    if reduced:
        cfg, r_cfg = cfg.reduced(), r_cfg.reduced()
    fields = ("name", "n_vertices", "avg_degree", "n_labels", "n_trie_nodes",
              "trie_depth", "k_partitions", "family")
    assert {f: getattr(cfg, f) for f in fields} == {f: getattr(r_cfg, f) for f in fields}
    assert [(s.name, s.kind, s.dims) for s in cfg.shapes] == \
        [(s.name, s.kind, s.dims) for s in r_cfg.shapes]
    if not reduced:
        assert [(s.name, s.kind, s.dims) for s in shapes_for("taper_paper")] == \
            [(s.name, s.kind, s.dims) for s in r_shapes_for("taper_paper")]
        assert cfg.shapes[0].dim("n_edges") == 60_000_000


def test_synthetic_trie_equals_reference():
    cfg = get_config("taper_paper")
    t = synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2)
    r = r_synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2)
    for name in ("parent", "label", "depth", "p", "cond_p", "child_index", "is_leaf"):
        assert np.array_equal(getattr(t, name), getattr(r, name)), name
    # 1 + 3 + 6 + 12 + 24 nodes: three vm_step launches per field evaluation
    assert t.n_nodes == 46 and t.max_depth == 4


def _tries(kind, cfg, label_names):
    if kind == "synthetic":
        return (synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2),
                r_synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2))
    return (TPSTry.from_workload([(parse_rpq(q), f) for q, f in MQ]).compile(label_names),
            RTPSTry.from_workload([(r_parse_rpq(q), f) for q, f in MQ]).compile(label_names))


@pytest.mark.parametrize("trie_kind", ["synthetic", "mq"])
@pytest.mark.parametrize("start", ["hash", "block"])
@pytest.mark.parametrize("n,k", [(None, None), (20_000, 512)], ids=["reduced", "n20000"])
def test_refine_step_bitwise_equals_jnp(n, k, start, trie_kind):
    cfg = get_config("taper_paper").reduced()
    n, k = n or cfg.n_vertices, k or cfg.k_partitions
    g = musicbrainz_like(n, avg_degree=cfg.avg_degree, seed=5)
    rg = r_musicbrainz_like(n, avg_degree=cfg.avg_degree, seed=5)
    assert np.array_equal(g.src, rg.src) and np.array_equal(g.dst, rg.dst)
    part = hash_partition(n, k, seed=1) if start == "hash" else block_start(g.labels, k)
    assert part.min() == 0 and part.max() == k - 1
    trie, r_trie = _tries(trie_kind, cfg, g.label_names)
    f = extroversion_field(g, trie, part, k, dense_ext_to=False, device="cpu")
    r = r_field(rg, r_trie, part, k, dense_ext_to=False, backend="jnp")
    for name in OUTPUTS:
        assert np.array_equal(getattr(f, name), getattr(r, name)), name
    assert f.ext_to is None and r.ext_to is None
    assert f.total_extroversion == r.total_extroversion
    assert f.alpha.shape == (n, trie.n_nodes) and np.isfinite(f.alpha).all()
    past_priors = np.count_nonzero(f.alpha[:, trie.depth >= 2])
    if trie_kind == "synthetic":
        assert trie.n_nodes == 46 and past_priors == 0 and f.total_extroversion == 0.0
    else:
        assert past_priors > 0 and f.total_extroversion > 0.0
    if start == "block":
        # the block start keeps many more edges local than the hash start
        # (~1/k of them); most where communities (n/250) outnumber blocks
        local = lambda p: float((p[g.src] == p[g.dst]).mean())  # noqa: E731
        assert local(part) > 4 * local(hash_partition(n, k, seed=1))


def _fma_exact(a, b, c):
    """``a * b + c`` rounded once to float32 (ties to even), by exact
    rational arithmetic."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    dist = [abs(Fraction(float(v)) - x) for v in cands]
    best = min(dist)
    ties = [v for v, d in zip(cands, dist) if d == best]
    return min(ties, key=lambda v: int(np.asarray(v).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """``visitor._fma32`` against exact rounding: random operands, and
    products that land exactly halfway between two floats, where a float64
    sum rounded again to float32 goes the wrong way."""
    from repro_torch.core.visitor import _fma32

    rng = np.random.default_rng(3)
    a = (rng.random(2000) * 10.0 ** rng.integers(-8, 2, 2000)).astype(np.float32)
    b = (rng.random(2000) * 10.0 ** rng.integers(-8, 2, 2000)).astype(np.float32)
    c = (rng.random(2000) * 10.0 ** rng.integers(-16, 2, 2000)).astype(np.float32)
    # (1 + 2^-12)^2 = 1 + 2^-11 + 2^-24: a midpoint; c = +-2^-60 breaks the tie
    one = np.float32(1 + 2.0 ** -12)
    a = np.concatenate([a, [one, one, one, np.float32(3 * 2.0 ** -13)]]).astype(np.float32)
    b = np.concatenate([b, [one, one, one, np.float32(1 + 2.0 ** -11)]]).astype(np.float32)
    c = np.concatenate([c, [2.0 ** -60, -(2.0 ** -60), 0.0, 2.0 ** -70]]).astype(np.float32)
    got = _fma32(torch.from_numpy(a), torch.from_numpy(b), torch.from_numpy(c)).numpy()
    want = np.array([_fma_exact(x, y, z) for x, y, z in zip(a, b, c)], np.float32)
    assert np.array_equal(got, want)
    # the tie broken upward; broken downward, and kept (to even: down)
    assert got[-4] > got[-3] == got[-2]
    naive = (a.astype(np.float64) * b + c).astype(np.float32)
    assert not np.array_equal(naive, want)


# depths whose trie nodes share one label, with 2 to 5 nodes whose parents
# share the source's label (several messages on one edge)
SHARED_LABEL = {
    "mq": MQ,
    "four": [("Area.Artist.Credit", .25), ("Place.Artist.Credit", .25),
             ("Genre.Artist.Credit", .25), ("Url.Artist.Credit", .25)],
    "five": [("(Area|Place|Genre|Url|Label).Artist.Credit", 1.0)],
}


@pytest.mark.parametrize("workload", list(SHARED_LABEL))
@pytest.mark.parametrize("backend", ["torch", "cuda-chain"])
def test_shared_label_depth_mass_bitwise_equals_jnp(workload, backend):
    """Where a depth's trie nodes share one label, the reference's CPU
    field adds each message after the first to the edge's mass as a fused
    multiply-add; the port's field (the plain one, and the kernel
    backend's depth chain with the plain ``vm_step``) gives the same bits."""
    from repro_torch.core.visitor import _field

    n, k = 6000, 16
    g, rg = musicbrainz_like(n, seed=2), r_musicbrainz_like(n, seed=2)
    part = block_start(g.labels, k)
    w = SHARED_LABEL[workload]
    trie = TPSTry.from_workload([(parse_rpq(q), f) for q, f in w]).compile(g.label_names)
    r_trie = RTPSTry.from_workload([(r_parse_rpq(q), f) for q, f in w]).compile(g.label_names)
    shared = [d for d in range(2, trie.max_depth + 1)
              if (trie.depth == d).sum() >= 2 and np.unique(trie.label[trie.depth == d]).size == 1]
    assert shared
    r = r_field(rg, r_trie, part, k, dense_ext_to=False, backend="jnp")
    if backend == "torch":
        f = extroversion_field(g, trie, part, k, dense_ext_to=False, device="cpu")
        outs = {name: getattr(f, name) for name in OUTPUTS}
    else:
        out = _field(g, trie, part, k, trie.max_depth, {}, False, "cuda", torch.device("cpu"))
        outs = {name: t.numpy() for name, t in zip(
            ("alpha", "pr", "edge_mass", "extro_mass", "extroversion"), out)}
    for name in OUTPUTS:
        assert np.array_equal(outs[name], getattr(r, name)), name
    assert r.total_extroversion > 0
