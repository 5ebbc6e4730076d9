"""Cell plans in the port against the JAX package's (``tests/test_cell_plans.py``'s
twins): the same 37 (arch, shape) cells in the same order, every plan's
``meta`` equal float for float, every argument leaf's shape and type
equal to the reference's ``ShapeDtypeStruct`` in tree order, and every in-
and out-sharding spec equal to the reference's ``PartitionSpec`` on the
smoke mesh.  Then the TAPER cell's step, a function of the eight arrays,
bitwise the port's ``_field`` on the CPU at the ``reduced()`` size, with
both field backends (``cuda``'s ``vm_step`` runs its plain version on CPU
tensors)."""
import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.launch.mesh import make_smoke_mesh as r_make_smoke_mesh
from repro.launch.specs import all_cells as r_all_cells
from repro.launch.specs import build_cell as r_build_cell

from repro_torch.configs.base import ShapeSpec
from repro_torch.configs.registry import get_config
from repro_torch.core.rpq import parse_rpq
from repro_torch.core.tpstry import TPSTry, synthetic_trie
from repro_torch.core.visitor import _field, field_from_arrays
from repro_torch.distributed.sharding import rules_for
from repro_torch.graphs.generators import musicbrainz_like
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_smoke_mesh
from repro_torch.launch.specs import all_cells, build_cell
from repro_torch.utils import tree

#: MQ1-3, the musicbrainz workload (its field is not 0 past depth 1)
MQ = [("Area.Artist.(Artist|Label).Area", 0.2),
      ("Artist.Credit.(Track|Recording).Credit.Artist", 0.3),
      ("Artist.Credit.Track.Medium", 0.5)]


@pytest.fixture(scope="module")
def meshes():
    return r_make_smoke_mesh(), make_smoke_mesh(device="cpu")


def test_all_cells_equal_reference():
    cells = all_cells()
    assert cells == r_all_cells()
    assert len(cells) == 37
    assert ("gemma3-4b", "long_500k") in cells
    for arch in ("qwen2.5-14b", "qwen3-4b", "olmoe-1b-7b", "kimi-k2-1t-a32b"):
        assert (arch, "long_500k") not in cells


def _specs(shardings, jax_side: bool):
    if jax_side:
        leaves = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    else:
        leaves = tree.leaves(shardings)
    return [tuple(s.spec) for s in leaves]


@pytest.mark.parametrize("arch,shape", all_cells())
def test_build_cell_equals_reference(arch, shape, meshes):
    r_mesh, mesh = meshes
    ref, plan = r_build_cell(arch, shape, r_mesh), build_cell(arch, shape, mesh)
    assert plan.step_fn is not None and plan.step_name == ref.step_name
    assert plan.meta == ref.meta and plan.meta["model_flops"] > 0
    r_args, args = jax.tree.leaves(ref.args), tree.leaves(plan.args)
    assert all(a.device.type == "meta" for a in args)
    assert [(tuple(a.shape), str(a.dtype)) for a in r_args] == \
        [(tuple(a.shape), str(a.dtype).replace("torch.", "")) for a in args]
    assert _specs(plan.in_shardings, False) == _specs(ref.in_shardings, True)
    assert _specs(plan.out_shardings, False) == _specs(ref.out_shardings, True)
    assert plan.rules == rules_for(mesh) and plan.mesh is mesh


def _graph_arrays(g, part, trie):
    t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(dt)  # noqa: E731
    return (t(g.src, torch.int32), t(g.dst, torch.int32), t(g.labels, torch.int32),
            t(g.neighbor_label_counts(), torch.int32), t(g.label_counts(), torch.int32),
            t(part, torch.int32), t(trie.p, torch.float32), t(trie.cond_p, torch.float32))


def _block_start(labels: np.ndarray, k: int) -> np.ndarray:
    count = np.bincount(labels)
    first = np.concatenate([[0], np.cumsum(count)[:-1]])
    rank = np.arange(labels.size) - first[labels]
    return ((rank * k) // count[labels]).astype(np.int32)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("workload", ["synthetic", "mq"])
def test_taper_step_bitwise_field(backend, workload):
    """The cell's step (``specs._taper_cell``'s ``refine``, at the reduced
    config's n = 2,000 and k = 8 over the graph's own edge count) and
    ``field_from_arrays`` equal ``_field`` bit for bit; edges given in
    another order give the same alpha; ``dense_ext_to`` gives ``_field``'s
    ``ext_to`` too."""
    cfg = get_config("taper_paper").reduced()
    g = musicbrainz_like(cfg.n_vertices, seed=0)
    if workload == "synthetic":
        trie = synthetic_trie(cfg.n_labels, cfg.trie_depth, branching=2)
    else:
        trie = TPSTry.from_workload([(parse_rpq(q), f) for q, f in MQ]).compile(g.label_names)
    part = _block_start(np.asarray(g.labels), cfg.k_partitions)
    ref = _field(g, trie, part, cfg.k_partitions, trie.max_depth, {}, False, backend,
                 torch.device("cpu"))
    arrays = _graph_arrays(g, part, trie)
    shape = ShapeSpec("refine_step", "taper", (("n_vertices", g.n), ("n_edges", g.m)))
    mesh = specs.axis_mesh(data=1, model=1)
    plan = specs._taper_cell(cfg, shape, mesh, rules_for(mesh), backend=backend)
    if workload == "synthetic":
        got = plan.step_fn(*arrays)
    else:
        got = field_from_arrays(trie, cfg.k_partitions, *arrays, n=g.n, m=g.m,
                                backend=backend, dense_ext_to=True)
        ref_ext = _field(g, trie, part, cfg.k_partitions, trie.max_depth, {}, True, backend,
                         torch.device("cpu"))[5]
        assert torch.equal(got[5], ref_ext)
    for name, a, b in zip(("alpha", "pr", "mass", "extro_mass", "extroversion"), got, ref):
        assert torch.equal(a, b), name
    if workload == "mq":
        assert float(ref[0][:, trie.depth >= 2].abs().sum()) > 0
        perm = torch.from_numpy(np.random.default_rng(0).permutation(g.m))
        shuffled = (arrays[0][perm], arrays[1][perm]) + arrays[2:]
        alt = field_from_arrays(trie, cfg.k_partitions, *shuffled, n=g.n, m=g.m,
                                backend=backend)
        # another edge order sums each row in another order: within float32 rounding
        assert torch.allclose(alt[0], ref[0], rtol=1e-5, atol=0)
        assert torch.allclose(alt[2], ref[2][perm], rtol=1e-5, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
@pytest.mark.parametrize("order", ["sorted", "shuffled"])
def test_field_from_arrays_equals_reference_build_field_fn(backend, order):
    """``field_from_arrays`` against its twin, the JAX package's
    ``_build_field_fn`` (the fused field its cell plan runs), on the same
    eight arrays: musicbrainz at the reduced config's 2,000 vertices, MQ1-3's
    trie (the reference's, carried over by ``from_reference_arrays``), the
    graph's own (source-sorted) edge order or a seeded shuffle of it.  Both
    sum each vertex's terms in edge order, so every output, ``ext_to``
    included, is bitwise the reference's in either order."""
    from repro.core.rpq import parse_rpq as r_parse
    from repro.core.tpstry import TPSTry as RTPSTry
    from repro.core.visitor import _build_field_fn

    from repro_torch.convert import TRIE_FIELDS, from_reference_arrays

    cfg = get_config("taper_paper").reduced()
    g, k = musicbrainz_like(cfg.n_vertices, seed=0), cfg.k_partitions
    r_trie = RTPSTry.from_workload([(r_parse(q), f) for q, f in MQ]).compile(g.label_names)
    trie = from_reference_arrays(trie={f: getattr(r_trie, f) for f in TRIE_FIELDS}).trie
    part = _block_start(np.asarray(g.labels), k)
    arrays = list(_graph_arrays(g, part, trie))
    if order == "shuffled":
        perm = torch.from_numpy(np.random.default_rng(3).permutation(g.m))
        arrays[:2] = [a[perm] for a in arrays[:2]]
    fn = _build_field_fn(None, r_trie, k, r_trie.max_depth, fused=True, dense_ext_to=True)
    want = fn(*(a.numpy() for a in arrays), n=g.n, m=g.m)
    got = field_from_arrays(trie, k, *arrays, n=g.n, m=g.m, backend=backend,
                            dense_ext_to=True)
    names = ("alpha", "pr", "mass", "extro_mass", "extroversion", "ext_to")
    assert len(got) == len(want) == len(names)
    for name, a, b in zip(names, got, want):
        assert a.shape == b.shape and np.array_equal(a.numpy(), np.asarray(b)), name
    assert float(got[0][:, trie.depth >= 2].abs().sum()) > 0
