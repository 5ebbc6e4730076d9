"""The port's logical-axis sharding rules, meshes and elastic resharding
against the JAX package's: ``LogicalAxisRules.spec`` equal to the
reference's ``PartitionSpec`` (as a tuple) over both rule sets, a sweep of
logical-axis tuples and shapes, on (16, 16) and (2, 16, 16) meshes (a stub
with a ``shape`` dict serves both packages); ``param_logical_axes`` and
``cache_logical_axes`` equal to the reference's; the placements a spec
gives; and a twin of ``tests/test_trainer.py::test_elastic_reshard_roundtrip``
on one in-process gloo rank, then on two spawned ranks."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.configs.registry import get_config as r_get_config
from repro.distributed import sharding as r_sh
from repro.launch.mesh import make_smoke_mesh as r_make_smoke_mesh
from repro.models import transformer as r_tf
from repro.train.checkpoint import CheckpointManager as RCheckpointManager
from repro.train.elastic import plan_reshard as r_plan_reshard

from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as sh
from repro_torch.launch.mesh import (chips_in, make_production_mesh, make_smoke_mesh,
                                     run_ranks)
from repro_torch.models import transformer as tf
from repro_torch.train.checkpoint import CheckpointManager
from repro_torch.train.elastic import plan_reshard, reshard_restore
from repro_torch.utils import tree


class StubMesh:
    """A mesh's axis sizes alone: ``shape`` (dict) and ``axis_names``."""

    def __init__(self, **sizes):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)


MESHES = {"pod": StubMesh(data=16, model=16),
          "multi_pod": StubMesh(pod=2, data=16, model=16)}
NAMES = [None, "batch", "fsdp", "model", "experts", "vocab", "heads", "kv_heads",
         "ffn", "kv_seq", "nodes", "edges", "rows", "candidates", "feat_model",
         "unknown"]
DIMS = [1, 2, 3, 8, 16, 24, 32, 48, 256, 512, 4096, 151936]


def _axes_sweep(rank, count, seed):
    rng = np.random.default_rng(seed)
    return [tuple(NAMES[i] for i in rng.integers(0, len(NAMES), rank))
            for _ in range(count)]


# the multi-pod rules name the pod axis, so they resolve on the 3-D mesh only
@pytest.mark.parametrize("rules,mesh", [("SINGLE_POD_RULES", "pod"),
                                        ("SINGLE_POD_RULES", "multi_pod"),
                                        ("MULTI_POD_RULES", "multi_pod")])
@pytest.mark.parametrize("rank", [0, 1, 2, 3, 4, 5])
def test_spec_equals_reference(rules, mesh, rank):
    ours, ref, m = getattr(sh, rules), getattr(r_sh, rules), MESHES[mesh]
    rng = np.random.default_rng(rank)
    for axes in _axes_sweep(rank, 60, seed=10 + rank):
        assert ours.spec(axes) == tuple(ref.spec(axes)), axes
        for _ in range(4):
            shape = tuple(int(d) for d in rng.choice(DIMS, rank))
            assert ours.spec(axes, shape, m) == tuple(ref.spec(axes, shape, m)), \
                (axes, shape)


def test_spec_cases_and_rules_for():
    m, mm = MESHES["pod"], MESHES["multi_pod"]
    assert sh.rules_for(m) is sh.SINGLE_POD_RULES and r_sh.rules_for(m) is r_sh.SINGLE_POD_RULES
    assert sh.rules_for(mm) is sh.MULTI_POD_RULES and r_sh.rules_for(mm) is r_sh.MULTI_POD_RULES
    assert sh.SINGLE_POD_RULES.rules == r_sh.SINGLE_POD_RULES.rules
    assert sh.MULTI_POD_RULES.rules == r_sh.MULTI_POD_RULES.rules
    rules = sh.SINGLE_POD_RULES
    # the divisibility fallback drops trailing axes; a mesh axis is used once
    assert rules.spec(("kv_seq",), (256,), m) == (("data", "model"),)
    assert rules.spec(("kv_seq",), (48,), m) == ("data",)
    assert rules.spec(("batch", "kv_seq"), (32, 4096), m) == ("data", "model")
    assert rules.spec((None, "kv_heads"), (4, 8), m) == ()
    assert sh.MULTI_POD_RULES.spec(("batch",), (64,), mm) == (("pod", "data"),)
    assert rules.lookup(None) is None and rules.lookup("unknown") is None


@pytest.mark.parametrize("arch", ["qwen3-4b", "qwen2.5-14b", "gemma3-4b", "olmoe-1b-7b",
                                  "kimi-k2-1t-a32b"])
@pytest.mark.parametrize("long_context", [False, True])
def test_logical_axes_equal_reference(arch, long_context):
    cfg, r_cfg = get_config(arch).reduced(), r_get_config(arch).reduced()
    assert tf.cache_logical_axes(cfg, long_context) == \
        r_tf.cache_logical_axes(r_cfg, long_context)
    _, r_logical = r_tf.init(jax.random.PRNGKey(0), r_cfg)
    assert tf.param_logical_axes(cfg) == r_logical
    # the logical tree has the parameters' structure, a name a dimension
    params = tf.init(cfg.reduced_for_port(), seed=0, device="cpu")
    shardings = sh.tree_shardings(MESHES["pod"], tf.param_logical_axes(cfg), params)
    for path, leaf in zip(*tree.flatten_with_paths(params)):
        node = shardings
        for key in path.strip("[]").split("']/['"):
            node = node[key.strip("'")]
        assert len(node.spec) <= leaf.dim(), path


@pytest.mark.parametrize("mesh", list(MESHES))
def test_placements_follow_the_spec(mesh):
    from torch.distributed.tensor import Replicate, Shard

    m = MESHES[mesh]
    shardings = sh.tree_shardings(
        m, {"x": ("batch", None, "heads"), "c": {"k": (None, "batch", "kv_seq", None)},
            "pos": ()},
        {"x": torch.empty(64, 3, 32), "c": {"k": torch.empty(2, 32, 4096, 8)}, "pos": 0})
    x, k, pos = shardings["x"], shardings["c"]["k"], shardings["pos"]
    if mesh == "pod":
        assert x.spec == ("data", None, "model")
        assert x.placements == (Shard(0), Shard(2))
        assert k.spec == (None, "data", "model") and k.placements == (Shard(1), Shard(2))
    else:
        assert x.spec == (("pod", "data"), None, "model")
        assert x.placements == (Shard(0), Shard(0), Shard(2))
        assert k.spec == (None, ("pod", "data"), "model")
        assert k.placements == (Shard(1), Shard(1), Shard(2))
    assert pos.spec == () and all(p == Replicate() for p in pos.placements)
    # the same leaves without shapes: no divisibility fallback
    assert sh.logical_to_sharding(m, ("heads",)).spec == ("model",)


def test_meshes_and_constrain():
    mesh = make_smoke_mesh(device="cpu")
    assert mesh.mesh_dim_names == ("data", "model") and chips_in(mesh) == 1
    assert chips_in(mesh) == int(r_make_smoke_mesh().devices.size)
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    x = torch.arange(24.0).reshape(4, 6)
    assert sh.constrain(x, "batch", "model") is x           # no context: no-op
    with sh.activation_sharding(mesh):
        y = sh.constrain(x, "batch", "model")
    assert torch.equal(y.full_tensor(), x) and sh.constrain(x, "batch") is x


def _reference_plan():
    r_cfg = dataclasses.replace(r_get_config("qwen3-4b").reduced(), d_head=32)
    r_params, r_logical = r_tf.init(jax.random.PRNGKey(0), r_cfg)
    mesh = r_make_smoke_mesh()
    return r_params, r_logical, mesh, r_plan_reshard(r_params, r_logical, mesh, mesh)


def test_elastic_reshard_roundtrip(tmp_path):
    """tests/test_trainer.py's twin: a checkpoint of reduced qwen3-4b's
    parameters restored onto a 1 x 1 gloo mesh bit for bit, and the plan's
    dict the reference's for the same shapes and dtypes."""
    cfg = get_config("qwen3-4b").reduced_for_port()
    params = tf.init(cfg, seed=0, device="cpu")
    logical = tf.param_logical_axes(cfg)
    mgr = CheckpointManager(tmp_path / "ck")
    mgr.save(1, {"params": params})

    mesh = make_smoke_mesh(device="cpu")
    restored = reshard_restore(mgr, {"params": params}, {"params": logical}, mesh)
    got, want = tree.leaves(restored["params"]), tree.leaves(params)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.full_tensor().dtype == b.dtype and torch.equal(a.full_tensor(), b)

    plan = plan_reshard(params, logical, mesh, mesh)
    assert plan["total_state_bytes"] > 0
    assert plan["bytes_per_new_chip"] == plan["total_state_bytes"] / chips_in(mesh)
    r_params, r_logical, r_mesh, r_plan = _reference_plan()
    assert plan == r_plan
    # the reference's checkpoint of the same shapes restores in the port too
    r_mgr = RCheckpointManager(tmp_path / "r_ck")
    r_mgr.save(1, {"params": r_params})
    r_restored = reshard_restore(CheckpointManager(tmp_path / "r_ck"), {"params": params},
                                 {"params": logical}, mesh)
    for a, b in zip(tree.leaves(r_restored["params"]),
                    jax.tree.leaves(r_params)):
        assert np.array_equal(a.full_tensor().float().numpy(),
                              np.asarray(b).astype(np.float32))


def _rank_reshard(rank, n_ranks, ckpt_dir):
    """A rank of a 1 x n mesh: restore the checkpoint sharded, return each
    leaf's local shard, full tensor and placements."""
    cfg = get_config("qwen3-4b").reduced_for_port()
    like = tf.init(cfg, seed=1, device="cpu")
    mesh = make_smoke_mesh(device="cpu")
    out = reshard_restore(CheckpointManager(ckpt_dir), {"params": like},
                          {"params": tf.param_logical_axes(cfg)}, mesh)
    return [(tuple((type(p).__name__, getattr(p, "dim", None)) for p in t.placements),
             t.to_local().clone(), t.full_tensor())
            for t in tree.leaves(out["params"])]


def test_elastic_reshard_two_ranks(tmp_path):
    """Resharded onto a 1 x 2 mesh: the ``model``-axis leaves split in
    halves between the ranks, every leaf's full tensor the saved one."""
    cfg = get_config("qwen3-4b").reduced_for_port()
    params = tf.init(cfg, seed=0, device="cpu")
    CheckpointManager(tmp_path / "ck").save(3, {"params": params})
    ranks = run_ranks(_rank_reshard, 2, tmp_path / "store", args=(str(tmp_path / "ck"),))
    want = tree.leaves(params)
    split = 0
    for i, w in enumerate(want):
        (p0, l0, f0), (p1, l1, f1) = ranks[0][i], ranks[1][i]
        assert p0 == p1 and torch.equal(f0, w) and torch.equal(f1, w)
        if p0[1][0] == "Shard":             # the model axis: two halves
            split += 1
            assert torch.equal(torch.cat([l0, l1], dim=p0[1][1]), w)
        else:
            assert torch.equal(l0, w) and torch.equal(l1, w)
    assert split >= 5


def test_slice_imports_without_jax_or_reference():
    """The modules of the paper's-cell slice load neither JAX nor the
    reference package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    src = Path(__file__).resolve().parents[1] / "src"
    probe = ("import sys, repro_torch.distributed.sharding, repro_torch.train.elastic, "
             "repro_torch.launch.serve, repro_torch.launch.mesh, "
             "repro_torch.configs.taper_paper, repro_torch.graphs.generators; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=str(src)))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
