"""The port's dry-run on the single-pod production mesh (16 x 16 fake ranks:
``torch.testing._internal.distributed.fake_pg``).  Each run is a
subprocess, so its fake process group never meets another test's group in
an xdist worker: ``python -m repro_torch.launch.dryrun`` over the TAPER
cell, a DLRM cell and a GNN cell, each record ``ok`` with its argument
bytes the local shards' that the plan's placements give; one cell of each
group that DTensor could not run before the MoE mesh route, the decode
attention's per-shard route, the GNNs' per-row blocks and the GCN's
masked gold logit, on the mesh where it failed (the multi-pod one, 2 x 16
x 16, where that was the one); the LM loss on each chip's rows and
vocabulary slice (olmoe-1b-7b train_4k: its temporaries within the
record's bound, and no storage at the peak of the global batch's logits or
of the whole vocabulary's, ``tools/dryrun_peak.py::peak_storages``); and
the collective accounting of one DTensor product, against bytes worked out
by hand."""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch.specs import axis_mesh, build_cell
from repro_torch.utils import tree

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("taper_paper", "refine_step"), ("dlrm-rm2", "serve_p99"), ("gin-tu", "ogb_products")]
#: (arch, shape, mesh): a cell of each repaired group, on the mesh where it failed
REPAIRED = [("olmoe-1b-7b", "train_4k", "single"), ("olmoe-1b-7b", "decode_32k", "single"),
            ("nequip", "molecule", "single"), ("equiformer-v2", "full_graph_sm", "multi"),
            ("gcn-cora", "ogb_products", "multi")]
#: olmoe-1b-7b train_4k on (16, 16): its temporaries before the loss kept
#: each chip's rows and vocabulary slice (260.22 GB), less the whole batch's
#: float32 logits buffer its backward made (210.99 GB)
OLMOE_TRAIN_TEMP_MAX = 49.2e9
PEAK = r"""
import json, sys
sys.path.insert(0, "tools")
from dryrun_peak import peak_storages
from repro_torch.configs.registry import get_config
total, live = peak_storages("olmoe-1b-7b", "train_4k", False)
print(json.dumps({"vocab": get_config("olmoe-1b-7b").vocab, "total": total,
                  "shapes": [list(s[2]) for s in live]}))
"""
MESH_SIZES = {"single": {"data": 16, "model": 16},
              "multi": {"pod": 2, "data": 16, "model": 16}}

PRODUCT = r"""
import json, torch, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.hlo_analysis import CountingMode, collective_bytes
from repro_torch.launch.mesh import make_production_mesh

fake_group(256)
mesh = make_production_mesh(device="cpu")
with FakeTensorMode():
    # x (4096, 2560): rows over data, columns over model; w (2560, 9728):
    # rows over model.  x @ w is partial over model; making it replicated
    # there all-reduces each chip's (256, 9728) float32 block
    x = DTensor.from_local(torch.empty(256, 160), mesh, [Shard(0), Shard(1)],
                           run_check=False, shape=(4096, 2560), stride=(2560, 1))
    w = DTensor.from_local(torch.empty(160, 9728), mesh, [Replicate(), Shard(0)],
                           run_check=False, shape=(2560, 9728), stride=(9728, 1))
    with CountingMode() as c:
        y = (x @ w).redistribute(mesh, [Shard(0), Replicate()])
stats = collective_bytes(c.collectives)
print(json.dumps({"flops": c.flops, "bytes": stats.bytes_by_op, "count": stats.count_by_op,
                  "wire": stats.wire_bytes, "local": list(y.to_local().shape)}))
dist.destroy_process_group()
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _local_bytes(plan, sizes=MESH_SIZES["single"]) -> int:
    total = 0
    for leaf, sh in zip(tree.leaves(plan.args), tree.leaves(plan.in_shardings)):
        split = 1
        for entry in sh.spec:
            for axis in ((entry,) if isinstance(entry, str) else entry or ()):
                split *= sizes[axis]
        total += leaf.numel() * leaf.element_size() // split
    return total


def test_dryrun_cells_single_pod(tmp_path):
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", "single", "--out", str(tmp_path)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape in CELLS]
    logs = [p.communicate(timeout=300)[0] for p in procs]
    for (arch, shape), p, log in zip(CELLS, procs, logs):
        assert p.returncode == 0, log[-3000:]
        _check_record(tmp_path, arch, shape, "single")
    taper = json.loads((tmp_path / "taper_paper__refine_step__single.json").read_text())
    # the step gathers its sharded edge and vertex arrays whole on every chip
    assert taper["collectives"]["count_by_op"]["all-gather"] >= 4


def _check_record(out_dir, arch, shape, mesh):
    rec = json.loads((out_dir / f"{arch}__{shape}__{mesh}.json").read_text())
    assert rec["status"] == "ok" and rec["mesh"] == mesh, rec.get("error")
    sizes = MESH_SIZES[mesh]
    plan = build_cell(arch, shape, axis_mesh(**sizes))
    assert rec["meta"] == plan.meta
    assert rec["memory_analysis"]["argument_size_in_bytes"] == _local_bytes(plan, sizes)
    roof = rec["roofline"]
    assert roof["n_chips"] == math.prod(sizes.values()) and roof["step_time_s"] > 0
    assert roof["memory_s"] == pytest.approx(
        rec["cost_analysis"]["compulsory bytes"] / 3.35e12)
    assert rec["hardware"]["hbm_bytes_per_s"] == 3.35e12
    return rec


@pytest.fixture(scope="module")
def repaired(tmp_path_factory):
    """The repaired cells' dry-runs, all started at once: (out dir, logs)."""
    out = tmp_path_factory.mktemp("dryrun_repaired")
    procs = {(arch, shape, mesh): subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch, "--shape", shape,
         "--mesh", mesh, "--out", str(out)],
        cwd=ROOT, env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for arch, shape, mesh in REPAIRED}
    procs["peak"] = subprocess.Popen([sys.executable, "-c", PEAK], cwd=ROOT, env=_env(),
                                     stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    logs = {}
    try:
        for key, p in procs.items():
            logs[key] = (p.communicate(timeout=600)[0], p.returncode)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out, logs


@pytest.mark.parametrize("cell", REPAIRED, ids=["__".join(c) for c in REPAIRED])
def test_repaired_cells(repaired, cell):
    out, logs = repaired
    log, rc = logs[cell]
    assert rc == 0, log[-3000:]
    rec = _check_record(out, *cell)
    if cell[0] == "olmoe-1b-7b":
        # experts over model: the combine's all-reduce; rows over data
        assert rec["collectives"]["count_by_op"]["all-reduce"] >= 1
    if cell == ("olmoe-1b-7b", "train_4k", "single"):
        assert rec["memory_analysis"]["temp_size_in_bytes"] <= OLMOE_TRAIN_TEMP_MAX


def test_train_peak_holds_no_whole_batch_or_vocabulary_logits(repaired):
    """At olmoe-1b-7b train_4k's peak on (16, 16) no storage has the global
    batch's logits' shape (256, 4096, V), nor a whole vocabulary's logits
    (any rows of 4,096 tokens by V): each chip keeps its 16 rows and its
    slice of V (V / 16), so the peak lies elsewhere."""
    _, logs = repaired
    out, rc = logs["peak"]
    assert rc == 0, out[-3000:]
    got = json.loads(out.strip().splitlines()[-1])
    V = got["vocab"]
    assert [256, 4096, V] not in got["shapes"]
    assert not [s for s in got["shapes"] if s[-2:] == [4096, V]]
    assert got["total"] <= OLMOE_TRAIN_TEMP_MAX


def test_dtensor_product_collectives():
    out = subprocess.run([sys.executable, "-c", PRODUCT], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    block = 256 * 9728 * 4
    assert got["local"] == [256, 9728]
    assert got["flops"] == {"float32": 2.0 * 256 * 160 * 9728}      # the local product
    assert got["count"] == {"all-reduce": 1}
    assert got["bytes"] == {"all-reduce": float(block)}
    assert math.isclose(got["wire"], 2.0 * block)


def test_slice_imports_without_jax_or_reference():
    """The four launch modules of this slice load neither JAX nor the
    reference package."""
    probe = ("import sys, repro_torch.launch.specs, repro_torch.launch.dryrun, "
             "repro_torch.launch.hlo_analysis, repro_torch.launch.roofline; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
