"""CPU tests of the benchmark's harness (``portbench/``).

    PYTHONPATH=src python -m pytest -q portbench/tests

Every configuration, mix, cell check and metric is found by name from its
own file; the result line has the contract's keys; the graph maker keeps the
port's schema; the draws are fresh and repeatable; ``vm_step``'s count reads
the same whatever ran; nothing the benchmark loads is JAX or the JAX package,
and the reference loads nothing of the program.
"""
from __future__ import annotations

import ast
import json
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from portbench import cell, compare, loadgen, registry  # noqa: E402
from portbench.counts.vm_step import launch_cost  # noqa: E402
from portbench.data.schema_graph import label_counts, schema_graph  # noqa: E402
from portbench.reference import field as ref_field  # noqa: E402

BENCH = registry.load_benchmark(ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"n": 2000}
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def small_run(name: str, traced: bool = False, seed: int = 2**31 + 7,
              seconds: float = 0.3) -> dict:
    return cell.run_cell(BENCH, name, seed, seconds, traced, "cpu", time.perf_counter(),
                         overrides=dict(SMALL))


# -- found by name ----------------------------------------------------------


def test_benchmark_entries_have_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves"}}
    for section, want in keys.items():
        for entry in BENCH[section]:
            extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
            assert want <= set(entry) <= want | extra, entry["name"]
            assert NAME.match(entry["name"]), entry["name"]
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    for w in BENCH["workloads"]:
        assert w["chips"] == 1


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    w = registry.workload(BENCH, name)
    cfg = registry.config(BENCH, w["config"])
    assert cfg["name"] == w["config"]
    mix = registry.traffic(w["traffic"])
    loadgen.check_mix(mix)
    checks = registry.checks(name)
    assert checks["sample"] >= 1 and checks["limits"]
    for traced in (False, True):
        for m in registry.metrics_of(BENCH, name, traced):
            assert callable(registry.reader(m["name"]))


def test_a_new_piece_is_a_new_file(tmp_path):
    """A configuration, mix, cell and metric added as files of their own,
    and named in BENCHMARK.json, are found with no harness file edited."""
    here = tmp_path / "portbench"
    shutil.copytree(ROOT / "portbench", here, ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    shutil.copy(here / "configs" / "pg1m-pq.json", here / "configs" / "pg2m-pq.json")
    (here / "traffic" / "hash-half.json").write_text(json.dumps(
        dict(registry.traffic("hash"), name="hash-half", move_frac=0.5)))
    shutil.copy(here / "checks" / "pg1m-pq-hash.json", here / "checks" / "pg2m-pq-hash-half.json")
    (here / "metrics" / "field.calls.py").write_text("def read(run):\n    return len(run.eval_s)\n")
    bench["configs"].append(dict(bench["configs"][0], name="pg2m-pq",
                                 file="portbench/configs/pg2m-pq.json"))
    bench["workloads"].append({"name": "pg2m-pq-hash-half", "config": "pg2m-pq",
                               "traffic": "hash-half", "chips": 1, "why": "test"})
    bench["per_layer"].append({"name": "field.calls", "unit": "1", "better": "higher",
                               "source": "host_clock", "layer": "field compute",
                               "moves": "field_eval_s"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    bench = registry.load_benchmark(tmp_path)
    assert registry.config(bench, "pg2m-pq", root=tmp_path)["k"] == 8
    assert registry.traffic("hash-half", here=here)["move_frac"] == 0.5
    assert registry.checks("pg2m-pq-hash-half", here=here)["sample"] >= 1
    names = [m["name"] for m in registry.metrics_of(bench, "pg2m-pq-hash-half", True)]
    assert "field.calls" in names
    record = cell.RunRecord(setup_s=1.0, graph_s=1.0, eval_s=[0.1, 0.2], window_s=0.3,
                            peak_bytes=0, peaks=None)
    assert registry.reader("field.calls", here=here)(record) == 2


# -- the result line --------------------------------------------------------


@pytest.mark.parametrize("traced", [False, True])
def test_result_line_keys(traced):
    out = small_run("mb10m-mq-block", traced, seconds=2.0)
    want = ["correct", "attempted", "failed", "metrics", "device"]
    want += (["breakdown"] if traced else []) + ["compared"]
    assert list(out) == want
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if traced:
        assert {"busy_s", "window_s"} <= set(out["device"])
        assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}
        assert "setup.graph_s" in out["metrics"]
    else:
        assert set(out["metrics"]) == {"field_eval_s", "setup_s"}
    for name, v in out["compared"].items():
        assert set(v) == {"value", "limit"}, name
    json.loads(json.dumps(out))


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mb10m-mq-block",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""


def test_run_refuses_without_the_program(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ holds no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)}
    proc = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mb10m-mq-block",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          cwd=tmp_path, capture_output=True, text=True, timeout=300, env=env)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    probe = ("import sys; sys.path[:0] = ['.', 'src']; import portbench.run as r; "
             "print(r._program_importable())")
    proc = subprocess.run([sys.executable, "-c", probe], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env=env)
    assert proc.stdout.strip().splitlines()[-1] == "False", proc.stderr[-2000:]


# -- imports ------------------------------------------------------------------

_LOADED = """
import sys, time
sys.path[:0] = [{root!r}, {root!r} + "/src"]
{body}
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


def _top_level_modules(body: str) -> set:
    proc = subprocess.run([sys.executable, "-c", _LOADED.format(root=str(ROOT), body=body)],
                          capture_output=True, text=True, timeout=600, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return set(ast.literal_eval(proc.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_loads_is_jax_or_the_jax_package():
    body = """
import portbench.run, portbench.control, portbench.cell
from portbench import cell, registry
bench = registry.load_benchmark()
for name in [w["name"] for w in bench["workloads"]]:
    for m in bench["end_to_end"] + bench["per_layer"]:
        registry.reader(m["name"])
    cell.run_cell(bench, name, 5, 0.2, True, "cpu", time.perf_counter(), overrides={"n": 1000})
"""
    loaded = _top_level_modules(body)
    assert "repro_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "repro"}


def test_the_reference_loads_nothing_of_the_program():
    loaded = _top_level_modules("import portbench.reference.field, portbench.reference.trie")
    assert not loaded & {"repro_torch", "repro", "jax", "jaxlib", "flax"}
    for path in (ROOT / "portbench" / "reference").glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & {"repro_torch", "repro", "jax"}, (path.name, tops)


# -- the graph maker and the draws ------------------------------------------


@pytest.mark.parametrize("config", ["mb10m-mq", "pg1m-pq"])
def test_graph_maker_keeps_the_ports_schema(config):
    from repro_torch.graphs.generators import musicbrainz_like, provgen_like
    from repro_torch.graphs.graph import LabelledGraph

    spec = dict(registry.config(BENCH, config)["graph"], n=20_000)
    labels, edges = schema_graph(spec, 11, "cpu")
    again = schema_graph(spec, 11, "cpu")
    assert torch.equal(labels, again[0]) and torch.equal(edges, again[1])
    port = (musicbrainz_like if config == "mb10m-mq" else provgen_like)(20_000, seed=11)
    g = LabelledGraph.from_undirected_edges(20_000, labels.numpy(), edges.numpy(),
                                            spec["labels"])
    assert np.array_equal(np.bincount(labels.numpy()), label_counts(spec))
    assert np.array_equal(g.label_counts(), port.label_counts())
    assert abs(g.m / port.m - 1) < 0.03
    # the degree law: hubs of the same order, and the same median degree
    assert np.median(g.degrees) == np.median(port.degrees)
    assert 0.5 < g.degrees.max() / port.degrees.max() < 2.0
    # edge types: the same label pairs
    pairs = lambda gr: set(zip(gr.labels[gr.src].tolist(), gr.labels[gr.dst].tolist()))  # noqa: E731
    assert pairs(g) == pairs(port)


def test_draws_are_fresh_and_repeat_from_the_seed():
    labels = np.repeat(np.arange(3, dtype=np.int32), [600, 300, 100])
    for start in (loadgen.hash_start(1000, 8, 5), loadgen.block_start(labels, 8)):
        a, b = loadgen.Draws(start, 8, 0.1, 99, "cpu"), loadgen.Draws(start, 8, 0.1, 99, "cpu")
        prev = None
        for _ in range(5):
            p, q = a.next().numpy(), b.next().numpy()
            assert np.array_equal(p, q)
            moved = p != start
            assert moved.sum() == 100 and ((p >= 0) & (p < 8)).all()
            if prev is not None:
                assert not np.array_equal(p, prev)
            prev = p
    from repro_torch.graphs.partition import hash_partition

    assert np.array_equal(loadgen.hash_start(5000, 512, 2**31 + 3),
                          hash_partition(5000, 512, seed=2**31 + 3))


# -- vm_step's count --------------------------------------------------------


def test_vm_step_count_reads_the_same_whatever_ran(monkeypatch):
    """The count from the reference's edge list, from the program's graph and
    from the arguments of the launches the program made agree."""
    import repro_torch.core.visitor as visitor
    from repro_torch.core.visitor import field_from_arrays

    cfg = registry.config(BENCH, "pg1m-pq")
    spec = dict(cfg["graph"], n=3000)
    labels, edges = schema_graph(spec, 3, "cpu")
    labels, edges = labels.numpy(), edges.numpy()
    start = loadgen.block_start(labels, 8)
    part = loadgen.Draws(start, 8, 0.1, 4, "cpu").next()
    prog = cell.build_program(dict(cfg, graph=spec), labels, edges, start, "cpu")
    g, trie = prog.graph, prog.trie
    n_cols, n_labels = trie.n_nodes, len(spec["labels"])
    ref = ref_field.build_graph(3000, labels, edges, n_labels, "cpu")
    from_ref = launch_cost(ref["src"], ref["dst"], part, 3000, n_cols, n_labels)
    from_prog = launch_cost(torch.as_tensor(g.src).long(), torch.as_tensor(g.dst).long(),
                            part, 3000, n_cols, n_labels)
    assert from_ref == from_prog

    seen = []
    real = visitor.vm_step

    def spy(alpha, par, val, csr, w, row_label):
        live = w != 0
        rows = torch.unique(csr.src[live].long()).numel()
        n_out = csr.row_ptr.shape[0] - 1
        words = (n_out + 1) + 2 * int(live.sum()) + n_out + n_out * alpha.shape[1] \
            + 2 * par.numel()
        seen.append((4 * words + 4 * alpha.shape[1] * rows, 3 * int(live.sum()) * alpha.shape[1]))
        return real(alpha, par, val, csr, w, row_label)

    monkeypatch.setattr(visitor, "vm_step", spy)
    cnt = torch.as_tensor(g.neighbor_label_counts())
    field_from_arrays(trie, 8, torch.as_tensor(g.src), torch.as_tensor(g.dst),
                      torch.as_tensor(g.labels), cnt, torch.as_tensor(g.label_counts()),
                      part.long(), torch.as_tensor(trie.p), torch.as_tensor(trie.cond_p),
                      n=g.n, m=g.m, backend="cuda", dense_ext_to=True)
    assert len(seen) == trie.max_depth - 1
    assert all(s == from_ref for s in seen)


def test_compare_matches_columns_by_label_path():
    paths = [(), ("A",), ("B",), ("A", "B")]
    ref = {"alpha": torch.tensor([[0.0, 1.0, 2.0, 3.0]], dtype=torch.float64)}
    for name in ("pr", "edge_mass", "extro_mass", "extroversion"):
        ref[name] = torch.ones(1, dtype=torch.float64)
    ref["ext_to"], ref["total_extroversion"] = None, torch.tensor(1.0, dtype=torch.float64)

    class Out:
        alpha = np.array([[0.0, 2.0, 1.0, 3.0]], np.float32)    # B before A
        pr = edge_mass = extro_mass = extroversion = np.ones(1, np.float32)
        ext_to, total_extroversion = None, 1.0

    nums = compare.compare(Out, ref, [(), ("B",), ("A",), ("A", "B")], paths, False)
    assert nums["structure"] == 0 and nums["alpha_relerr"] == 0.0
    nums = compare.compare(Out, ref, paths, paths, False)
    assert nums["alpha_relerr"] > 0.4
