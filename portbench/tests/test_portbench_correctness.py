"""CPU tests of the comparison that decides ``correct``.

    PYTHONPATH=src python -m pytest -q portbench/tests

The reference agrees with the port's ``torch`` field at N = 2,000 for both
configurations and both starts; the control (the reference computed in
bfloat16, below the float32 that the configurations state) fails each
cell's limits on three seeds; and a run whose timed path is broken
underneath comes out not correct, once for each fault a field evaluation
can have.  The card's own runs of the control are ``control.py``'s.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

import repro_torch.core.taper as taper_mod  # noqa: E402
import repro_torch.core.visitor as visitor  # noqa: E402
from portbench import cell, compare, control, loadgen, registry  # noqa: E402
from portbench.reference import field as ref_field  # noqa: E402
from portbench.reference import trie as ref_trie  # noqa: E402

BENCH = registry.load_benchmark(ROOT)
N_SMALL = 2000


@pytest.mark.parametrize("config,mix", [("mb10m-mq", "block"), ("mb10m-mq", "hash"),
                                        ("pg1m-pq", "hash"), ("pg1m-pq", "block")])
def test_reference_agrees_with_the_ports_torch_field(config, mix):
    cfg = registry.config(BENCH, config)
    cfg["graph"]["n"] = N_SMALL
    k, dense = int(cfg["k"]), bool(cfg["dense_ext_to"])
    labels, edges = cell.make_data(cfg, 17, "cpu")
    start = loadgen.start_partition(registry.traffic(mix), labels, k, 17)
    prog = cell.build_program(cfg, labels, edges, start, "cpu")
    draws = loadgen.Draws(start, k, 0.1, 18, "cpu")
    names = list(cfg["graph"]["labels"])
    rtrie = ref_trie.build(cfg["workload"], int(cfg["star_max"]))
    graph = ref_field.build_graph(N_SMALL, labels, edges, len(names), "cpu")
    paths = compare.column_paths(prog.trie.parent, prog.trie.label, names)
    assert sorted(paths) == sorted(rtrie.paths)
    assert np.allclose(prog.trie.p, [rtrie.p[rtrie.index()[s]] for s in paths], rtol=1e-6)
    # the limits of the configuration's cell (pg1m's block start has none of its own)
    cell_name = next(w["name"] for w in BENCH["workloads"] if w["config"] == config)
    limits = registry.checks(cell_name)["limits"]
    for part in (start, draws.next().numpy()):
        out = prog.taper.field(part, prog.trie)
        ref = ref_field.field(graph, rtrie, {s: i for i, s in enumerate(names)}, part, k,
                              dense, torch.float64)
        nums = compare.compare(out, ref, paths, rtrie.paths, dense)
        nums["failed_calls"] = 0.0
        judged = compare.judge(nums, limits)
        assert all(v["ok"] for v in judged.values()), judged
        # far inside the limits: float32 against float64
        assert max(v for name, v in nums.items() if name.endswith("relerr")) < 1e-4
        assert float(ref["alpha"][:, [d >= 2 for d in rtrie.depth]].sum()) > 0


@pytest.mark.parametrize("config", ["mb10m-mq", "pg1m-pq"])
def test_the_control_fails_every_cells_limits(config):
    mixes = [w["traffic"] for w in BENCH["workloads"] if w["config"] == config]
    for seed in (31, 32, 33):
        for line in control.readings(BENCH, config, mixes, seed, 1, "cpu", n=N_SMALL):
            assert line["program_passes"], line
            assert not line["control_passes"], line


# -- faults planted under the timed path -----------------------------------


def _state_unchanged(monkeypatch):
    """Every depth step returns the state unchanged (alpha stays the priors)."""
    monkeypatch.setattr(visitor, "_depth_nodes", lambda trie, max_depth: [])


def _half_left_out(monkeypatch):
    """Every other edge's messages left out of every depth step."""
    real = visitor._depth_contrib

    def half(alpha, nodes_d, trie, cond_p, src, dst_lab, inv_cnt):
        out = real(alpha, nodes_d, trie, cond_p, src, dst_lab, inv_cnt)
        out[::2] = 0
        return out

    monkeypatch.setattr(visitor, "_depth_contrib", half)


def _answer_altered(monkeypatch):
    """One vertex's extroversion altered where the field is produced."""
    real = taper_mod.extroversion_field

    def altered(*args, **kwargs):
        out = real(*args, **kwargs)
        v = int(np.argmax(out.extroversion))
        out.extroversion[v] *= 1.01
        return out

    monkeypatch.setattr(taper_mod, "extroversion_field", altered)


def _stale_answer(monkeypatch):
    """Each call answers with the previous call's field."""
    real = taper_mod.Taper.field
    last = {}

    def stale(self, part, trie):
        out = last.get("field") or real(self, part, trie)
        last["field"] = real(self, part, trie)
        return out

    monkeypatch.setattr(taper_mod.Taper, "field", stale)


FAULTS = {"state_unchanged": _state_unchanged, "half_left_out": _half_left_out,
          "answer_altered": _answer_altered, "stale_answer": _stale_answer}
CELLS = ["mb10m-mq-block", "mb10m-mq-hash"]


def _run(name: str, seed: int) -> dict:
    return cell.run_cell(BENCH, name, seed, 0.4, False, "cpu", time.perf_counter(),
                         overrides={"n": N_SMALL})


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(name):
    out = _run(name, 2**31 + 101)
    assert out["correct"] is True, out["compared"]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    out = _run(name, 2**31 + 101)
    assert out["correct"] is False, (fault, out["compared"])
    assert any(v["value"] > v["limit"] for v in out["compared"].values())
