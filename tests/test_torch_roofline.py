"""The port's roofline and cost analysis (``launch/hlo_analysis.py``,
``launch/roofline.py``) against the JAX package's: ``Roofline.to_dict``
equal for the same inputs with the port's H100 constants patched to the
reference's, the report tables' numbers equal for the same records; then
the fake-run counts that have no twin (the reference reads XLA's): the
attention wrapper's fake route counts the causal pairs, not S x S, and
makes no S x S temporary; the wrappers' fake routes give their outputs'
shapes; the compulsory bytes count an argument read only through an index
by its indices, and an argument written in place by the bytes written."""
import math

import pytest
import torch

torch.set_num_threads(1)

from repro.launch import hlo_analysis as r_hlo
from repro.launch import roofline as r_roofline

from repro_torch.kernels.embedding_bag.ops import embedding_bag
from repro_torch.kernels.flash_attention.ops import attention_pairs, flash_attention
from repro_torch.kernels.segment_spmm.ops import csr_from_edges, segment_spmm_csr
from repro_torch.launch import hlo_analysis as hlo
from repro_torch.launch import roofline
from repro_torch.launch.specs import CellPlan, axis_mesh, sds

ROOF_INPUTS = [
    (1.2e15, 3.4e11, 5.6e9, 2.0e17, 256),
    (0.0, 1.0e9, 0.0, 1.0e12, 1),
    (7.7e13, 0.0, 8.8e12, 3.3e15, 512),
]


@pytest.mark.parametrize("inputs", ROOF_INPUTS)
def test_roofline_to_dict_equals_reference(inputs, monkeypatch):
    for name in ("PEAK_FLOPS", "HBM_BW", "LINK_BW"):
        monkeypatch.setattr(hlo, name, getattr(r_hlo, name))
    assert hlo.Roofline(*inputs).to_dict() == r_hlo.Roofline(*inputs).to_dict()


def test_roofline_compute_by_type():
    """Each type's FLOPs over its own peak: bf16 at 989.4 TFLOP/s, float32
    at the TF32 494.7, others at the bf16 peak."""
    by = {"bfloat16": 3e12, "float32": 2e12, "complex64": 1e12}
    roof = hlo.Roofline(6e12, 0.0, 0.0, 6e12, 1, flops_by_dtype=by)
    assert roof.compute_s == pytest.approx(3e12 / 989.4e12 + 2e12 / 494.7e12 + 1e12 / 989.4e12)
    assert roof.step_time_s == roof.compute_s and roof.dominant == "compute"
    assert hlo.HBM_BW == 3.35e12 and hlo.LINK_BW == 450e9


def _record(arch, shape, step, inputs, args_b, temp_b, counts):
    return {"arch": arch, "shape": shape, "step": step, "status": "ok",
            "roofline": r_hlo.Roofline(*inputs).to_dict(),
            "memory_analysis": {"argument_size_in_bytes": args_b,
                                "temp_size_in_bytes": temp_b},
            "collectives": {"count_by_op": counts}}


RECORDS = {
    ("qwen3-4b", "prefill_32k"): _record("qwen3-4b", "prefill_32k", "prefill_step",
                                         ROOF_INPUTS[0], 37_000_000, 488_000_000_000,
                                         {"all-gather": 365, "all-reduce": 72}),
    ("dlrm-rm2", "train_batch"): _record("dlrm-rm2", "train_batch", "train_step",
                                         ROOF_INPUTS[1], 25_940_000_000, 26_440_000_000,
                                         {"all-reduce": 14}),
    ("taper_paper", "refine_step"): _record("taper_paper", "refine_step",
                                            "taper_refine_step", ROOF_INPUTS[2],
                                            70_000_000, 32_840_000_000, {"all-gather": 5}),
}


def _cols(text: str, drop):
    rows = [r.split("|") for r in text.splitlines()[2:]]
    return [[c.strip() for i, c in enumerate(r) if i not in drop] for r in rows]


def test_tables_give_the_reference_numbers():
    """The same columns but the advice (the port's levers) and the fits
    column (80 GB here, 16 GB for the TPU v5e)."""
    assert _cols(roofline.table(RECORDS), {11}) == _cols(r_roofline.table(RECORDS), {11})
    port = _cols(roofline.memory_table(RECORDS, RECORDS), {6})
    assert port == _cols(r_roofline.memory_table(RECORDS, RECORDS), {6})
    fits = [r.split("|")[6].strip() for r in roofline.memory_table(RECORDS, {}).splitlines()[2:]]
    # sorted by arch: dlrm 25.94 + 26.44 GB fits, qwen3-4b's 488 GB does not
    assert fits == ["yes", "NO", "yes"]
    assert "fits H100 80GB" in roofline.memory_table({}, {})


def _count(step, *args):
    """A fake run of ``step`` on meta-shaped ``args`` on one chip."""
    plan = CellPlan("t", None, "t", step, tuple(args), (None,) * len(args), None,
                    mesh=axis_mesh(data=1, model=1))
    return hlo.run_fake(plan)


@pytest.mark.parametrize("window", [None, 96])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_fake_route_counts_causal_pairs(window, dtype):
    B, S, H, KV, D = 2, 512, 8, 2, 64
    run = _count(lambda q, k, v: flash_attention(q, k, v, causal=True, window=window),
                 sds((B, S, H, D), dtype), sds((B, S, KV, D), dtype), sds((B, S, KV, D), dtype))
    pairs = attention_pairs(S, S, True, window)
    assert pairs == (S * (S + 1) // 2 if window is None
                     else sum(min(i + 1, window) for i in range(S)))
    assert run.flops_by_dtype == {str(dtype).split(".")[1]: 4.0 * B * H * D * pairs}
    assert run.flops < 4.0 * B * H * D * S * S
    # the output alone: no S x S scores
    assert run.temp_bytes == B * S * H * D * (2 if dtype == torch.bfloat16 else 4)


def test_attention_fake_backward_counts_five_products():
    B, S, H, D = 1, 256, 4, 32

    def step(q, k, v):
        q, k, v = (t.detach().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            out = flash_attention(q, k, v, causal=True)
            return torch.autograd.grad(out.sum(), (q, k, v))

    run = _count(step, *(sds((B, S, H, D), torch.bfloat16) for _ in range(3)))
    fwd = 4.0 * B * H * D * S * (S + 1) // 2
    assert run.flops_by_dtype["bfloat16"] == fwd + 2.5 * fwd


def test_wrappers_fake_routes_give_shapes():
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        x = torch.empty(50, 7)
        src = torch.empty(300, dtype=torch.int64)
        dst = torch.empty(300, dtype=torch.int64)
        csr = csr_from_edges(src, dst, 40)
        assert csr.plan is None and csr.src_bound is None
        out = segment_spmm_csr(x, csr, torch.empty(300))
        assert out.shape == (40, 7)
        table, ids = torch.empty(1000, 16), torch.empty(32, 5, dtype=torch.int32)
        assert embedding_bag(table, ids).shape == (32, 16)


def test_compulsory_bytes():
    """A table read only by ``index_select`` counts nothing of itself (its
    int64 indices count, an argument read in full); an argument written in
    place counts the bytes written, not its size; a new output counts its
    own bytes."""
    def gather(table, ids, x):
        return table.index_select(0, ids.long()).sum(0) + x

    run = _count(gather, sds((10_000, 64), torch.float32), sds((100,), torch.int32),
                 sds((64,), torch.float32))
    assert run.compulsory_bytes == 100 * 4 + 64 * 4 + 64 * 4
    assert run.argument_bytes == 10_000 * 64 * 4 + 100 * 4 + 64 * 4

    def write(cache, v):
        cache[:, 3].copy_(v)
        return cache

    run = _count(write, sds((8, 1000, 32), torch.float32), sds((8, 32), torch.float32))
    assert run.compulsory_bytes == 8 * 32 * 4 * 2          # v read, one slot written
    assert run.alias_bytes == run.output_bytes == 8 * 1000 * 32 * 4
    assert math.isclose(hlo.analyze(run, 1.0, 1)["roofline"]["memory_s"],
                        run.compulsory_bytes / hlo.HBM_BW)
