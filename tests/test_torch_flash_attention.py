"""The port's ``flash_attention`` against the JAX reference: the reference's
Pallas kernel (interpret mode on the CPU, as tests/test_kernels.py runs it)
and its oracle ``attention_reference``, on the same numpy-seeded inputs.
On the CPU the wrapper takes the plain torch version; the CUDA kernel
itself is checked on the card (tests/test_torch_cuda.py).  Tolerances are
those of tests/test_kernels.py: 2e-5 in float32, 2e-2 in bfloat16."""
import math
import re
from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import HealthCheck, given, settings, strategies as st

from repro.kernels.flash_attention.ops import flash_attention as r_flash_attention
from repro.kernels.flash_attention.ref import attention_reference

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_reference

SET = settings(max_examples=10, deadline=None, derandomize=True,
               suppress_health_check=list(HealthCheck))
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _tol(dtype):
    return dict(rtol=2e-2, atol=2e-2) if dtype == "bfloat16" else dict(rtol=2e-5, atol=2e-5)


def _inputs(seed, b, sq, skv, H, kv, d):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, H, d)), rng.normal(size=(b, skv, kv, d)),
            rng.normal(size=(b, skv, kv, d)))


def _port(arrays, dtype, causal, window):
    q, k, v = (torch.tensor(a, dtype=torch.float32).to(TORCH_DTYPES[dtype]) for a in arrays)
    return flash_attention(q, k, v, causal=causal, window=window).float().numpy()


def _reference(arrays, dtype, causal, window, g, block=64):
    """(Pallas kernel, oracle) outputs as float32 numpy."""
    q, k, v = (jnp.asarray(a, JAX_DTYPES[dtype]) for a in arrays)
    pallas = r_flash_attention(q, k, v, causal=causal, window=window,
                               block_q=block, block_k=block)
    oracle = attention_reference(q, jnp.repeat(k, g, 2), jnp.repeat(v, g, 2),
                                 causal=causal, window=window)
    return np.asarray(pallas, np.float32), np.asarray(oracle, np.float32)


@given(
    b=st.integers(1, 3),
    sq=st.integers(1, 300),
    skv=st.integers(1, 300),
    h=st.sampled_from([1, 2, 4]),
    g=st.sampled_from([1, 2]),
    d=st.sampled_from([32, 64]),
    causal=st.booleans(),
    window=st.sampled_from([None, 17, 64]),
    dtype=st.sampled_from(["float32", "bfloat16"]),
)
@SET
def test_flash_attention_sweep(b, sq, skv, h, g, d, causal, window, dtype):
    """tests/test_kernels.py's sweep (its causal rows keep sq <= skv)."""
    if causal and sq > skv:
        sq = skv
    arrays = _inputs(abs(hash((b, sq, skv, h, g, d))) % 2**31, b, sq, skv, h * g, h, d)
    out = _port(arrays, dtype, causal, window)
    pallas, oracle = _reference(arrays, dtype, causal, window, g)
    np.testing.assert_allclose(out, pallas, **_tol(dtype))
    np.testing.assert_allclose(out, oracle, **_tol(dtype))


# seeded shapes the sweep does not draw: head sizes 128 and 256, 4 query
# heads per KV head, a 1024-token window, one-row and one-key sequences, and
# causal rows past the last key (top-left alignment)
_rng = np.random.default_rng(20261017)
CASES = [
    # (b, sq, skv, kv, g, d, causal, window, dtype)
    (1, 1, 1, 1, 1, 32, True, None, "float32"),
    (2, 1, 300, 2, 4, 64, False, None, "bfloat16"),
    (1, 300, 1, 1, 2, 128, False, 17, "float32"),
    (1, 300, 100, 2, 2, 64, True, None, "float32"),
    (2, 129, 129, 2, 4, 128, True, 1024, "bfloat16"),
    (1, 257, 257, 1, 4, 256, True, 64, "float32"),
    (1, 100, 200, 1, 1, 256, False, 64, "bfloat16"),
] + [
    (int(_rng.integers(1, 3)), int(_rng.integers(1, 301)), int(_rng.integers(1, 301)),
     int(_rng.choice([1, 2])), int(_rng.choice([1, 2, 4])), d, bool(_rng.integers(0, 2)),
     [None, 17, 64, 1024][int(_rng.integers(0, 4))], dtype)
    for d in (32, 64, 128, 256) for dtype in ("float32", "bfloat16")
]


@pytest.mark.parametrize("b,sq,skv,kv,g,d,causal,window,dtype", CASES)
def test_flash_attention_cases_match_reference(b, sq, skv, kv, g, d, causal, window, dtype):
    arrays = _inputs(sq * 1000 + skv + d, b, sq, skv, kv * g, kv, d)
    out = _port(arrays, dtype, causal, window)
    pallas, oracle = _reference(arrays, dtype, causal, window, g)
    np.testing.assert_allclose(out, pallas, **_tol(dtype))
    np.testing.assert_allclose(out, oracle, **_tol(dtype))


@pytest.mark.parametrize("bq,bk", [(128, 128), (256, 64), (64, 256)])
def test_flash_attention_long_and_blocks(bq, bk):
    """tests/test_kernels.py's 1024-token causal case with the Pallas
    kernel's three block shapes."""
    rng = np.random.default_rng(0)
    arrays = [rng.normal(size=(1, 1024, 2, 64)).astype(np.float32) for _ in range(3)]
    out = _port(arrays, "float32", True, None)
    q, k, v = (jnp.asarray(a) for a in arrays)
    ref = attention_reference(q, k, v, causal=True)
    pallas = r_flash_attention(q, k, v, causal=True, block_q=bq, block_k=bk)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, np.asarray(pallas), rtol=2e-5, atol=2e-5)


def test_fully_masked_rows_are_zero():
    """Non-causal, window 17, Sq > Skv + 17: rows from Skv + 16 on see no
    key and give exactly 0, as the Pallas kernel's do."""
    arrays = _inputs(5, 1, 150, 100, 4, 2, 32)
    out = _port(arrays, "float32", False, 17)
    pallas, oracle = _reference(arrays, "float32", False, 17, 2)
    assert np.all(out[:, 116:] == 0) and np.all(pallas[:, 116:] == 0)
    assert np.all(np.abs(out[:, :116]).sum(-1) > 0)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("chunk", [1, 7, 64])
def test_plain_version_does_not_depend_on_its_chunk(chunk):
    q, k, v = (torch.tensor(a, dtype=torch.float32)
               for a in _inputs(9, 2, 90, 70, 4, 2, 32))
    want = flash_attention_reference(q, k, v, True, 30)
    got = flash_attention_reference(q, k, v, True, 30, chunk=chunk)
    torch.testing.assert_close(got, want, rtol=2e-6, atol=2e-6)


def test_cpu_call_counts_no_launch():
    before = flash_attention.launches
    q, k, v = (torch.tensor(a, dtype=torch.float32) for a in _inputs(3, 1, 8, 8, 2, 1, 32))
    out = flash_attention(q, k, v)
    assert flash_attention.launches == before
    assert torch.equal(out, flash_attention_reference(q, k, v))


def _qkv(shape_q=(1, 8, 4, 32), shape_kv=(1, 8, 2, 32), dtype=torch.float32):
    return torch.zeros(shape_q, dtype=dtype), torch.zeros(shape_kv, dtype=dtype), \
        torch.zeros(shape_kv, dtype=dtype)


@pytest.mark.parametrize("make,match", [
    (lambda: _qkv(dtype=torch.float64), "float32 or all"),
    (lambda: (*_qkv()[:2], torch.zeros(1, 8, 2, 32, dtype=torch.bfloat16)), "float32 or all"),
    (lambda: _qkv((1, 8, 4, 48), (1, 8, 2, 48)), "head size"),
    (lambda: _qkv((1, 8, 3, 32), (1, 8, 2, 32)), "multiple"),
    (lambda: _qkv((1, 8, 32), (1, 8, 2, 32)), "must be"),
    (lambda: (_qkv()[0], torch.zeros(1, 8, 2, 32), torch.zeros(1, 9, 2, 32)), "must be"),
    (lambda: _qkv((2, 8, 4, 32), (1, 8, 2, 32)), "do not match"),
    (lambda: _qkv((1, 0, 4, 32), (1, 8, 2, 32)), "sizes"),
    (lambda: (torch.zeros(1, 4, 8, 32).transpose(1, 2), *_qkv()[1:]), "contiguous"),
])
def test_flash_attention_rejects_bad_arguments(make, match):
    with pytest.raises(ValueError, match=match):
        flash_attention(*make())


@pytest.mark.parametrize("window", [2.5, True, "17"])
def test_flash_attention_rejects_a_bad_window(window):
    with pytest.raises(ValueError, match="window"):
        flash_attention(*_qkv(), window=window)


def test_flash_attention_has_no_plain_fallback_off_the_cpu():
    """A tensor on a device that is neither the CPU nor CUDA raises: the
    plain version serves CPU tensors only."""
    q, k, v = (t.to("meta") for t in _qkv())
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q, k, v)


# --- the bf16 tensor-core kernel's design, checked on the CPU ---------------
#
# ``_emulate`` repeats the arithmetic of csrc/flash_attention_bf16.cu in
# torch: bf16 q, k, v; float32 scores; 128-row q tiles that visit the kv
# tiles the kernel visits, BK rows at a time from the tile plan; the online
# softmax in float32 with exp2; P fed to the products as bf16 hi + lo (or,
# the design the kernel does not take, as one bf16 value), l summed from
# the same weights; float32 accumulation; the output rounded to bf16.

from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ops as fa_ops

#: the serving path's gate (chip_smoke.py): one bf16 step of the value plus
#: 1e-3 of the output's RMS
PATH_RTOL, PATH_ATOL_RMS = 2.0 ** -7, 1e-3


def _emulate(q, k, v, causal=True, window=None, split=True):
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    plan = fa_kernel.TILE_PLAN[D]
    sl2 = math.log2(math.e) / math.sqrt(D)
    kf = k.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    vf = v.float().repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    qf = q.float().permute(0, 2, 1, 3)
    out = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, plan.bq):
        rows = torch.arange(q0, min(q0 + plan.bq, Sq))
        lo, hi = 0, Skv
        if causal:
            hi = min(hi, q0 + plan.bq)
        if window is not None:
            lo = max(0, q0 - window + 1)
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), D)
        for kv0 in range(lo // plan.bk * plan.bk, hi, plan.bk):
            cols = torch.arange(kv0, min(kv0 + plan.bk, Skv))
            s = qf[:, :, rows] @ kf[:, :, cols].transpose(-1, -2)
            keep = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                keep &= cols[None] <= rows[:, None]
            if window is not None:
                keep &= cols[None] > rows[:, None] - window
            s = s.masked_fill(~keep, -math.inf)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True) * sl2)
            corr = torch.exp2(m - m_new)
            p = torch.exp2(s * sl2 - m_new)
            p_hi = p.bfloat16().float()
            p = p_hi + (p - p_hi).bfloat16().float() if split else p_hi
            l = l * corr + p.sum(-1, keepdim=True)
            acc = acc * corr + p @ vf[:, :, cols]
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)
    return out.permute(0, 2, 1, 3).bfloat16()


def _bf16(arrays):
    return [torch.tensor(a, dtype=torch.float32).bfloat16() for a in arrays]


@pytest.mark.parametrize("b,sq,skv,kv,g,d,causal,window,dtype", CASES)
def test_kernel_arithmetic_matches_reference(b, sq, skv, kv, g, d, causal, window, dtype):
    """The emulated bf16 kernel against the Pallas kernel (interpret) and
    the oracle, at bf16's tolerance, on the cases' shapes in bf16."""
    arrays = _inputs(sq * 1000 + skv + d, b, sq, skv, kv * g, kv, d)
    out = _emulate(*_bf16(arrays), causal, window).float().numpy()
    pallas, oracle = _reference(arrays, "bfloat16", causal, window, g)
    np.testing.assert_allclose(out, pallas, **_tol("bfloat16"))
    np.testing.assert_allclose(out, oracle, **_tol("bfloat16"))


def _common_part(seed, S, H, KV, D):
    """q, k ~ N(0, 1) and v rows sharing a common part: output RMS ~0.5, as
    on the qwen3-4b path (PERF.md)."""
    rng = np.random.default_rng(seed)
    q, k = rng.normal(size=(1, S, H, D)), rng.normal(size=(1, S, KV, D))
    v = 0.5 * rng.normal(size=(1, 1, KV, D)) + 0.3 * rng.normal(size=(1, S, KV, D))
    return _bf16((q, k, v))


def _misses_path_gate(out, ref):
    rms = float(ref.float().square().mean().sqrt())
    allowed = PATH_RTOL * ref.float().abs() + PATH_ATOL_RMS * rms
    return rms, int(((out.float() - ref.float()).abs() > allowed).sum())


@pytest.mark.parametrize("window", [None, 4])
def test_split_weights_hold_the_path_gate(window):
    """P as bf16 hi + lo holds the path gate against the plain version where
    v shares a common part; one bf16 rounding of P does not once rows have
    few keys (window 4): the reason for the kernel's second P V product."""
    q, k, v = _common_part(31, 512, 8, 2, 128)
    ref = flash_attention_reference(q, k, v, True, window)
    rms, missed = _misses_path_gate(_emulate(q, k, v, True, window), ref)
    assert 0.3 < rms < 0.7 and missed == 0
    if window is not None:
        assert _misses_path_gate(_emulate(q, k, v, True, window, split=False), ref)[1] > 0


@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_tile_plan_fits_the_card(d):
    plan = fa_kernel.TILE_PLAN[d]
    assert plan.bq % 64 == 0 and plan.bk % 16 == 0 and plan.stages >= 2
    assert fa_kernel.smem_bytes(d, plan) <= fa_kernel.SMEM_LIMIT == 232448


def test_tile_plan_is_what_the_source_instantiates():
    src = (Path(fa_kernel.__file__).parents[1] / "csrc" / "flash_attention_bf16.cu").read_text()
    planned = {(d, p.bk, p.stages) for d, p in fa_kernel.TILE_PLAN.items()}
    built = {tuple(map(int, t)) for t in re.findall(r"FA_PLAN\((\d+), (\d+), (\d+)\)\n", src)}
    assert planned == built and all(p.bq == 128 for p in fa_kernel.TILE_PLAN.values())
    assert "kBQ = 128" in src


def test_each_dtype_has_its_kernel_source():
    """bf16 goes to the wgmma + TMA source; the float32 source runs its
    products on the tensor cores as TF32 mma.sync (three products each) and
    has no wgmma and no bf16."""
    csrc = Path(fa_kernel.__file__).parents[1] / "csrc"
    bf16 = (csrc / "flash_attention_bf16.cu").read_text()
    f32 = (csrc / "flash_attention_f32.cu").read_text().split("#include", 1)[1]
    assert "wgmma.mma_async" in bf16 and "cp.async.bulk.tensor" in bf16
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in f32
    assert "(__float_as_uint(x) + 0x1000u) & 0xffffe000u" in f32    # TF32 rna
    assert "cp.async.cg.shared.global" in f32
    assert not re.search(r"wgmma|bfloat16|bf16", f32)


@pytest.mark.parametrize("device,dtype,want", [
    ("cuda", torch.bfloat16, "flash_attention_bf16"),
    ("cuda", torch.float32, "flash_attention_f32"),
    ("cpu", torch.bfloat16, None),
    ("cpu", torch.float32, None),
])
def test_kernel_by_device_and_dtype(device, dtype, want):
    fake = SimpleNamespace(device=torch.device(device), dtype=dtype)
    assert fa_ops.kernel_name(fake) == want


@pytest.mark.parametrize("dtype,name", [(torch.bfloat16, "flash_attention_bf16"),
                                        (torch.float32, "flash_attention_f32")])
def test_card_tensors_never_reach_the_plain_version(monkeypatch, dtype, name):
    """With the routing of a CUDA tensor, the wrapper launches the kernel
    of the tensor's dtype, counts the launch and never calls the plain
    version."""
    launched = []

    def fake_launch(kernel, q, k, v, causal, window):
        launched.append(kernel)
        return torch.zeros_like(q)

    def no_plain(*args, **kwargs):
        raise AssertionError("the plain version served a card tensor")

    monkeypatch.setattr(fa_ops, "kernel_name", lambda q: fa_ops.KERNEL_BY_DTYPE[q.dtype])
    monkeypatch.setattr(fa_ops, "flash_attention_reference", no_plain)
    monkeypatch.setattr(fa_kernel, "flash_attention_cuda", fake_launch)
    before = flash_attention.launches
    flash_attention(*_qkv(dtype=dtype))
    assert launched == [name] and flash_attention.launches == before + 1


# --- the float32 kernel's design (3xTF32 on the tensor cores), on the CPU --
#
# ``_emulate_f32`` repeats the arithmetic of csrc/flash_attention_f32.cu in
# torch: each float32 operand split as hi = rna(x) to TF32 and lo = rna(x -
# hi), rounded on the int32 view; S = Q K^T as three sums over 8-dim k-steps
# (in the kernel's order of dims), hi.lo, lo.hi and hi.hi, added small terms
# first; each kv tile's P V summed from 0 over its 8-key k-steps, each
# k-step's hi.lo, lo.hi, hi.hi added in that order, then O = O * corr + P V
# in one rounding; (or, the design the kernel does not take, hi.hi alone);
# 64-row q tiles that visit the kv tiles the kernel visits, BK keys at a
# time from the tile plan; the online softmax in float32 with exp2 of the
# score times log2(e) / sqrt(D).  Sums round to nearest here; the tensor
# core's own rounding of its float32 sums (toward zero) is held by the
# kernel's tests on the card.


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: cvt.rna.tf32.f32, on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _score_ksteps(d):
    """Head dims of each 8-dim k-step of S = Q K^T: thread t's {4t, 4t + 1}
    then {4t + 2, 4t + 3} of each 16 dims."""
    for base in range(0, d, 16):
        for pair in (0, 2):
            yield [base + 4 * t + pair + c for c in (0, 1) for t in range(4)]


def _emulate_f32(q, k, v, causal=True, window=None, products=3):
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    plan = fa_kernel.TILE_PLAN_F32[D]
    sl2 = math.log2(math.e) / math.sqrt(D)
    kf = k.repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    vf = v.repeat_interleave(H // KV, 2).permute(0, 2, 1, 3)
    qf = q.permute(0, 2, 1, 3)
    ksteps = list(_score_ksteps(D))
    out = torch.zeros(B, H, Sq, D)
    for q0 in range(0, Sq, plan.bq):
        rows = torch.arange(q0, min(q0 + plan.bq, Sq))
        lo, hi = 0, Skv
        if causal:
            hi = min(hi, q0 + plan.bq)
        if window is not None:
            lo = max(0, q0 - window + 1)
        m = torch.full((B, H, len(rows), 1), -1e30)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, H, len(rows), D)
        for kv0 in range(lo // plan.bk * plan.bk, hi, plan.bk):
            cols = torch.arange(kv0, min(kv0 + plan.bk, Skv))
            qt, kt = qf[:, :, rows], kf[:, :, cols]
            hl, lh, hh = (torch.zeros(B, H, len(rows), len(cols)) for _ in range(3))
            for dims in ksteps:
                (ah, al), (bh, bl) = _split(qt[..., dims]), _split(kt[..., dims].transpose(-1, -2))
                hl, lh, hh = hl + ah @ bl, lh + al @ bh, hh + ah @ bh
            s = (hl + lh) + hh if products == 3 else hh
            keep = torch.ones(len(rows), len(cols), dtype=torch.bool)
            if causal:
                keep &= cols[None] <= rows[:, None]
            if window is not None:
                keep &= cols[None] > rows[:, None] - window
            s = torch.where(keep, s * sl2, torch.tensor(-1e30))
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.where(keep, torch.exp2(s - m_new), torch.tensor(0.0))
            corr = torch.exp2(m - m_new)
            l = l * corr + p.sum(-1, keepdim=True)
            pv = torch.zeros(B, H, len(rows), D)
            for j in range(0, len(cols), 8):
                (ph, pl), (vh, vl) = _split(p[..., j:j + 8]), _split(vf[:, :, cols[j:j + 8]])
                if products == 3:
                    pv = pv + ph @ vl
                    pv = pv + pl @ vh
                pv = pv + ph @ vh
            acc = (acc.double() * corr.double() + pv.double()).float()
            m = m_new
        out[:, :, rows] = acc / l.clamp(min=1e-30)
    return out.permute(0, 2, 1, 3)


def _f32(arrays):
    return [torch.tensor(a, dtype=torch.float32) for a in arrays]


def test_tf32_rounding_is_to_nearest_ties_away():
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 2.0 ** -12,
                      1.0 + 3 * 2.0 ** -11, 3.0e-40, 0.0, -0.0])
    want = torch.tensor([1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10), 1.0,
                         1.0 + 2.0 ** -9, _tf32(torch.tensor([3.0e-40]))[0], 0.0, -0.0])
    got = _tf32(x)
    assert torch.equal(got, want) and bool((got.view(torch.int32) & 0x1FFF == 0).all())
    hi = _tf32(x[:4])
    assert torch.equal(hi + _tf32(x[:4] - hi), x[:4])    # two parts carry 22 bits


@pytest.mark.parametrize("b,sq,skv,kv,g,d,causal,window,dtype", CASES)
def test_f32_kernel_arithmetic_matches_reference(b, sq, skv, kv, g, d, causal, window, dtype):
    """The emulated float32 kernel against the Pallas kernel (interpret) and
    the oracle at float32's 2e-5, on the cases' shapes in float32."""
    arrays = _inputs(sq * 1000 + skv + d, b, sq, skv, kv * g, kv, d)
    out = _emulate_f32(*_f32(arrays), causal, window).numpy()
    pallas, oracle = _reference(arrays, "float32", causal, window, g)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)


@given(
    b=st.integers(1, 2),
    sq=st.integers(1, 200),
    skv=st.integers(1, 200),
    h=st.sampled_from([1, 2]),
    g=st.sampled_from([1, 2]),
    d=st.sampled_from([32, 64]),
    causal=st.booleans(),
    window=st.sampled_from([None, 17, 64]),
)
@SET
def test_f32_kernel_arithmetic_sweep(b, sq, skv, h, g, d, causal, window):
    """The sweep's draws in float32 through the emulated kernel, against the
    Pallas kernel and the oracle at 2e-5."""
    if causal and sq > skv:
        sq = skv
    arrays = _inputs(abs(hash((b, sq, skv, h, g, d))) % 2**31, b, sq, skv, h * g, h, d)
    out = _emulate_f32(*_f32(arrays), causal, window).numpy()
    pallas, oracle = _reference(arrays, "float32", causal, window, g)
    np.testing.assert_allclose(out, pallas, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(out, oracle, rtol=2e-5, atol=2e-5)


def test_one_tf32_product_misses_the_f32_tolerance():
    """qwen3-4b's head size (128, 4 query heads a KV head), 256 causal
    tokens: three TF32 products hold 2e-5 against the plain version, one
    (hi.hi, the TF32 rounding of every operand) misses it, which is why
    the kernel pays for three."""
    arrays = _f32(_inputs(41, 1, 256, 256, 8, 2, 128))
    ref = flash_attention_reference(*arrays, True, None)
    three = _emulate_f32(*arrays, True, None)
    one = _emulate_f32(*arrays, True, None, products=1)
    torch.testing.assert_close(three, ref, rtol=2e-5, atol=2e-5)
    assert not torch.allclose(one, ref, rtol=2e-5, atol=2e-5)
    assert float((one - ref).abs().max()) > 10 * float((three - ref).abs().max())


@pytest.mark.parametrize("d", fa_ops.HEAD_DIMS)
def test_f32_tile_plan_fits_the_card(d):
    plan = fa_kernel.TILE_PLAN_F32[d]
    assert plan.bq == 64 and plan.bk % 8 == 0 and plan.bk <= 64 and plan.stages >= 2
    assert fa_kernel.smem_bytes_f32(d, plan) <= fa_kernel.SMEM_LIMIT == 232448
    # one 64-row q tile's four warps of 16 rows, two blocks an SM up to D = 128
    assert fa_kernel.smem_bytes_f32(d, plan) <= (fa_kernel.SMEM_LIMIT // 2 if d <= 128
                                                 else fa_kernel.SMEM_LIMIT)


def test_f32_tile_plan_is_what_the_source_instantiates():
    src = (Path(fa_kernel.__file__).parents[1] / "csrc" / "flash_attention_f32.cu").read_text()
    planned = {(d, p.bk, p.stages) for d, p in fa_kernel.TILE_PLAN_F32.items()}
    built = {tuple(map(int, t)) for t in re.findall(r"FA32_PLAN\((\d+), (\d+), (\d+)\)\n", src)}
    assert planned == built
    assert "kWarps = 4" in src and "kBQ = 16 * kWarps" in src
    assert "kLdQK = D + 16" in src and "kLdV = D + 4" in src
