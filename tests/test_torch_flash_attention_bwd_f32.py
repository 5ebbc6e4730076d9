"""The float32 route of the attention backward kernel
(``csrc/flash_attention_bwd.cu``: three TF32 ``mma.sync`` products per
product) emulated on the CPU, against ``jax.grad`` of the JAX package's
``models/layers.py`` attention and the port's plain explicit backward.

``_emulate_bwd_f32`` repeats the kernel's arithmetic in torch: its tiles
from ``TILE_PLAN_BWD_F32`` (dv and dk over the query heads of a KV head in
order and q steps of ``bq`` rows, dq over key steps of ``bk`` keys); the
score products s = q k^T and dp = dout v^T as three sums over the kernel's
8-dim k-steps (hi.lo, lo.hi, hi.hi, each operand split as hi = rna(x) to
TF32 and lo = rna(x - hi)), added small terms first; p = exp2(s scale log2e
- lse log2e) as one fused multiply-add, exactly 0 where the mask drops the
pair; ds = p (dp - delta); and dv += p^T dout, dk += ds^T q, dq += ds k, each
step's share summed from 0 over 8-row k-steps (hi.lo, lo.hi, hi.hi in that
order, p and ds split too) and added to the running sum in one rounding.
Sums round to nearest here; the tensor core's own rounding of its float32
sums (toward zero) is held by the kernel's tests on the card
(``tests/test_torch_cuda.py``).  The tolerance is the training slice's:
``rtol=1e-4, atol=1e-5``."""
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from repro.models import layers as r_layers

import repro_torch.kernels.flash_attention.kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import (flash_attention_backward_reference,
                                                     flash_attention_reference)
from test_torch_train_grads import ATTN_GRAD_CASES

LOG2E = math.log2(math.e)


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits), to nearest with ties away from
    zero: cvt.rna.tf32.f32, on the int32 view."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _score_ksteps(d):
    """Head dims of each 8-dim k-step of a score product: unit u (16 dims)
    gives thread t dims dc .. dc + 3, dc = 32 (u // 2) + 8 t + 4 (u % 2),
    its first two as k slots t and t + 4 of one k-step, its last two of the
    next."""
    for u in range(d // 16):
        for s in (0, 1):
            yield [32 * (u // 2) + 8 * t + 4 * (u % 2) + 2 * s + c
                   for c in (0, 1) for t in range(4)]


def _score(a, b, ksteps, products):
    """a b^T over the last dim in the kernel's k-steps: three sums (hi.lo,
    lo.hi, hi.hi) added small terms first, or with ``products=1`` hi.hi
    alone."""
    hl = lh = hh = 0
    for dims in ksteps:
        (ah, al), (bh, bl) = _split(a[..., dims]), _split(b[..., dims].transpose(-1, -2))
        hl, lh, hh = hl + ah @ bl, lh + al @ bh, hh + ah @ bh
    return (hl + lh) + hh if products == 3 else hh


def _rows_product(p, x, products):
    """p x summed from 0 over 8-row k-steps of x (p's 8 columns), each
    k-step hi.lo, lo.hi, hi.hi in that order (hi.hi alone with
    ``products=1``)."""
    out = 0
    for j in range(0, p.shape[-1], 8):
        (ph, pl), (xh, xl) = _split(p[..., j:j + 8]), _split(x[..., j:j + 8, :])
        if products == 3:
            out = out + ph @ xl
            out = out + pl @ xh
        out = out + ph @ xh
    return out


def _keep(rows, cols, Sq, Skv, causal, window):
    keep = (rows[:, None] < Sq) & (cols[None] < Skv)
    if causal:
        keep &= cols[None] <= rows[:, None]
    if window is not None:
        keep &= cols[None] > rows[:, None] - window
    return keep


def _p(s, lse_l2, keep, sl2):
    """exp2(s sl2 - lse log2e) as the kernel's one fused multiply-add, 0
    where the mask drops the pair."""
    x = (s.double() * sl2 - lse_l2.double()).float()
    return torch.where(keep, torch.exp2(x), torch.zeros(()))


def _emulate_bwd_f32(q, k, v, o, lse, do, causal=True, window=None, products=3):
    """``(dq, dk, dv)`` as the float32 kernel computes them, from the
    forward's o and row log-sum-exp lse (B, H, Sq)."""
    B, Sq, H, D = q.shape
    Skv, KV = k.shape[1], k.shape[2]
    G = H // KV
    plan = fa_kernel.TILE_PLAN_BWD_F32[D]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    sl2 = float(scale * torch.tensor(LOG2E, dtype=torch.float32))
    ksteps = list(_score_ksteps(D))
    delta = (do * o).sum(-1).permute(0, 2, 1)                 # (B, H, Sq)
    lse_l2 = lse * torch.tensor(LOG2E, dtype=torch.float32)
    # (B, heads, S, D), zero rows padded to the steps
    sq_pad = -(-Sq // max(plan.bq, plan.bk)) * max(plan.bq, plan.bk)
    skv_pad = -(-Skv // max(plan.bq, plan.bk)) * max(plan.bq, plan.bk)

    def heads(x, S, pad):
        x = x.permute(0, 2, 1, 3)
        return torch.cat([x, x.new_zeros(*x.shape[:2], pad - S, D)], 2)

    qh, doh = heads(q, Sq, sq_pad), heads(do, Sq, sq_pad)
    kh, vh = heads(k, Skv, skv_pad), heads(v, Skv, skv_pad)
    pad_rows = lambda x: torch.cat([x, x.new_zeros(*x.shape[:2], sq_pad - Sq)], 2)
    L, Dl = pad_rows(lse_l2), pad_rows(delta)
    keys = torch.arange(skv_pad)

    # dv and dk: for each KV head, its query heads in order, q steps of bq
    dv = torch.zeros(B, KV, skv_pad, D)
    dk = torch.zeros(B, KV, skv_pad, D)
    for g in range(G):
        hs = [kvh * G + g for kvh in range(KV)]
        for q0 in range(0, Sq, plan.bq):
            rows = torch.arange(q0, q0 + plan.bq)
            qt, dot = qh[:, hs, q0:q0 + plan.bq], doh[:, hs, q0:q0 + plan.bq]
            keep = _keep(rows, keys, Sq, Skv, causal, window).T           # (keys, rows)
            st = _score(kh, qt, ksteps, products)                          # K q^T
            pt = _p(st, L[:, hs, None, q0:q0 + plan.bq], keep, sl2)
            dpt = _score(vh, dot, ksteps, products)                        # V dout^T
            dst = pt * (dpt - Dl[:, hs, None, q0:q0 + plan.bq])
            dv = dv + _rows_product(pt, dot, products)
            dk = dk + _rows_product(dst, qt, products)
    # dq: key steps of bk (the kernel's kv loop; 64-row tiles do not change
    # a row's sums)
    dq = torch.zeros(B, H, sq_pad, D)
    kv_of = [h // G for h in range(H)]
    rows = torch.arange(sq_pad)
    for kv0 in range(0, Skv, plan.bk):
        cols = torch.arange(kv0, kv0 + plan.bk)
        kt, vt = kh[:, kv_of, kv0:kv0 + plan.bk], vh[:, kv_of, kv0:kv0 + plan.bk]
        keep = _keep(rows, cols, Sq, Skv, causal, window)
        p = _p(_score(qh, kt, ksteps, products), L[..., None], keep, sl2)
        ds = p * (_score(doh, vt, ksteps, products) - Dl[..., None])
        dq = dq + _rows_product(ds, kt, products)
    unheads = lambda x, S: x[:, :, :S].permute(0, 2, 1, 3).contiguous()
    return (unheads(dq * scale, Sq), unheads(dk * scale, Skv), unheads(dv, Skv))


def _case_inputs(case, d):
    b, sq, skv, kv, g, causal, window = case
    rng = np.random.default_rng(sum(case[:5]) + d)
    q = rng.normal(size=(b, sq, kv * g, d)).astype(np.float32)
    k = rng.normal(size=(b, skv, kv, d)).astype(np.float32)
    v = rng.normal(size=(b, skv, kv, d)).astype(np.float32)
    do = rng.normal(size=q.shape).astype(np.float32)
    return q, k, v, do


def _jax_grads(q, k, v, do, causal, window):
    def loss(q_, k_, v_):
        out = r_layers.attention(q_, k_, v_, causal=causal, window=window, chunk=16)
        return jnp.sum(out * do)

    return [np.asarray(x) for x in
            jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x) for x in (q, k, v)))]


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("case", ATTN_GRAD_CASES)
def test_f32_backward_kernel_arithmetic_matches_jax_grad(case, d):
    """The emulated float32 kernel (from the plain forward's o and lse)
    against ``jax.grad`` of ``layers.attention`` and against the plain
    explicit backward, within rtol 1e-4, atol 1e-5, on the training slice's
    gradient cases at head sizes 32 to 256."""
    _, _, _, _, _, causal, window = case
    q, k, v, do = _case_inputs(case, d)
    want = _jax_grads(q, k, v, do, causal, window)
    qt, kt, vt, dot = (torch.as_tensor(x) for x in (q, k, v, do))
    o, lse = flash_attention_reference(qt, kt, vt, causal, window, return_lse=True)
    got = _emulate_bwd_f32(qt, kt, vt, o, lse, dot, causal, window)
    plain = flash_attention_backward_reference(qt, kt, vt, o, lse, dot, causal, window)
    for name, x, w, y in zip("qkv", got, want, plain):
        np.testing.assert_allclose(x.numpy(), w, rtol=1e-4, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4, atol=1e-5, err_msg=name)


def test_f32_backward_gives_zero_dq_on_rows_without_a_key():
    """Rows that see no key (a window that ends past Skv) get exactly zero
    dq and add nothing to dk and dv, as the kernel's masks give."""
    rng = np.random.default_rng(5)
    q, do = (torch.as_tensor(rng.normal(size=(1, 40, 2, 32)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(1, 20, 1, 32)), dtype=torch.float32)
            for _ in range(2))
    o, lse = flash_attention_reference(q, k, v, False, 4, return_lse=True)
    dq, dk, dv = _emulate_bwd_f32(q, k, v, o, lse, do, False, 4)
    dead = ~torch.isfinite(lse[0, 0])
    assert bool(dead.any()) and bool((dq[:, dead] == 0).all())
    want = flash_attention_backward_reference(q, k, v, o, lse, do, False, 4)
    for x, y in zip((dq, dk, dv), want):
        torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def test_one_tf32_product_misses_the_backward_tolerance():
    """qwen3-4b's head size (128, 4 query heads a KV head), 256 causal
    tokens: three TF32 products a product hold 1e-4 of the largest gradient
    against the plain backward, one (hi.hi, every operand rounded to TF32
    once, p and ds too) misses it, which is why the kernel pays for
    three."""
    rng = np.random.default_rng(41)
    q, do = (torch.as_tensor(rng.normal(size=(1, 256, 8, 128)), dtype=torch.float32)
             for _ in range(2))
    k, v = (torch.as_tensor(rng.normal(size=(1, 256, 2, 128)), dtype=torch.float32)
            for _ in range(2))
    o, lse = flash_attention_reference(q, k, v, True, None, return_lse=True)
    want = flash_attention_backward_reference(q, k, v, o, lse, do, True, None)
    three = _emulate_bwd_f32(q, k, v, o, lse, do, True, None)
    one = _emulate_bwd_f32(q, k, v, o, lse, do, True, None, products=1)
    for x3, x1, y in zip(three, one, want):
        scale = float(y.abs().max())
        e3, e1 = float((x3 - y).abs().max()), float((x1 - y).abs().max())
        assert e3 <= 1e-4 * scale < e1 and e1 > 10 * e3, (e3, e1, scale)


@pytest.mark.parametrize("d", sorted(fa_kernel.TILE_PLAN_BWD_F32))
def test_bwd_f32_tile_plan_fits_the_card(d):
    """Each plan's largest launch fits a block's shared memory, in float32
    and (the plan bf16 takes at D = 256) in bf16; steps cut into 16-row
    units and the blocks' 64 rows."""
    plan = fa_kernel.TILE_PLAN_BWD_F32[d]
    assert plan.bq % 16 == 0 and plan.bk % 16 == 0 and plan.stages >= 2
    assert fa_kernel.BWD_ROWS % plan.bq == 0 and fa_kernel.BWD_ROWS % plan.bk == 0
    assert fa_kernel.smem_bytes_bwd_f32(d, plan) <= fa_kernel.SMEM_LIMIT == 232448
    assert fa_kernel.smem_bytes_bwd_f32(d, plan, itemsize=2) <= fa_kernel.SMEM_LIMIT // 2


def test_bwd_f32_tile_plan_is_what_the_source_instantiates():
    """The source's plans are TILE_PLAN_BWD_F32, its blocks BWD_ROWS rows of
    four warps, its tiles at D plus 16 bytes a row (what
    ``smem_bytes_bwd_f32`` counts), and no product left on the CUDA cores."""
    src = (Path(fa_kernel.__file__).parents[1] / "csrc" / "flash_attention_bwd.cu").read_text()
    planned = {(d, p.bq, p.bk, p.stages) for d, p in fa_kernel.TILE_PLAN_BWD_F32.items()}
    built = {tuple(map(int, t)) for t in
             re.findall(r"FA_BWD_F32_PLAN\((\d+), (\d+), (\d+), (\d+)\)\n", src)}
    assert planned == built
    assert "kMmaWarps = 4;" in src and "kRows = 16 * kMmaWarps;" in src
    assert fa_kernel.BWD_ROWS == 16 * 4
    assert "kLd = D + 16 / static_cast<int>(sizeof(T));" in src
    assert "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32" in src
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in src
    for gone in ("launch_d(", "dot_tile", "acc_tn", "acc_nn", "softmax_grad",
                 "attn_bwd_dkdv"):
        assert gone not in src, gone
