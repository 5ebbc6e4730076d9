#!/usr/bin/env python3
"""The embedding_bag, attention, attention backward, embedding_bag backward,
vm_step and segment_spmm kernels of this checkout against those of another checkout (for
example its parent commit), on the GPU, at the main path's shapes.

Run from the root of a checkout, on the machine with the card:

    python3 tools/kernel_compare.py --other DIR [--plan NAME:CONST=VALUE[,...] ...]
                                    [--only SECTION ...]

DIR is the root of the other checkout (``git archive`` of a commit unpacked
into a git-ignored directory such as ``archive/parent``).  Both checkouts'
``csrc/embedding_bag.cu``, ``csrc/flash_attention_f32.cu``,
``csrc/flash_attention_bf16.cu``, ``csrc/flash_attention_bwd.cu``,
``csrc/embedding_bag_bwd.cu``, ``csrc/vm_step.cu`` and ``csrc/segment_spmm.cu``
are built with nvcc
(``sm_90a``) into the git-ignored ``kernels/build/compare/``, and each
kernel is timed in turns (other, this, this, other) with CUDA events over
back-to-back launches and, for the bag kernel, also as device time per
launch from a ``torch.profiler`` trace (at serve_p99 the launches are
host-bound):

  embedding_bag on dlrm-rm2's 33,762,577 x 64 table (random, on the card)
      at serve_bulk (ClickLogPipeline ids of 262,144 requests x 26 fields,
      multi_hot 8: 6,815,744 bags of one id in all 8 slots), at serve_p99
      (512 requests: 13,312 bags) and on independent zipf ids over the whole
      table (16,384 x 26 bags of 8), as chip_smoke.py makes them;
  flash_attention_f32 at 4 x 4,096 tokens, 32 query and 8 KV heads of 128,
      causal, random float32 q, k, v, and flash_attention_bf16 on the same
      q, k, v in bf16 (the log-sum-exp pointer, where an entry point takes
      one, null: the serving path's launch);
  flash_attention_bwd at qwen3-4b's training shape, 1 x 4,096 tokens, 32
      query and 8 KV heads of 128, causal, bf16 (the wgmma route); in
      float32 (the mma.sync route) at the float32 gate's 1 x 2,048 and at
      4 x 4,096; and in bf16 at gemma3-4b's head size 256 (1 x 4,096, 8
      query and 4 KV heads, causal, and causal with a window of 1,024):
      random q, k, v and output gradient, o and the row log-sum-exp from
      this checkout's forward kernel;
  embedding_bag_bwd at DLRM's train_batch (path 8's last step's
      ClickLogPipeline ids: 1,703,936 bags of 8 over the 33,762,577-row
      table, d = 64; random output gradient): each checkout's kernels from
      this checkout's CSR (each at its own LONG_SLOTS; the run list where
      its entry point takes one), timed in turns, split by kernel with the
      profiler and, where the source takes ``parts``, each kernel alone;
      then this checkout's wrapper with its CSR, and its device time by op
      and its host syncs under the profiler;
  vm_step at the provgen invocation's shapes: provgen_like(1,000,000)'s
      dst-sorted CSR (its row plan), PQ1-4's 23-node trie, random alpha and
      weights, 57.5% of the edges live (path 1's share), alpha as many rows
      as the output (the entry point's n_in and n_out, or its one n).

The two bag kernels, the two bag backwards (each also with the plain
backward on the card) and the two vm_step kernels must agree bit for bit
(vm_step also with its plain version), the two segment_spmm kernels and
their plain version, and so must the two float32 and the
two bf16 attention outputs; both float32 attention kernels within 2e-5 of
the plain version.  Each checkout's attention backward must give dq, dk
and dv within 2^-7 (bf16) or 1e-4 (float32) of the largest plain gradient
(plus 1e-6) of the plain backward, and the same bits on a second launch; the two checkouts'
backwards are not held to each other's bits (their sums may run in other
orders).  Each ``--plan`` builds this checkout's ``flash_attention_bwd.cu``
once more with the named ``constexpr int`` constants replaced (the wgmma
route's tile plan: ``kRowsV``, ``kStagesV``, ``kRowsK``, ``kStagesK``,
``kKeysB``, ``kStagesB``; the mma.sync route's ``kMmaWarps``, its
``kScoreUnroll`` and, as ``plan<D>=bq/bk/stages``, its tile plan at head
size D), and the attention backward times
and checks that build in the same turns, for example
``--plan dv64:kRowsV=64 --plan k128:kRowsK=128``; a plan that does not
build is reported and left out.  ``--only`` runs the named sections
(``embedding_bag``, ``flash_attention``, ``flash_attention_bwd``,
``embedding_bag_bwd``, ``vm_step``, ``segment_spmm``) and builds only their sources.  Prints
each build's ptxas registers,
spills and wgmma serialisation notes (C7512), the card's name and power
limit and one line per shape; exits non-zero without CUDA or nvcc.
"""
from __future__ import annotations

import argparse
import ctypes
import math
import re
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
CSRC = Path("src/repro_torch/kernels/csrc")
OUT = ROOT / "src" / "repro_torch" / "kernels" / "build" / "compare"
KERNELS = ("embedding_bag", "flash_attention_f32", "flash_attention_bf16",
           "flash_attention_bwd", "embedding_bag_bwd", "vm_step", "segment_spmm")
#: --only's choices: each section and the sources it builds
SECTIONS = {"embedding_bag": ("embedding_bag",),
            "flash_attention": ("flash_attention_f32", "flash_attention_bf16"),
            "flash_attention_bwd": ("flash_attention_bwd",),
            "embedding_bag_bwd": ("embedding_bag_bwd",),
            "vm_step": ("vm_step",),
            "segment_spmm": ("segment_spmm",)}


def plan_sources(specs):
    """{name: source text} of this checkout's backward with each spec's
    (``NAME:CONST=VALUE,...``) constants replaced."""
    text = (ROOT / CSRC / "flash_attention_bwd.cu").read_text()
    out = {}
    for spec in specs:
        name, _, subs = spec.partition(":")
        plan = text
        for sub in filter(None, subs.split(",")):
            const, value = sub.split("=")
            if const.startswith("plan"):   # plan<D>=bq/bk/stages of the mma.sync route
                d = int(const[4:])
                bq, bk, st = (int(x) for x in value.split("/"))
                plan, n = re.subn(rf"FA_BWD_F32_PLAN\({d}, \d+, \d+, \d+\)\n",
                                  f"FA_BWD_F32_PLAN({d}, {bq}, {bk}, {st})\n", plan)
            else:
                plan, n = re.subn(rf"constexpr int {const} = \d+;",
                                  f"constexpr int {const} = {int(value)};", plan)
            if n != 1:
                raise SystemExit(f"--plan {name}: the source has no constant {const}")
        out[name] = plan
    return out


def build(roots, plans, kernels=KERNELS):
    """{(tag, kernel): library} for every checkout and kernel, and
    (plan, "flash_attention_bwd") for every plan that builds; nvcc in
    parallel."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.build import NVCC_FLAGS, _nvcc

    sources = {(tag, name): root / CSRC / f"{name}.cu"
               for tag, root in roots.items() for name in kernels}
    for name, text in plans.items():
        (OUT / "plans").mkdir(parents=True, exist_ok=True)
        sources[name, "flash_attention_bwd"] = OUT / "plans" / f"{name}.cu"
        sources[name, "flash_attention_bwd"].write_text(text)
    procs = {}
    for key, src in sources.items():
        (OUT / key[0]).mkdir(parents=True, exist_ok=True)
        lib = OUT / key[0] / f"lib{key[1]}.so"
        procs[key] = (lib, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(lib), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0 and key[0] in plans:
            print(f"[build] plan {key[0]}: nvcc failed, left out: "
                  f"{[line.strip()[:160] for line in log.splitlines() if 'error' in line][:2]}",
                  flush=True)
            continue
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed:\n{log}")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "C7512" in line:
                print(f"[build] {key[0]} {key[1]}: {line.strip()}", flush=True)
        libs[key] = lib
    return libs


def bag_launcher(lib):
    fn = ctypes.CDLL(str(lib)).embedding_bag_launch
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def attn_launcher(lib, source, d, name="flash_attention_f32"):
    """An attention entry point (``name``), whether it takes a tile plan,
    the score scale it takes at head size ``d`` (the earlier CUDA-core
    kernel takes no plan and 1 / sqrt(d)), and whether it takes a row
    log-sum-exp pointer before the stream (passed as null: no lse)."""
    fn = getattr(ctypes.CDLL(str(lib)), f"{name}_launch")
    planned = bool(re.search(r"int D, int bk, int stages", source))
    with_lse = "void* lse, void* stream" in source
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * (10 if planned else 8)
                   + [ctypes.c_longlong, ctypes.c_float] + [ctypes.c_void_p] * (1 + with_lse))
    fn.restype = ctypes.c_int
    scale = (math.log2(math.e) if "scale_log2" in source else 1.0) / math.sqrt(d)
    return fn, planned, scale, with_lse


def vm_launcher(lib, source):
    """The vm_step entry point, and whether it takes n_out and n_in (an
    earlier kernel takes one n for both)."""
    fn = ctypes.CDLL(str(lib)).vm_step_launch
    split = "int n_out, int n_in" in source
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * (4 if split else 3)
                   + [ctypes.c_void_p, ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, split


def bag_bwd_launcher(lib, source):
    """The bag backward's entry point, and whether it takes the run list
    and ``parts`` (its launches alone); an earlier source takes neither."""
    fn = ctypes.CDLL(str(lib)).embedding_bag_bwd_launch
    parts = "int parts" in source
    fn.argtypes = ([ctypes.c_void_p] * (7 if parts else 4)
                   + [ctypes.c_int, ctypes.c_void_p, ctypes.c_longlong]
                   + [ctypes.c_int] * (4 if parts else 3) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, parts


def long_slots(root):
    """A checkout's ``LONG_SLOTS``: the slots past which its backward's row
    goes to the long-row kernel."""
    text = (root / "src/repro_torch/kernels/embedding_bag/ops.py").read_text()
    return int(re.search(r"^LONG_SLOTS = (\d+)", text, re.M).group(1))


def short_name(name):
    """A kernel's name without its namespaces, template arguments and
    parameters; other names as they are, cut to 60 characters."""
    m = re.search(r"(\w+)(<[^>]*>)?\(", name)
    return m.group(1) if m and not name.startswith("aten::") else name[:60]


def kernel_split(torch, fn, reps):
    """{kernel: device ms a call}: each kernel's intervals in a
    ``torch.profiler`` trace of ``reps`` calls, over ``reps``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            name = short_name(e.name)
            out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def op_split(torch, fn, reps, top=14):
    """[(op, calls a call, self device ms a call, host ms a call)] of the
    ``top`` ops by self device time under ``fn``, and the host syncs and
    device-to-host copies it made, from a ``torch.profiler`` trace."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows, syncs = [], []
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0)
        rows.append((short_name(e.key), e.count / reps, dev_us / 1e3 / reps,
                     e.cpu_time_total / 1e3 / reps))
        if "Synchronize" in e.key or "Memcpy" in e.key or e.key == "aten::item":
            syncs.append((e.key, e.count / reps))
    rows.sort(key=lambda r: -r[2])
    return rows[:top], syncs


def time_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    ev0, ev1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ev0.record()
    for _ in range(reps):
        fn()
    ev1.record()
    torch.cuda.synchronize()
    return ev0.elapsed_time(ev1) / reps


def device_ms(torch, fn, reps):
    """The device time of one call of ``fn`` (the sum of its kernels'
    intervals in a ``torch.profiler`` trace of ``reps`` calls, over
    ``reps``): free of the host time between launches, which bounds
    back-to-back launches of a small kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        raise SystemExit("kernel_compare: the profiler traced no device event")
    return sum(r.end - r.start for r in spans) / 1e3 / reps


def in_turns(torch, calls, reps, timer=time_ms):
    """{tag: [ms, ms]} timed other, this (, the plans), then in the
    reverse order."""
    order = ["other", "this"] + [tag for tag in calls if tag not in ("other", "this")]
    out = {tag: [] for tag in calls}
    for tag in order + order[::-1]:
        out[tag].append(timer(torch, calls[tag], reps))
    return out


def bag_section(torch, np, c):
    """embedding_bag: the two checkouts' forward kernels in turns at path 2's shapes."""
    card, libs, roots, dev, stream = c.card, c.libs, c.roots, c.dev, c.stream
    import dataclasses

    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_reference
    from repro_torch.models.dlrm import table_offsets

    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = dataclasses.replace(get_config("dlrm-rm2"), multi_hot=8)
    V, d = cfg.total_rows(), cfg.embed_dim
    table = torch.randn((V, d), generator=gen, device=dev) / math.sqrt(d)
    shapes = {s.name: s.dim("batch") for s in DLRM_SHAPES}
    ids = {name: torch.as_tensor(next(ClickLogPipeline(cfg, shapes[name], seed=seed))["sparse"]
                                 .reshape(-1, cfg.multi_hot), device=dev)
           for seed, name in ((1, "serve_p99"), (2, "serve_bulk"))}
    rng = np.random.default_rng(7)
    offsets = table_offsets(cfg)
    cols = [np.minimum((v * rng.random((16384, 8)) ** 3.0).astype(np.int64), v - 1)
            + offsets[f] for f, v in enumerate(cfg.vocab_sizes)]
    ids["zipf"] = torch.as_tensor(np.stack(cols, axis=1).reshape(-1, 8).astype(np.int32),
                                  device=dev)
    bags = {tag: bag_launcher(libs[tag, "embedding_bag"]) for tag in roots}
    for name, x in ids.items():
        B, H = x.shape
        outs = {tag: torch.empty((B, d), device=dev) for tag in roots}

        def call(tag, x=x, B=B, H=H):
            err = bags[tag](table.data_ptr(), x.data_ptr(), outs[tag].data_ptr(), V, d, B, H,
                            0, stream)
            if err:
                raise SystemExit(f"embedding_bag ({tag}) launch failed: CUDA error {err}")

        calls = {tag: (lambda tag=tag: call(tag)) for tag in roots}
        ms = in_turns(torch, calls, 20 if B < 100_000 else 10)
        dev_ms = in_turns(torch, calls, 20, device_ms)
        plain = embedding_bag_reference(table, x)
        same = bool(torch.equal(outs["this"], outs["other"]))
        ok = bool(torch.allclose(outs["this"], plain, rtol=1e-4, atol=1e-5))
        distinct = int(torch.unique(x).numel())
        bound = 4 * (B * H + distinct * d + B * d) / 3.35e12 * 1e3
        print(f"[bag] {name}: bags {B}, H={H}, d={d}, distinct rows {distinct}; ms per "
              f"launch other {ms['other'][0]:.4f} / {ms['other'][1]:.4f}, this "
              f"{ms['this'][0]:.4f} / {ms['this'][1]:.4f}; device ms per launch (profiler) "
              f"other {dev_ms['other'][0]:.4f} / {dev_ms['other'][1]:.4f}, this "
              f"{dev_ms['this'][0]:.4f} / {dev_ms['this'][1]:.4f}; bound {bound:.4f} ms by bytes; "
              f"this == other bitwise {same}; this vs plain allclose {ok}; {card}",
              flush=True)
        if not (same and ok):
            return 1
        del outs, plain
    del table, ids
    torch.cuda.empty_cache()
    return 0


def attention_section(torch, np, c):
    """flash_attention_f32 and flash_attention_bf16 in turns at 4 x 4,096."""
    card, libs, roots, dev, stream = c.card, c.libs, c.roots, c.dev, c.stream
    from repro_torch.kernels.flash_attention.kernel import TILE_PLAN, TILE_PLAN_F32
    from repro_torch.kernels.flash_attention.ref import flash_attention_reference

    gen = torch.Generator(device=dev).manual_seed(1)
    B, S, H, KV, D = 4, 4096, 32, 8, 128
    q = torch.randn((B, S, H, D), generator=gen, device=dev)
    k = torch.randn((B, S, KV, D), generator=gen, device=dev)
    v = torch.randn((B, S, KV, D), generator=gen, device=dev)
    ref = flash_attention_reference(q, k, v)
    attn = {tag: attn_launcher(libs[tag, "flash_attention_f32"],
                               (roots[tag] / CSRC / "flash_attention_f32.cu").read_text(), D)
            for tag in roots}
    outs = {tag: torch.empty_like(q) for tag in roots}
    plan = TILE_PLAN_F32[D]

    def attend(tag, attn=attn, outs=outs, q=q, k=k, v=v, plan=plan):
        fn, planned, scale, with_lse = attn[tag]
        extra = [plan.bk, plan.stages] if planned else []
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), outs[tag].data_ptr(), B, S, S, H,
                 KV, D, *extra, 1, 0, 0, scale, *([None] if with_lse else []), stream)
        if err:
            raise SystemExit(f"flash_attention ({tag}) launch failed: CUDA error {err}")

    ms = in_turns(torch, {tag: (lambda tag=tag: attend(tag)) for tag in roots}, 5)
    flops = 4 * D * (S * (S + 1) // 2) * B * H
    errs = {tag: float((outs[tag] - ref).abs().max()) for tag in roots}
    same = bool(torch.equal(outs["this"], outs["other"]))
    print(f"[attn f32] B={B} S={S} H={H} KV={KV} D={D} causal: ms per launch other "
          f"{ms['other'][0]:.4f} / {ms['other'][1]:.4f}, this {ms['this'][0]:.4f} / "
          f"{ms['this'][1]:.4f} ({flops / min(ms['this']) / 1e9:.1f} TFLOP/s); bound "
          f"{3 * flops / 495e12 * 1e3:.4f} ms at the TF32 tensor-core rate (three products), "
          f"{flops / 67e12 * 1e3:.4f} ms at the float32 CUDA-core rate; max_abs_err vs plain "
          f"other {errs['other']:.3e}, this {errs['this']:.3e}; this == other bitwise "
          f"{same}; {card}", flush=True)
    if max(errs.values()) > 2e-5 + 2e-5 * float(ref.abs().max()):
        return 1

    # the same q, k, v in bf16
    q, k, v = (t.to(torch.bfloat16) for t in (q, k, v))
    attn = {tag: attn_launcher(libs[tag, "flash_attention_bf16"],
                               (roots[tag] / CSRC / "flash_attention_bf16.cu").read_text(), D,
                               "flash_attention_bf16")
            for tag in roots}
    outs = {tag: torch.empty_like(q) for tag in roots}
    plan = TILE_PLAN[D]
    ms = in_turns(torch, {tag: (lambda tag=tag: attend(tag, attn, outs, q, k, v, plan))
                          for tag in roots}, 20)
    same_bf16 = bool(torch.equal(outs["this"], outs["other"]))
    print(f"[attn bf16] B={B} S={S} H={H} KV={KV} D={D} causal: ms per launch other "
          f"{ms['other'][0]:.4f} / {ms['other'][1]:.4f}, this {ms['this'][0]:.4f} / "
          f"{ms['this'][1]:.4f} ({flops / min(ms['this']) / 1e9:.1f} TFLOP/s); this == other "
          f"bitwise {same_bf16}; {card}", flush=True)
    if not (same and same_bf16):
        return 1
    del q, k, v, ref, outs
    torch.cuda.empty_cache()
    return 0


#: the attention backward's shapes: (label, B, S, H, KV, D, dtype, window,
#: reps): qwen3-4b's training shape in bf16 (the wgmma route), the float32
#: route at the float32 gate's shape and at the float32 forward's 4 x
#: 4,096, and bf16 at gemma3-4b's head size 256, global and local (window
#: 1,024); all causal
BWD_SHAPES = [("bf16", 1, 4096, 32, 8, 128, "bfloat16", None, 10),
              ("f32 gate", 1, 2048, 32, 8, 128, "float32", None, 5),
              ("f32 4x4k", 4, 4096, 32, 8, 128, "float32", None, 2),
              ("bf16 d256 global", 1, 4096, 8, 4, 256, "bfloat16", None, 10),
              ("bf16 d256 local", 1, 4096, 8, 4, 256, "bfloat16", 1024, 10)]


def attention_bwd_section(torch, np, c):
    """flash_attention_bwd (and each --plan) in turns at BWD_SHAPES."""
    bwd = {}
    for (tag, name), lib in c.libs.items():
        if name != "flash_attention_bwd":
            continue
        bwd[tag] = ctypes.CDLL(str(lib)).flash_attention_bwd_launch
        bwd[tag].argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p])
        bwd[tag].restype = ctypes.c_int
    return max(attention_bwd_shape(torch, c, bwd, *shape) for shape in BWD_SHAPES)


def bwd_split(torch, fn, reps):
    """{launch: device ms a call} of an attention backward (delta, dv, dk,
    dq) from a ``torch.profiler`` trace of ``reps`` calls: each launch's
    intervals, which overlap where a launch is a programmatic dependent."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        name = ("delta" if "bwd_delta" in e.name else "dq" if "bwd_dq" in e.name
                else "dk" if re.search(r"bwd_dkv\w*<[^>]*(true|\(bool\)1)>", e.name)
                else "dv" if "bwd_dkv" in e.name else short_name(e.name))
        out[name] = out.get(name, 0.0) + (e.time_range.end - e.time_range.start) / 1e3 / reps
    return out


def attention_bwd_shape(torch, c, bwd, label, B, S, H, KV, D, dtype, window, reps):
    """Each checkout's backward at one shape, in turns: random q, k, v and
    output gradient, o and the row log-sum-exp from this checkout's forward
    kernel; each within 2^-7 (bf16) or 1e-4 (float32) of the largest plain
    gradient (plus 1e-6) and equal to itself on a second launch.  Returns 1
    on a failure."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda
    from repro_torch.kernels.flash_attention.ref import flash_attention_backward_reference

    card, dev, stream = c.card, c.dev, c.stream
    gen = torch.Generator(device=dev).manual_seed(2)
    dt = getattr(torch, dtype)
    q, do = (torch.randn((B, S, H, D), generator=gen, device=dev).to(dt) for _ in range(2))
    k, v = (torch.randn((B, S, KV, D), generator=gen, device=dev).to(dt) for _ in range(2))
    fwd = "flash_attention_bf16" if dtype == "bfloat16" else "flash_attention_f32"
    o, lse = flash_attention_cuda(fwd, q, k, v, True, window, with_lse=True)
    grads = {tag: [(torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
                   for _ in range(2)] for tag in bwd}
    delta = torch.empty((B, H, S), dtype=torch.float32, device=dev)

    def backward(tag, i=0):
        dq, dk, dv = grads[tag][i]
        err = bwd[tag](q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
                       lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                       dv.data_ptr(), B, S, S, H, KV, D, int(dtype == "bfloat16"), 1,
                       int(window is not None), window or 0, 1.0 / math.sqrt(D), stream)
        if err:
            raise SystemExit(f"flash_attention_bwd ({tag}) launch failed: error {err}")

    ms = in_turns(torch, {tag: (lambda tag=tag: backward(tag)) for tag in bwd}, reps)
    for tag in bwd:
        backward(tag, 1)
    torch.cuda.synchronize()
    want = flash_attention_backward_reference(q, k, v, o, lse, do, True, window)
    pairs = sum(min(i + 1, window or i + 1) for i in range(S))
    flops = 10 * D * pairs * B * H
    tol = 2.0 ** -7 if dtype == "bfloat16" else 1e-4
    # bf16 at the tensor-core rate; float32 as three TF32 products at theirs
    bound = (flops / 989e12 if dtype == "bfloat16" else 3 * flops / 495e12) * 1e3
    print(f"[attn bwd] {label}: B={B} S={S} H={H} KV={KV} D={D} causal window={window} "
          f"{dtype}: the bound {bound:.4f} ms ({flops} FLOP"
          f"{'' if dtype == 'bfloat16' else ' x 3, 3xTF32'}); {card}", flush=True)
    ok = True
    for tag in bwd:
        errs = [float((x.float() - y.float()).abs().max()) for x, y in zip(grads[tag][0], want)]
        right = all(e <= tol * float(y.float().abs().max()) + 1e-6 for e, y in zip(errs, want))
        repeat = all(bool(torch.equal(x, y)) for x, y in zip(*grads[tag]))
        ok = ok and right and repeat
        split = bwd_split(torch, lambda tag=tag: backward(tag), 2)
        print(f"[attn bwd] {label} {tag}: device ms by launch "
              + ", ".join(f"{k} {t:.4f}" for k, t in split.items()), flush=True)
        print(f"[attn bwd] {label} {tag}: ms per launch "
              f"{' / '.join(f'{t:.4f}' for t in ms[tag])} ({flops / min(ms[tag]) / 1e9:.1f} "
              f"TFLOP/s, {bound / min(ms[tag]):.4f} of the bound); max_abs_err dq/dk/dv vs "
              f"plain {'/'.join(f'{e:.3e}' for e in errs)} (within {tol} of the largest: "
              f"{right}); equal to itself on a second launch: {repeat}; {card}", flush=True)
    del q, k, v, o, lse, do, grads, delta, want
    torch.cuda.empty_cache()
    return 0 if ok else 1


def bag_bwd_section(torch, np, c):
    """embedding_bag_bwd in turns at DLRM's train_batch (path 8's last step's
    ids), each checkout's kernels by the profiler and alone, and this
    checkout's wrapper with its prep by op."""
    card, libs, roots, dev, stream = c.card, c.libs, c.roots, c.dev, c.stream
    import dataclasses

    import repro_torch.kernels.embedding_bag.ops as bag_ops
    from repro_torch.configs.base import DLRM_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.recsys import ClickLogPipeline
    from repro_torch.kernels.embedding_bag.ref import embedding_bag_backward_reference

    cfg = dataclasses.replace(get_config("dlrm-rm2"), multi_hot=8)
    V, d = cfg.total_rows(), cfg.embed_dim
    pipe = ClickLogPipeline(cfg, {s.name: s for s in DLRM_SHAPES}["train_batch"].dim("batch"),
                            seed=11)
    for _ in range(3):
        batch = next(pipe)
    ids = torch.as_tensor(batch["sparse"].reshape(-1, cfg.multi_hot), device=dev)
    B, H = ids.shape
    g = torch.randn((B, d), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    row_ptr, bag, runs = bag_ops.slot_csr(ids, V)
    lengths = row_ptr[1:] - row_ptr[:-1]
    E = int(row_ptr[-1])
    n_runs = int(runs[0][E - 1]) + 1 if E else 0   # the rows' runs: the first in entry order
    bwd = {}
    for tag, root in roots.items():
        fn, parts = bag_bwd_launcher(libs[tag, "embedding_bag_bwd"],
                                     (root / CSRC / "embedding_bag_bwd.cu").read_text())
        T = long_slots(root)
        rows = torch.nonzero(lengths > T).squeeze(1)
        rows = rows[torch.sort(lengths[rows], descending=True, stable=True).indices]
        bwd[tag] = (fn, parts, T, rows.to(torch.int32).contiguous())
    outs = {tag: torch.empty((V, d), device=dev) for tag in roots}

    def launch(tag, part=3):
        fn, parts, T, rows = bwd[tag]
        with_runs = [t.data_ptr() for t in runs] if parts else []
        err = fn(g.data_ptr(), row_ptr.data_ptr(), bag.data_ptr(), *with_runs, rows.data_ptr(),
                 rows.shape[0], outs[tag].data_ptr(), V, d, 4, T, *([part] if parts else []),
                 stream)
        if err:
            raise SystemExit(f"embedding_bag_bwd ({tag}) launch failed: CUDA error {err}")

    ms = in_turns(torch, {tag: (lambda tag=tag: launch(tag)) for tag in roots}, 5)
    plain = embedding_bag_backward_reference(g, ids, V)
    same = bool(torch.equal(outs["this"], outs["other"]))
    exact = {tag: bool(torch.equal(outs[tag], plain)) for tag in roots}
    del plain
    bound = 4 * (B * d + B * H + V * d) / 3.35e12 * 1e3
    yard = 4 * (V * d + n_runs * d + (V + 1) + E) / 3.35e12 * 1e3
    print(f"[bag bwd] train_batch: {B} bags x H={H}, d={d}, V={V}: {E} slots, "
          f"{int((lengths > 0).sum())} rows named, {n_runs} runs of equal bag, the longest row "
          f"{int(lengths.max())} slots; bound {bound:.4f} ms by bytes (g and ids read once, "
          f"the dense gradient written once); gather yardstick {yard:.4f} ms (the dense "
          f"write, one g row a run, the CSR read, at 3.35 TB/s); {card}", flush=True)
    for tag in roots:
        fn, parts, T, rows = bwd[tag]
        split = kernel_split(torch, lambda tag=tag: launch(tag), 3)
        alone = ""
        if parts:
            alone = "; alone: long rows {:.4f} ms, the rest {:.4f} ms".format(
                *(time_ms(torch, lambda tag=tag, p=p: launch(tag, p), 5) for p in (1, 2)))
        print(f"[bag bwd] {tag}: ms per launch {' / '.join(f'{t:.4f}' for t in ms[tag])} "
              f"({bound / min(ms[tag]):.3f} of the bound); {rows.shape[0]} rows past {T} "
              f"slots; device ms a launch by kernel (profiler) "
              f"{', '.join(f'{k} {v:.4f}' for k, v in split.items())}{alone}; equal to the "
              f"plain backward bitwise {exact[tag]}; {card}", flush=True)
    print(f"[bag bwd] this == other bitwise {same}", flush=True)
    if not (same and all(exact.values())):
        return 1
    del outs
    torch.cuda.empty_cache()
    wrapper_ms = time_ms(torch, lambda: bag_ops.embedding_bag_backward(g, ids, V), 3)
    ops, syncs = op_split(torch, lambda: bag_ops.embedding_bag_backward(g, ids, V), 2)
    print(f"[bag bwd] this checkout's wrapper (its CSR and the launch): {wrapper_ms:.4f} ms a "
          f"call; by op (calls, self device ms, host ms a call): "
          f"{'; '.join(f'{k} {n:g} {t:.4f} {h:.3f}' for k, n, t, h in ops)}; host syncs and "
          f"copies a call: {syncs}; {card}", flush=True)
    torch.cuda.empty_cache()
    return 0


def vm_step_section(torch, np, c):
    """vm_step in turns at the provgen invocation's shapes."""
    card, libs, roots, dev, stream = c.card, c.libs, c.roots, c.dev, c.stream
    rng = np.random.default_rng(7)
    from repro_torch.core.rpq import parse_rpq
    from repro_torch.core.tpstry import TPSTry
    from repro_torch.graphs.generators import provgen_like
    from repro_torch.kernels.vm_step.ref import transition_columns, vm_step_reference

    g = provgen_like(1_000_000, avg_degree=6.0, seed=11)
    pq = ["Entity.(Entity)*.Entity", "Agent.Activity.Entity.Entity.Activity.Agent",
          "(Entity)*.Activity.Entity", "Entity.Activity.(Agent)*"]
    trie = TPSTry.from_workload([(parse_rpq(q_), f) for q_, f in
                                 zip(pq, (0.4, 0.2, 0.2, 0.2))]).compile(g.label_names)
    par, val = (torch.as_tensor(a, device=dev) for a in transition_columns(
        trie.parent, trie.label, trie.cond_p, trie.n_labels))
    csr = g.vm_csr().to(dev)
    n, N, E = g.n, trie.n_nodes, int(csr.src.shape[0])
    alpha = torch.as_tensor(rng.random((n, N), dtype=np.float32), device=dev)
    w = rng.random(E, dtype=np.float32) + 0.1
    w[rng.random(E) >= 0.575] = 0.0
    w = torch.as_tensor(w, device=dev)
    row_label = torch.as_tensor(g.labels, device=dev)
    vm = {tag: vm_launcher(libs[tag, "vm_step"],
                           (roots[tag] / CSRC / "vm_step.cu").read_text()) for tag in roots}
    outs = {tag: torch.empty((n, N), device=dev) for tag in roots}

    def step(tag):
        fn, split = vm[tag]
        sizes = [n, n, N, trie.n_labels] if split else [n, N, trie.n_labels]
        err = fn(csr.row_ptr.data_ptr(), csr.src.data_ptr(), w.data_ptr(),
                 row_label.data_ptr(), alpha.data_ptr(), par.data_ptr(), val.data_ptr(),
                 outs[tag].data_ptr(), *sizes, csr.plan.runs.data_ptr(),
                 csr.plan.runs.shape[0] - 1, csr.plan.long_rows.data_ptr(),
                 csr.plan.long_rows.shape[0], stream)
        if err:
            raise SystemExit(f"vm_step ({tag}) launch failed: CUDA error {err}")

    ms = in_turns(torch, {tag: (lambda tag=tag: step(tag)) for tag in roots}, 20)
    dst = torch.repeat_interleave(torch.arange(n, device=dev),
                                  (csr.row_ptr[1:] - csr.row_ptr[:-1]).long())
    plain = vm_step_reference(alpha, par, val, csr.src, dst, w, row_label[dst], n)
    same = bool(torch.equal(outs["this"], outs["other"]))
    exact = bool(torch.equal(outs["this"], plain))
    print(f"[vm_step] provgen n={n} E={E} N={N} (live edges {int((w != 0).sum())}): ms per "
          f"launch other {ms['other'][0]:.4f} / {ms['other'][1]:.4f}, this "
          f"{ms['this'][0]:.4f} / {ms['this'][1]:.4f}; this == other bitwise {same}; "
          f"this == plain bitwise {exact}; {card}", flush=True)
    return 0 if same and exact else 1


def spmm_cases(torch, dev):
    """[(label, x, csr, w)] of the segment_spmm section: Equiformer-v2's
    message sum on molecule (F = 6,272), its transpose, NequIP's (F = 288),
    and GIN's first layer at ogb_products (F = 100)."""
    from repro_torch.configs.base import GNN_SHAPES
    from repro_torch.configs.registry import get_config
    from repro_torch.data.graphs import batch_to_device, random_graph_batch
    from repro_torch.models.gnn import api, gcn

    shapes = {s.name: s for s in GNN_SHAPES}
    gen = torch.Generator(device=dev).manual_seed(4)
    cases = []
    for arch in ("equiformer-v2", "nequip"):
        cfg = get_config(arch)
        batch = batch_to_device(random_graph_batch(cfg, shapes["molecule"], seed=0), dev)
        plan = api.batch_plan(cfg, batch, shapes["molecule"])["messages"]
        E, F = plan.csr.src.shape[0], cfg.d_hidden * (cfg.l_max + 1) ** 2
        cases.append((f"{arch} messages", torch.randn((E, F), generator=gen, device=dev),
                      plan.csr, plan.w))
        if arch == "equiformer-v2":
            t = plan.csr.transposed(E)
            n_rows = plan.csr.row_ptr.shape[0] - 1
            cases.append((f"{arch} messages, transposed",
                          torch.randn((n_rows, F), generator=gen, device=dev), t,
                          plan.w[t.order].contiguous()))
    cfg = get_config("gin-tu")
    batch = batch_to_device(random_graph_batch(cfg, shapes["ogb_products"], seed=0), dev)
    csr = gcn.graph_csr(batch)
    w = batch["edge_mask"].to(torch.float32)[csr.order].contiguous()
    cases.append(("gin-tu ogb_products", batch["node_feat"].contiguous(), csr, w))
    return cases


def spmm_section(torch, np, c):
    """segment_spmm in turns at spmm_cases' shapes, beside torch.sparse.mm
    and the bytes bound; both kernels bitwise the plain version."""
    import warnings

    from repro_torch.kernels.segment_spmm.ops import vector_width
    from repro_torch.kernels.segment_spmm.ref import segment_spmm_csr_reference

    card, dev, stream = c.card, c.dev, c.stream
    fns = {}
    for tag in c.roots:
        fns[tag] = ctypes.CDLL(str(c.libs[tag, "segment_spmm"])).segment_spmm_launch
        fns[tag].argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
        fns[tag].restype = ctypes.c_int
    ok = True
    for label, x, csr, w in spmm_cases(torch, dev):
        row_ptr, src = csr.row_ptr, csr.src
        n_rows, (n_src, F), E = row_ptr.shape[0] - 1, x.shape, src.shape[0]
        vec = vector_width(x)
        outs = {tag: torch.empty((n_rows, F), device=dev) for tag in c.roots}

        def launch(tag, x=x, row_ptr=row_ptr, src=src, w=w, n_rows=n_rows, F=F, vec=vec,
                   outs=outs):
            err = fns[tag](row_ptr.data_ptr(), src.data_ptr(), w.data_ptr(), x.data_ptr(),
                           outs[tag].data_ptr(), n_rows, F, vec, stream)
            if err:
                raise SystemExit(f"segment_spmm ({tag}) launch failed: CUDA error {err}")

        reps = 20 if n_rows * F < 100_000_000 else 5
        calls = {tag: (lambda tag=tag: launch(tag)) for tag in c.roots}
        ms = in_turns(torch, calls, reps)
        dev_ms = in_turns(torch, calls, reps, device_ms)
        with warnings.catch_warnings():                 # "beta state" notices
            warnings.simplefilter("ignore", UserWarning)
            A = torch.sparse_csr_tensor(row_ptr, src, w, size=(n_rows, n_src))
        library_ms = [time_ms(torch, lambda: torch.sparse.mm(A, x), reps) for _ in range(2)]
        plain = segment_spmm_csr_reference(x, row_ptr, src, w)
        same = {tag: bool(torch.equal(outs[tag], plain)) for tag in c.roots}
        live = w != 0
        srcs, nnz = int(torch.unique(src[live]).numel()), int(live.sum())
        bound = 4 * ((n_rows + 1) + 2 * E + srcs * F + n_rows * F) / 3.35e12 * 1e3
        print(f"[spmm] {label}: F={F} ({vec}-float loads, {F // vec} a row: the "
              f"{'wide' if F // vec > 32 else 'narrow'} route), {n_rows} rows, x {n_src} rows, "
              f"E={E}, live {nnz}, distinct live sources {srcs}: ms per launch other "
              f"{ms['other'][0]:.4f} / {ms['other'][1]:.4f}, this {ms['this'][0]:.4f} / "
              f"{ms['this'][1]:.4f}; device ms per launch (profiler) other "
              f"{dev_ms['other'][0]:.4f} / {dev_ms['other'][1]:.4f}, this "
              f"{dev_ms['this'][0]:.4f} / {dev_ms['this'][1]:.4f}; torch.sparse.mm "
              f"{library_ms[0]:.4f} / {library_ms[1]:.4f} (device "
              f"{device_ms(torch, lambda: torch.sparse.mm(A, x), reps):.4f}); bound {bound:.4f} ms by bytes (this at "
              f"{bound / min(ms['this']):.3f}, other at {bound / min(ms['other']):.3f}); "
              f"bitwise the plain version: this {same['this']}, other {same['other']}; {card}",
              flush=True)
        ok = ok and all(same.values())
        del outs, A, plain
    torch.cuda.empty_cache()
    return 0 if ok else 1


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--other", type=Path, required=True,
                        help="root of the other checkout")
    parser.add_argument("--plan", action="append", default=[],
                        help="NAME:CONST=VALUE[,...]: a tile plan of this checkout's "
                             "attention backward, timed beside it")
    parser.add_argument("--only", action="append", choices=sorted(SECTIONS),
                        help="run only this section (repeatable; default: all)")
    args = parser.parse_args()
    sections = args.only or list(SECTIONS)
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare: CUDA is not available", file=sys.stderr)
        return 2
    roots = {"this": ROOT, "other": args.other.resolve()}
    for tag, root in roots.items():
        if not (root / CSRC).is_dir():
            print(f"kernel_compare: {root} holds no {CSRC}", file=sys.stderr)
            return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(f"[device] {card}; torch {torch.__version__}", flush=True)
    plans = plan_sources(args.plan) if "flash_attention_bwd" in sections else {}
    libs = build(roots, plans, [k for name in sections for k in SECTIONS[name]])
    sys.path.insert(0, str(ROOT / "src"))
    c = types.SimpleNamespace(card=card, libs=libs, roots=roots, dev=torch.device("cuda"),
                              stream=torch.cuda.current_stream().cuda_stream)
    run = {"embedding_bag": bag_section, "flash_attention": attention_section,
           "flash_attention_bwd": attention_bwd_section, "embedding_bag_bwd": bag_bwd_section,
           "vm_step": vm_step_section, "segment_spmm": spmm_section}
    for name in sections:
        if run[name](torch, np, c):
            return 1
    return 0

if __name__ == "__main__":
    sys.exit(main())
