#!/usr/bin/env python3
"""Where the bf16 attention kernel's time goes, on the GPU.

Run from the root of a checkout, on the machine with the card:

    python3 tools/attention_breakdown.py

Builds ``src/repro_torch/kernels/csrc/flash_attention_bf16.cu`` as it is
and in variants that each drop one part of the per-tile work (the source
text is patched; the variants compute wrong outputs and are only timed):

  kernel       the kernel as it is;
  no-exp       P from the scaled scores without exp2 (no MUFU work);
  raw-P        no softmax arithmetic: the scores' bits are fed as P;
  no-lo        only the hi product of P V (one bf16 rounding of P);
  products     raw-P and no-lo: the two products and the loop alone.

Each is timed with CUDA events at qwen3-4b's two prefill shapes (4 x 4,096
and 1 x 32,768 tokens, 32 query and 8 KV heads of 128, causal) on random
bf16 q, k, v, in turns, twice.  The variants land in the git-ignored
``kernels/build/``.  Exits non-zero without CUDA or nvcc.
"""
from __future__ import annotations

import ctypes
import math
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src" / "repro_torch" / "kernels" / "csrc" / "flash_attention_bf16.cu"
OUT = ROOT / "src" / "repro_torch" / "kernels" / "build" / "breakdown"

P_EXP = """          split_bf16(exp2_approx(fmaf(sc[j], scale_log2, -mr)),
                     exp2_approx(fmaf(sc[j + 1], scale_log2, -mr)), pa[kk][i], pl[kk][i],
                     l[i & 1]);"""
P_NOEXP = """          split_bf16(fmaf(sc[j], scale_log2, -mr), fmaf(sc[j + 1], scale_log2, -mr),
                     pa[kk][i], pl[kk][i], l[i & 1]);"""
P_RAW = """          pa[kk][i] = __float_as_uint(sc[j]);
          pl[kk][i] = __float_as_uint(sc[j + 1]);"""
LO = """      MmaRS<P::kNW>::run(acc[n], pl[kk], dv);\n"""
VARIANTS = {
    "kernel": [],
    "no-exp": [(P_EXP, P_NOEXP)],
    "raw-P": [(P_EXP, P_RAW)],
    "no-lo": [(LO, "")],
    "products": [(P_EXP, P_RAW), (LO, "")],
}
SHAPES = ((4, 4096), (1, 32768))


def build(name, patches):
    text = SRC.read_text()
    for old, new in patches:
        if text.count(old) != 1:
            raise SystemExit(f"{name}: the kernel source no longer has the text this "
                             f"variant patches:\n{old}")
        text = text.replace(old, new)
    src, lib = OUT / f"{name}.cu", OUT / f"lib{name}.so"
    src.write_text(text)
    return subprocess.Popen(
        ["/usr/local/cuda/bin/nvcc", "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
         "-O3", "-shared", "-Xcompiler", "-fPIC", "-o", str(lib), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("attention_breakdown: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels.flash_attention.kernel import TILE_PLAN

    OUT.mkdir(parents=True, exist_ok=True)
    procs = {name: build(name, patches) for name, patches in VARIANTS.items()}
    launch = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log}", file=sys.stderr)
            return 1
        fn = ctypes.CDLL(str(lib)).flash_attention_bf16_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 10
                       + [ctypes.c_longlong, ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        launch[name] = fn

    def call(fn, q, k, v, out):
        B, S, H, D = q.shape
        plan = TILE_PLAN[D]
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, S, H,
                 k.shape[2], D, plan.bk, plan.stages, 1, 0, 0,
                 math.log2(math.e) / math.sqrt(D), None,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"launch failed: {err}")

    def time_ms(fn, args, reps):
        call(fn, *args)
        torch.cuda.synchronize()
        ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        ev0.record()
        for _ in range(reps):
            call(fn, *args)
        ev1.record()
        torch.cuda.synchronize()
        return ev0.elapsed_time(ev1) / reps

    device = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                             "--format=csv,noheader"], capture_output=True, text=True)
    print(f"[breakdown] {device.stdout.strip()}; torch {torch.__version__}", flush=True)
    gen = torch.Generator(device="cuda").manual_seed(0)
    inputs = {}
    for B, S in SHAPES:
        q, k, v = (torch.randn(B, S, h, 128, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for h in (32, 8, 8))
        inputs[(B, S)] = (q, k, v, torch.empty_like(q))
    for turn in range(2):
        for name, fn in launch.items():
            cells = []
            for (B, S), args in inputs.items():
                ms = time_ms(fn, args, 3 if S > 8192 else 10)
                flops = 4 * 128 * (S * (S + 1) // 2) * B * 32
                cells.append(f"{B} x {S}: {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
                             f"of the causal product)")
            print(f"[breakdown] turn {turn} {name:8s} " + " | ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
