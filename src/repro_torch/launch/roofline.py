"""Roofline report generator: aggregates ``experiments/dryrun_torch/*.json``
(``launch/dryrun.py``'s records) into a roofline table of the single-pod
cells and a memory / collective table of both meshes, against one NVIDIA
H100 SXM5 (``launch/hlo_analysis.py``'s peaks).

The JAX package's ``launch/roofline.py`` reads its XLA dry-run and prefers
a scan-unrolled variant for exact HLO FLOP counts; the port's fake run
counts every op of its Python layer loop, so there is one variant.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--out experiments/roofline_torch.md]
"""
from __future__ import annotations

import argparse
import json
from pathlib import Path
from typing import Dict

from repro_torch.launch.hlo_analysis import HBM_BW, HARDWARE, LINK_BW, PEAK_FLOPS, PEAK_TF32

DRYRUN_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"
#: the card's memory, for the "fits" column.  Its args + temp is a floor on
#: the step's peak (``hlo_analysis``'s temp bytes count live tensors, not the
#: caching allocator's rounding or the libraries' workspaces): a "NO" is
#: certain, a "yes" close to the limit is not
HBM_GB = HARDWARE["hbm_bytes"] / 1e9


def _fmt_s(x: float) -> str:
    if x == 0:
        return "0"
    if x < 1e-3:
        return f"{x * 1e6:.1f}us"
    if x < 1:
        return f"{x * 1e3:.1f}ms"
    return f"{x:.2f}s"


def _advice(d: Dict) -> str:
    r = d["roofline"]
    dom = r["dominant"]
    kind = d.get("step", "")
    if dom == "memory":
        if "train" in kind:
            return ("fuse AdamW's chunked passes (optim/adamw.py) into one "
                    "kernel a leaf to cut HBM round-trips; bf16 activations")
        if "serve" in kind or "decode" in kind:
            return "KV-cache quantisation (int8) halves the bytes-bound term"
        return ("fuse the gathers and sums into the hand-written segment "
                "kernels (segment_spmm, vm_step) to stop the plain temporaries")
    if dom == "collective":
        if "train" in kind:
            return ("reduce-scatter grads instead of all-reduce; overlap "
                    "FSDP all-gathers with layer compute")
        if "moe" in d["arch"] or "kimi" in d["arch"] or "olmoe" in d["arch"]:
            return "all-to-all dispatch (moe.apply_sharded); TAPER expert placement"
        return "shard the gather/scatter along the already-local axis"
    return "increase per-chip batch; wgmma tile shapes (64-row warpgroup tiles)"


def load_cells(mesh: str = "single") -> Dict:
    cells = {}
    for p in sorted(DRYRUN_DIR.glob(f"*__{mesh}.json")):
        d = json.loads(p.read_text())
        if d.get("status") == "ok":
            cells[(d["arch"], d["shape"])] = d
    return cells


def table(cells: Dict) -> str:
    rows = [
        "| arch | shape | step | compute | memory | collective | dominant | "
        "MODEL_FLOPS | useful ratio | roofline frac | next lever |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for (arch, shape), d in sorted(cells.items()):
        r = d["roofline"]
        rows.append(
            f"| {arch} | {shape} | {d['step']} | {_fmt_s(r['compute_s'])} "
            f"| {_fmt_s(r['memory_s'])} | {_fmt_s(r['collective_s'])} "
            f"| **{r['dominant']}** | {r['model_flops_total']:.3g} "
            f"| {r['useful_flops_ratio']:.2f} | {r['roofline_fraction']:.3f} "
            f"| {_advice(d)} |"
        )
    return "\n".join(rows)


def memory_table(cells_single: Dict, cells_multi: Dict) -> str:
    rows = [
        f"| arch | shape | mesh | args GB/dev | temp GB/dev | fits H100 {HBM_GB:.0f}GB "
        "(args + temp, a floor) | "
        "collectives (count) |",
        "|---|---|---|---|---|---|---|",
    ]
    for mesh_name, cells in (("single", cells_single), ("multi", cells_multi)):
        for (arch, shape), d in sorted(cells.items()):
            ma = d.get("memory_analysis", {})
            args = ma.get("argument_size_in_bytes", 0) / 1e9
            temp = ma.get("temp_size_in_bytes", 0) / 1e9
            fits = "yes" if (args + temp) < HBM_GB else "NO"
            cc = d.get("collectives", {}).get("count_by_op", {})
            cstr = " ".join(f"{k.split('-')[-1][:4]}:{v}" for k, v in cc.items())
            rows.append(f"| {arch} | {shape} | {mesh_name} | {args:.2f} "
                        f"| {temp:.2f} | {fits} | {cstr} |")
    return "\n".join(rows)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=str(DRYRUN_DIR.parent / "roofline_torch.md"))
    args = ap.parse_args(argv)
    single = load_cells("single")
    multi = load_cells("multi")
    text = (
        f"# Roofline (single-pod 16x16, {HARDWARE['name']}: "
        f"{PEAK_FLOPS / 1e12:.1f} TFLOP/s bf16, {PEAK_TF32 / 1e12:.1f} TFLOP/s "
        f"TF32 for float32, {HBM_BW / 1e12:.2f} TB/s HBM3, "
        f"{LINK_BW / 1e9:.0f} GB/s NVLink a direction; published peaks, "
        f"{HARDWARE['source'].split()[0]})\n\n"
        "Terms from a fake-tensor run of each step (launch/hlo_analysis.py): "
        "memory reads the compulsory bytes.\n\n"
        + table(single)
        + "\n\n# Dry-run memory / collective schedule (both meshes)\n\n"
        + memory_table(single, multi)
        + "\n"
    )
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(text)
    print(text)


if __name__ == "__main__":
    main()
