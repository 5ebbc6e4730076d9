"""Multi-pod dry-run.

For every (architecture x input-shape) cell, run the step once on fake
tensors laid out on the production meshes — (16, 16) single pod and
(2, 16, 16) multi-pod — and record memory analysis, cost analysis, and the
collectives to ``experiments/dryrun_torch/<arch>__<shape>__<mesh>.json``.

The JAX package's ``launch/dryrun.py`` lowers and compiles each step with
XLA over 512 placeholder host devices.  Here the mesh is a
``DeviceMesh`` over a fake process group
(``torch.testing._internal.distributed.fake_pg``: 256 or 512 ranks in this
one process, collectives that move nothing), the arguments are fake
DTensors with the plan's placements, and ``launch/hlo_analysis.py`` counts
rank 0's share (:meth:`repro_torch.launch.specs.CellPlan.lower`).  The
group is destroyed and made again between the two meshes.  The meshes are
CPU meshes (fake CUDA tensors cannot go through autograd on a build
without CUDA), on which DTensor carries an all-to-all as an all-gather and
a chunk: a cell that redistributes shard to shard counts all-gathers.

A record is the JAX package's, with ``lower_s`` the plan's build and
``compile_s`` the fake run, plus ``hardware`` (the card the roofline
models).  A cell whose step fails (an op without a DTensor sharding rule,
an output shape that depends on data) records ``status: "error"`` with
the error and its ``op``: the op the message names, else the port's
innermost line that raised.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-4b --shape prefill_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh both
"""
from __future__ import annotations

import argparse
import json
import re
import time
import traceback
from pathlib import Path
from typing import Optional

import torch.distributed as dist

from repro_torch.configs.registry import list_archs, shapes_for
from repro_torch.launch import hlo_analysis
from repro_torch.launch.mesh import chips_in, make_production_mesh
from repro_torch.launch.specs import build_cell
from repro_torch.utils import get_logger

log = get_logger("launch.dryrun")

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

_OP_RE = re.compile(r"\b((?:aten|repro_torch|c10d|_c10d_functional|prim)[.:]+[A-Za-z_0-9]+(?:\.[A-Za-z_0-9]+)?)")


def _failed_op(exc: BaseException, text: str) -> Optional[str]:
    """The op a failure names, else the port's innermost line that raised
    (``models/moe.py:153 buf = ...``)."""
    op = _OP_RE.search(text)
    if op:
        return op.group(1)
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "repro_torch" in f.filename and "hlo_analysis" not in f.filename]
    if not frames:
        return None
    f = frames[-1]
    return f"{f.filename.split('src/')[-1]}:{f.lineno} {(f.line or '').strip()}"


def fake_group(world: int) -> None:
    """A default process group of ``world`` fake ranks, this process rank 0
    (the group already there if it has that size; another is destroyed
    first)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             out_dir: Path = OUT_DIR, overrides: Optional[dict] = None) -> dict:
    mesh_name = "multi" if multi_pod else "single"
    tag = f"{arch}__{shape_name}__{mesh_name}"
    out_path = out_dir / f"{tag}.json"
    t0 = time.time()
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        fake_group(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="cpu")
        plan = build_cell(arch, shape_name, mesh, **(overrides or {}))
        t_lower = time.time() - t0
        run = plan.lower()
        t_compile = time.time() - t0 - t_lower
        analysis = hlo_analysis.analyze(
            run, plan.meta.get("model_flops", 0.0), chips_in(mesh))
        result.update(
            status="ok",
            step=plan.step_name,
            meta=plan.meta,
            lower_s=round(t_lower, 2),
            compile_s=round(t_compile, 2),
            **analysis,
            hardware=hlo_analysis.HARDWARE,
        )
        ma = result["memory_analysis"]
        log.info("%s: OK build=%.1fs run=%.1fs mem=%s dominant=%s",
                 tag, t_lower, t_compile,
                 {k: f"{v/1e9:.2f}GB" for k, v in ma.items() if isinstance(v, int)},
                 result["roofline"]["dominant"])
    except Exception as e:
        text = f"{type(e).__name__}: {e}"
        result.update(status="error", error=text[:2000], op=_failed_op(e, text),
                      traceback=traceback.format_exc()[-4000:])
        log.error("%s: FAILED %s", tag, text[:300])
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path.write_text(json.dumps(result, indent=2, default=float))
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR))
    args = ap.parse_args(argv)

    out_dir = Path(args.out)
    archs = list_archs() if (args.all or not args.arch) else [args.arch]
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    failures = 0
    try:
        # mesh outermost: each fake group is made once
        for multi in meshes:
            for arch in archs:
                shape_names = ([args.shape] if args.shape
                               else [s.name for s in shapes_for(arch)])
                for shape_name in shape_names:
                    mesh_name = "multi" if multi else "single"
                    out_path = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
                    if args.skip_existing and out_path.exists():
                        prev = json.loads(out_path.read_text())
                        if prev.get("status") == "ok":
                            continue
                    res = run_cell(arch, shape_name, multi, out_dir)
                    if res["status"] != "ok":
                        failures += 1
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    if failures:
        log.error("%d cells failed", failures)
        raise SystemExit(1)
    log.info("all cells passed")


if __name__ == "__main__":
    main()
