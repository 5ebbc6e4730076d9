"""Build the port's CUDA kernels from the checkout at first use.

Every source in ``kernels/csrc/`` is compiled by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``
(route (b): no PyTorch headers, so a build takes seconds).  Libraries land
in ``kernels/build/`` (git-ignored), named by the hash of their source, so
an edited source is rebuilt and an unchanged one is reused.  All sources
are compiled at once, one ``nvcc`` process each.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict

from repro_torch.kernels import KernelError

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise KernelError("nvcc not found: the CUDA kernels are built on the "
                           "machine with the card, from the CUDA toolkit")
    return path


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}-{digest}.so"


def build_all() -> Dict[str, Path]:
    """Compile every ``csrc/*.cu`` that has no up-to-date library; returns
    ``{kernel name: library path}``.  Raises ``KernelError`` with the
    compiler's output if any build fails.  ``nvcc``'s ``-Xptxas -v`` report
    (registers, shared memory, spills) is kept beside each library as
    ``<library>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = {src.stem: _target(src) for src in sorted(CSRC.glob("*.cu"))}
    procs = {}
    for name, lib in libs.items():
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        procs[name] = (tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        lib = libs[name]
        lib.with_name(lib.name + ".log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, lib)
    if failed:
        raise KernelError("CUDA kernel build failed:\n" + "\n".join(failed))
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (``csrc/<name>.cu``)."""
    libs = build_all()
    if name not in libs:
        raise KeyError(f"no CUDA source csrc/{name}.cu")
    try:
        return ctypes.CDLL(str(libs[name]))
    except OSError as exc:
        raise KernelError(f"cannot load {libs[name]}: {exc}") from exc
