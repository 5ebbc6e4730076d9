"""Atomic, versioned checkpointing.

Layout:  <dir>/step_<n>/arrays.npz + manifest.json
Writes go to a temp directory then os.replace (atomic on POSIX), so a crash
mid-save never corrupts the latest checkpoint.  Arrays are stored whole, on
the host, with their tree paths in the manifest.  An optional background
thread makes saves non-blocking (async checkpointing).

The on-disk format is the JAX package's, so checkpoints cross packages:
``a{i}`` in JAX's flatten order (dict keys sorted), each path spelt as JAX
spells it (``utils/tree.py``).  numpy has no bfloat16, and the JAX package's
``np.savez`` writes a bf16 leaf as its raw 2-byte values under the header
type ``<V2`` (``ml_dtypes``' bfloat16): the port writes the same bytes and
header through a ``uint16`` view, and a 2-byte void array restores into a
bf16 leaf bit for bit.  The atomic publish is shared with
the serving snapshotter.
"""
from __future__ import annotations

import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.utils import get_logger, tree

log = get_logger("train.checkpoint")


def atomic_dir_publish(parent: Path, final_name: str, writer) -> Path:
    """Write a directory atomically: ``writer(tmp_path)`` populates a fresh
    temp dir under ``parent``, which is then ``os.replace``d to
    ``parent/final_name`` — a crash mid-write never corrupts (or even
    reveals) a partially written directory.  Replaces an existing
    ``final_name``.  Shared by checkpointing and the serving snapshotter."""
    parent = Path(parent)
    final = parent / final_name
    tmp = Path(tempfile.mkdtemp(dir=parent, prefix=".tmp_"))
    try:
        writer(tmp)
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)  # atomic publish
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


class _Bf16(np.ndarray):
    """A bf16 leaf's raw 2-byte values (a uint16 array), written with the
    ``<V2`` header that numpy gives an ``ml_dtypes`` bfloat16 array."""


def _to_numpy(t) -> np.ndarray:
    t = torch.as_tensor(t).detach().to("cpu", copy=True)    # never an alias
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16).view(_Bf16)
    return t.numpy()


def _savez(path: Path, vals) -> None:
    """``np.savez(path, a0=..., a1=...)``, member for member, with bf16
    leaves as the JAX package's ``np.savez`` writes them."""
    with zipfile.ZipFile(path, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for i, v in enumerate(vals):
            with zf.open(f"a{i}.npy", "w", force_zip64=True) as f:
                if isinstance(v, _Bf16):
                    np.lib.format.write_array_header_1_0(
                        f, {"descr": "<V2", "fortran_order": False, "shape": v.shape})
                    f.write(np.ascontiguousarray(v).view(np.ndarray).tobytes())
                else:
                    np.lib.format.write_array(f, np.asanyarray(v))


def _to_tensor(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    """A stored array as a tensor of ``like``'s dtype on its device; raw
    2-byte values (``|V2``, or uint16) into a bf16 leaf bit for bit."""
    a = a if a.flags.c_contiguous else a.copy()     # keeps a 0-d array 0-d
    if like.dtype == torch.bfloat16 and a.dtype.itemsize == 2 and a.dtype.kind in "Vu":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a).to(like.dtype)
    if tuple(t.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {tuple(t.shape)} restored into "
                         f"{tuple(like.shape)}")
    return t.to(like.device)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = False):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        # serializes join-then-spawn: without it two concurrent save()
        # callers can both pass the join, overwrite each other's handle and
        # interleave their writes with keep-pruning
        self._save_lock = threading.Lock()

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any],
             metadata: Optional[Dict] = None) -> None:
        """state: a tree of tensors (e.g. {"params": ..., "opt_state": ...}),
        copied to the host before this returns."""
        keys, vals = tree.flatten_with_paths(state)
        host = (keys, [_to_numpy(v) for v in vals])
        if self.async_save:
            with self._save_lock:
                if self._thread is not None:
                    self._thread.join()
                self._thread = threading.Thread(
                    target=self._write, args=(step, host, metadata or {}), daemon=True)
                self._thread.start()
        else:
            with self._save_lock:
                self._write(step, host, metadata or {})

    def wait(self) -> None:
        with self._save_lock:
            t, self._thread = self._thread, None
        if t is not None:
            t.join()

    def close(self) -> None:
        """Join any in-flight async save; the manager stays usable (a later
        ``save`` simply spawns a fresh writer)."""
        self.wait()

    def _write(self, step: int, host, metadata: Dict) -> None:
        t0 = time.time()
        keys, vals = host

        def writer(tmp: Path) -> None:
            _savez(tmp / "arrays.npz", vals)
            manifest = {
                "step": step,
                "keys": keys,
                "time": time.time(),
                "metadata": metadata,
            }
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))

        atomic_dir_publish(self.dir, f"step_{step:010d}", writer)
        self._gc()
        log.info("checkpoint step %d saved in %.2fs", step, time.time() - t0)

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)

    # -- restore ----------------------------------------------------------------
    def all_steps(self) -> List[int]:
        out = []
        for p in self.dir.glob("step_*"):
            if (p / "manifest.json").exists():
                out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, like: Dict[str, Any], step: Optional[int] = None) -> Dict[str, Any]:
        """Restore into the structure of ``like`` (a tree of tensors): each
        leaf with ``like``'s dtype, on its device."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        with np.load(path / "arrays.npz") as data:
            vals = [data[f"a{i}"] for i in range(len(manifest["keys"]))]

        keys_like, like_vals = tree.flatten_with_paths(like)
        if keys_like != manifest["keys"]:
            raise ValueError(
                "checkpoint structure mismatch:\n"
                f"  ckpt: {manifest['keys'][:5]}...\n  like: {keys_like[:5]}...")
        return tree.unflatten(like, [_to_tensor(v, lv) for v, lv in zip(vals, like_vals)])

    def metadata(self, step: Optional[int] = None) -> Dict:
        step = step if step is not None else self.latest_step()
        path = self.dir / f"step_{step:010d}"
        return json.loads((path / "manifest.json").read_text())["metadata"]
