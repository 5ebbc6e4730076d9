"""Atomic directory publishing, shared with the serving snapshotter.

The JAX package's module also holds a ``CheckpointManager`` over model
pytrees; the port's comes with the training slice.  What serving needs
now is the atomic publish it is built on: writes go to a temp directory
then ``os.replace`` (atomic on POSIX), so a crash mid-save never corrupts
the latest published directory.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from pathlib import Path


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
