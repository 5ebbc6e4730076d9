"""Structured logging for the repro_torch package."""
from __future__ import annotations

import logging
import os
import sys

_FORMAT = "%(asctime)s %(levelname).1s %(name)s] %(message)s"
_configured = False


def _configure_root() -> None:
    global _configured
    if _configured:
        return
    handler = logging.StreamHandler(sys.stderr)
    handler.setFormatter(logging.Formatter(_FORMAT, datefmt="%H:%M:%S"))
    root = logging.getLogger("repro_torch")
    root.addHandler(handler)
    root.setLevel(os.environ.get("REPRO_LOG_LEVEL", "INFO").upper())
    root.propagate = False
    _configured = True


def get_logger(name: str) -> logging.Logger:
    _configure_root()
    if not name.startswith("repro_torch"):
        name = f"repro_torch.{name}"
    return logging.getLogger(name)


def json_default(obj):
    """``json.dumps(..., default=json_default)`` helper that folds numpy
    scalars/arrays (and anything else with ``item``/``tolist``) into plain
    Python values; unknown objects degrade to ``str`` rather than raising
    mid-export."""
    tolist = getattr(obj, "tolist", None)
    if callable(tolist):
        return tolist()
    item = getattr(obj, "item", None)
    if callable(item):
        return item()
    if isinstance(obj, (set, frozenset)):
        return sorted(obj)
    return str(obj)
