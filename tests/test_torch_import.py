"""Import hygiene of the PyTorch port: ``repro_torch`` imports neither JAX
nor anything of the JAX reference package ``repro``."""
import os
import pathlib
import re
import subprocess
import sys

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_PROBE = """
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m == "jax" or m.startswith("jax.")
             or m == "repro" or m.startswith("repro."))
print(len(names), bad)
"""


def test_port_imports_without_jax_or_reference():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    n_modules, bad = out.stdout.split(" ", 1)
    assert int(n_modules) >= 40
    assert bad.strip() == "[]", bad


def test_port_sources_name_no_jax_import():
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b)(?!_torch)",
                     re.M)
    offenders = [str(p) for p in (SRC / "repro_torch").rglob("*.py")
                 if pat.search(p.read_text())]
    assert offenders == []
