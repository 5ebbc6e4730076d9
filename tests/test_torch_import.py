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


def test_sharded_slice_imports_without_jax_or_reference():
    probe = ("import sys, repro_torch.graphs.sharded_packing, repro_torch.launch.mesh, "
             "repro_torch.core.visitor; print(sorted(m for m in sys.modules "
             "if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_serving_slice_imports_without_jax_or_reference():
    probe = ("import sys, repro_torch.serve, repro_torch.serve.loop, repro_torch.serve.engine, "
             "repro_torch.serve.snapshot, repro_torch.serve.replication, "
             "repro_torch.serve.control, repro_torch.serve.faults, repro_torch.obs, "
             "repro_torch.train.checkpoint, repro_torch.train.elastic, "
             "repro_torch.utils.timing, repro_torch.workload.executor; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_cluster_slice_imports_without_jax_or_reference():
    probe = ("import sys, repro_torch.serve.replication, repro_torch.serve.cluster, "
             "repro_torch.serve.chaos, repro_torch.graphs.sharded_packing, "
             "repro_torch.device; from repro_torch.serve import ClusterCoordinator, "
             "ChaosHarness, FollowerReplica, ReplicationHub, run_scenario; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", probe], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


def test_chip_smoke_imports_without_jax_or_reference():
    root = SRC.parent
    pat = re.compile(r"^\s*(import jax|from jax|import repro\b|from repro\b)(?!_torch)", re.M)
    assert not pat.search((root / "chip_smoke.py").read_text())
    # importing the script (and the port modules its phases import) loads
    # neither JAX nor the reference package
    probe = ("import sys; sys.path.insert(0, 'src'); import chip_smoke, repro_torch.serve, "
             "repro_torch.serve.cluster, repro_torch.serve.chaos, repro_torch.workload.stream; "
             "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=root, capture_output=True,
                         text=True, timeout=120, env=dict(os.environ))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
