"""mmhand_torch imports no JAX, and imports without a CUDA compiler.

Checked in a subprocess: tests/conftest.py has already imported jax into
this one.
"""

import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent


def _run(code: str, **env) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, **env})


def test_port_imports_no_jax():
    code = """
import importlib, pkgutil, sys
import mmhand_torch
names = [m.name for m in pkgutil.walk_packages(mmhand_torch.__path__,
                                               "mmhand_torch.")]
for name in names:
    importlib.import_module(name)
assert "mmhand_torch.scripts.aug" in names, names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "mmhand_tpu"))
assert not leaked, leaked
print(len(names))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 16


def test_build_module_imports_without_nvcc():
    """Importing the kernel builder runs no compiler; only a CUDA tensor's
    path calls load_library()."""
    code = """
import shutil
assert shutil.which("nvcc") is None
from mmhand_torch.ops import _build, heatmap
assert _build.library_path().name.startswith("libmmhand_kernels-")
"""
    proc = _run(code, PATH=os.path.dirname(sys.executable),
                CUDA_HOME="/nonexistent")
    assert proc.returncode == 0, proc.stderr
