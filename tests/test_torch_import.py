"""mmhand_torch imports no JAX, and imports without a CUDA compiler.

Checked in a subprocess: tests/conftest.py has already imported jax into
this one.  The sources of the port and chip_smoke.py are also read for
imports of JAX, mmhand_tpu or the repo's tools, including imports inside
functions that only run on the card.
"""

import ast
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
for name in ("scripts.aug", "scripts.train", "ops.bn_stats", "train.loop",
             "train.pool", "models.discriminator", "models.vgg",
             "losses.gan", "losses.perceptual", "ops.jointsmap", "ops.ssim",
             "eval.evaluator", "eval.metrics", "models.inception",
             "models.cpm", "models.baselines", "scripts.evaluate_gan",
             "scripts.bench_baselines", "train.precision", "utils.logging",
             "utils.visualize", "utils.html", "utils.liveplot",
             "utils.checkpoint", "parallel", "parallel.mesh",
             "parallel.sharding", "parallel.dryrun", "ops.hand_trafo",
             "ops.hand3d_image", "models.hand3d", "hand3d", "hand3d.pipeline",
             "hand3d.system", "scripts.train_hand3d", "scripts.eval_hand3d",
             "scripts.create_hand3d_db", "scripts.run_hand3d",
             "scripts.handpose_judge", "ops.voxelize", "data.msra",
             "models.voxel_nets", "eval.pose_search",
             "scripts.convert_hand3d_weights"):
    assert "mmhand_torch." + name in names, names
leaked = sorted(m for m in sys.modules
                if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax",
                                       "orbax", "mmhand_tpu", "tools",
                                       "convert_mmhand_torch",
                                       "convert_torch_weights"))
assert not leaked, leaked
print(len(names))
"""
    proc = _run(code)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip()) >= 82


def test_port_sources_import_no_jax():
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "mmhand_tpu",
              "tools", "convert_mmhand_torch", "convert_torch_weights"}
    files = sorted((REPO / "mmhand_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                roots = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                roots = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not banned & set(roots), f"{path}:{node.lineno} {roots}"


def test_build_module_imports_without_nvcc():
    """Importing the kernel builder runs no compiler; only a CUDA tensor's
    path calls load_library()."""
    code = """
import shutil
assert shutil.which("nvcc") is None
from mmhand_torch.ops import _build, bn_stats, heatmap, jointsmap
assert _build.library_path().name.startswith("libmmhand_kernels-")
"""
    proc = _run(code, PATH=os.path.dirname(sys.executable),
                CUDA_HOME="/nonexistent")
    assert proc.returncode == 0, proc.stderr
