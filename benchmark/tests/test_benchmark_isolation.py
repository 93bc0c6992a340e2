"""What a run may load and read: nothing of JAX or of mmhand_tpu, and none
of the JAX package's TPU benchmark records; and no fall-back to the CPU
when there is no card."""

from __future__ import annotations

import subprocess
import sys

from benchmark import run

IMPORT_ALL = """
import sys
from benchmark import run, control
from benchmark.drivers import common, gan_train, hpe_train, generate
from benchmark.reference import compare, gan, hpe, layers
for path in sorted((run.BENCHMARK_DIR / "metrics").glob("*.py")):
    run.load_reader(path.stem)
print(" ".join(sorted(sys.modules)))
"""


def test_no_jax_loaded():
    out = subprocess.run([sys.executable, "-c", IMPORT_ALL], cwd=run.ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True).stdout.split()
    tops = {name.split(".", 1)[0] for name in out}
    assert "benchmark" in tops and "torch" in tops
    assert not tops & {"jax", "jaxlib", "flax", "mmhand_tpu"}


def test_reference_imports_nothing_of_the_program():
    for path in (run.BENCHMARK_DIR / "reference").glob("*.py"):
        text = path.read_text()
        assert "mmhand_torch" not in text.replace("mmhand_torch`", ""), path


def test_no_file_reads_the_jax_benchmark_records():
    names = ("bench" + ".py", "BENCH" + "_", "BASE" + "LINE",
             "MULTI" + "CHIP")
    for path in run.BENCHMARK_DIR.rglob("*"):
        if path.is_file() and path.suffix in (".py", ".json", ".md"):
            text = path.read_text()
            for name in names:
                assert name not in text, (path, name)


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib_unrelated", sys)
    monkeypatch.setitem(sys.modules, "mmhand_tpu_like", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert run.forbidden_modules() == ["jax.numpy"]


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "hpe_hpm.train", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=run.ROOT, capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(run.ROOT)})
    assert proc.returncode != 0
    assert "{" not in proc.stdout
