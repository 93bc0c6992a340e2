"""Build the port's CUDA kernels with nvcc at first use and load them.

Every ``csrc/*.cu`` file is compiled by its own nvcc, all started together,
and the objects are linked into one shared library with a plain C interface,
which ``ctypes`` loads.  The library lands in ``mmhand_torch/_build/``
under a name that hashes the sources and flags, so an edited source is never
served a stale build.  Importing this module needs no compiler: nothing runs
until ``load_library()`` is called, which only a CUDA tensor's path does.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

from mmhand_torch.utils import trace

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME/bin; "
                       "the CUDA kernels of mmhand_torch cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmmhand_kernels-{digest.hexdigest()[:16]}.so"


def _run(procs: list[tuple[list[str], subprocess.Popen]]) -> None:
    failed = []
    for cmd, proc in procs:
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}):\n"
                          f"{' '.join(cmd)}\n{stdout}{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(out: Path) -> None:
    """Compile every csrc/*.cu, one nvcc each in parallel, and link them into
    ``out`` (written atomically); counted in ``kernels.builds``."""
    trace.count("kernels.builds")
    out.parent.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        objects, procs = [], []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = os.path.join(tmp, src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", obj]
            procs.append((cmd, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                text=True)))
            objects.append(obj)
        _run(procs)
        lib = os.path.join(tmp, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", lib, *objects]
        _run([(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.PIPE, text=True))])
        os.replace(lib, out)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """The kernels' shared library, built first if it is missing; its
    seconds add to the counter ``setup.kernel_library_s``."""
    with trace.timed("setup.kernel_library_s"):
        path = library_path()
        if not path.exists():
            build(path)
        return ctypes.CDLL(str(path))
