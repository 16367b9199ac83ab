"""Build and load the hand-written CUDA kernels: ``nvcc`` + ``ctypes``.

Every ``csrc/*.cu`` file is compiled once, at first use, into one shared
library with a plain C interface, for Hopper (``sm_90a``) only: one
``nvcc`` per source, all started together, then one link. The library
goes to ``<repository>/build/torch_kernels/`` under a name that carries a
hash of the sources, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source rebuilds and an unchanged one is loaded as it is. A
failed build raises with nvcc's output; nothing falls back to the plain
PyTorch versions.

Nothing here runs at import time: the CPU tests import every module on
machines that have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

# --fmad=false: no multiply-add contraction, so the kernel rounds like
# the plain PyTorch version it is held against. -Xptxas -v records each
# kernel's registers, shared memory and spills in the build log.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def sources() -> list:
    return sorted(SOURCE_DIR.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(SOURCE_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under $CUDA_HOME; "
                           "the CUDA kernels cannot be built")
    return path


def library_path() -> Path:
    return BUILD_DIR / f"libart_kernels_{_digest()}.so"


def build_log() -> str:
    """nvcc's output (ptxas register and spill report) of the current
    build, or '' if the library was not built by this checkout yet."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> float:
    """Compile the sources unless the library for their hash exists.
    Returns the seconds spent compiling (0.0 when nothing was built)."""
    lib = library_path()
    if lib.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.stem + ".o") for src in sources()]
        compiles = [[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(sources(), objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in compiles]
        logs = [proc.communicate()[0] for proc in procs]
        for cmd, proc, log in zip(compiles, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed with exit code {proc.returncode}:\n"
                    f"{' '.join(cmd)}\n{log}")
        so = os.path.join(tmp, lib.name)
        link = [nvcc, "-shared", "-o", so, *objs]
        proc = subprocess.run(link, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {proc.returncode}:\n"
                f"{' '.join(link)}\n{proc.stdout}{proc.stderr}")
        lib.with_suffix(".log").write_text("".join(logs))
        os.replace(so, lib)  # atomic: concurrent builders load either copy
    return time.perf_counter() - t0


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    """Build if needed, then load the kernel library (once per process)."""
    build()
    return ctypes.CDLL(str(library_path()))
