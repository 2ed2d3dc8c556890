"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into one shared library
with a plain C interface (no PyTorch headers, so a build takes seconds).
The library lands in ``volrt_torch/build/<hash>/``, where the hash covers
the sources and the flags, so an edited source builds anew and an
unchanged one is loaded from disk. The directory is created at first use
and is listed in ``.gitignore``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
LIB_NAME = "libvolrt_torch_kernels.so"


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError(
            "nvcc not found on PATH or at /usr/local/cuda/bin/nvcc; the "
            "CUDA toolkit is needed to build volrt_torch's kernels")
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / LIB_NAME


@functools.cache
def load() -> ctypes.CDLL:
    """Compile the kernels if needed and load the library (once per process).

    ``nvcc``'s output, with ``-Xptxas -v``'s register and spill counts, is
    kept beside the library as ``build.log``.
    """
    lib = library_path()
    if not lib.exists():
        cmd = [_nvcc(), *NVCC_FLAGS]
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd += ["-o", str(tmp), *map(str, sorted(CSRC.glob("*.cu")))]
        res = subprocess.run(cmd, capture_output=True, text=True, timeout=900)
        (lib.parent / "build.log").write_text(
            " ".join(cmd) + "\n" + res.stdout + res.stderr)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({res.returncode}):\n{res.stdout}{res.stderr}")
        os.replace(tmp, lib)  # atomic: a concurrent build loses nothing
    return ctypes.CDLL(str(lib))
