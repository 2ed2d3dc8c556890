"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``volrt_torch/build/<hash>/``, where the hash covers the
flags and every file under ``csrc/``, headers too, so an edited source or
header builds anew and an unchanged tree is loaded from disk. The
directory is created at first use and is listed in ``.gitignore``.
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
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# What the hash covers: the kernels and the headers they share.
SOURCE_GLOBS = ("*.cu", "*.cuh", "*.h")
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
    for src in sorted(f for g in SOURCE_GLOBS for f in CSRC.glob(g)):
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
        _compile(lib)
    return ctypes.CDLL(str(lib))


def _compile(lib: Path) -> None:
    nvcc = _nvcc()
    lib.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    objs = {src: lib.with_name(f"{src.stem}.{tag}.o")
            for src in sorted(CSRC.glob("*.cu"))}
    cmds = [[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
             "-o", str(obj)] for src, obj in objs.items()]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    tmp = lib.with_name(f"{lib.name}.{tag}")
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs.values())]
    log, failed = [], []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=900)
            log.append(" ".join(cmd) + "\n" + out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed ({proc.returncode}):\n{out}")
        if not failed:
            res = subprocess.run(link, capture_output=True, text=True,
                                 timeout=900)
            log.append(" ".join(link) + "\n" + res.stdout + res.stderr)
            if res.returncode != 0:
                failed.append(f"nvcc link failed ({res.returncode}):\n"
                              f"{res.stdout}{res.stderr}")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
        for obj in objs.values():
            obj.unlink(missing_ok=True)
        (lib.parent / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("\n".join(failed))
    os.replace(tmp, lib)  # atomic: a concurrent build loses nothing
