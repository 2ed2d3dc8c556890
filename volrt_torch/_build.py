"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so a build takes seconds). The
library lands in ``volrt_torch/build/<hash>/``, where the hash covers the
flags and every file under ``csrc/``, headers too, so an edited source or
header builds anew and an unchanged tree is loaded from disk. The
directory is created at first use and is listed in ``.gitignore``.

Beside the kernels, :func:`load_native` builds the port's host C++ library
(``native/volrt_native.cpp``: the DDS decoder, the 16-bit quantiser, the
histogram and the ESL min/max grid) with the system C++ compiler into its
own ``build/<hash>/``, the hash over that source and its flags. It needs no
CUDA, so it builds, and the CPU tests run it, on any host with ``g++``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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
NATIVE_SRC = _PKG / "native" / "volrt_native.cpp"
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
NATIVE_LIB_NAME = "libvolrt_torch_native.so"


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


def native_library_path() -> Path:
    """Where the host library for the current source and flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SRC.name.encode())
    h.update(NATIVE_SRC.read_bytes())
    return BUILD_DIR / h.hexdigest()[:16] / NATIVE_LIB_NAME


@functools.cache
def load_native() -> ctypes.CDLL:
    """Compile the host library with ``g++`` if needed and load it (once
    per process); raise with the compiler's output if it cannot be built."""
    lib = native_library_path()
    if not lib.exists():
        _compile_native(lib)
    return ctypes.CDLL(str(lib))


def _compile_native(lib: Path) -> None:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError(
            "g++ not found on PATH; a C++ compiler is needed to build "
            "volrt_torch's native library (the loader has no fallback)")
    lib.parent.mkdir(parents=True, exist_ok=True)
    # xdist workers and dist/ ranks may build at once: each compiles to a
    # file of its own and moves it into place, which is atomic.
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.{threading.get_ident()}"
                        f".tmp")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(NATIVE_SRC)]
    res = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{' '.join(cmd)} failed ({res.returncode}):\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, lib)
