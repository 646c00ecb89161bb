"""Kernel loader: builds ``csrc/*.cu`` with nvcc into one shared library with
a plain C interface and loads it with ctypes.

The library goes to ``build/fries_tpu_torch/libfries_kernels.so`` under the
repository root, keyed on a hash of the sources (a stale build is rebuilt).
It is built at first use, never at import.  There is no fallback: without
nvcc or a CUDA device the loader raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "fries_tpu_torch"
LIB_NAME = "libfries_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_LIB: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def build(verbose: bool = False) -> Path:
    """Compile the kernels unless a build of the current sources exists;
    return the library path."""
    lib = BUILD_DIR / LIB_NAME
    stamp = BUILD_DIR / "sources.sha256"
    digest = _source_hash()
    if lib.exists() and stamp.exists() and stamp.read_text() == digest:
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(proc.stderr, end="")
    os.replace(tmp, lib)
    stamp.write_text(digest)
    return lib


def load() -> ctypes.CDLL:
    """Build if needed and load the kernel library (once per process)."""
    global _LIB
    if _LIB is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("the CUDA kernels need a CUDA device")
        lib = ctypes.CDLL(str(build()))
        lib.fries_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def check_tensor(kernel: str, name: str, t, dtype, shape) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and
    ``shape`` (what a kernel's C entry point takes)."""
    if not t.is_cuda:
        raise ValueError(f"{kernel}: {name} must be a CUDA tensor")
    if t.dtype != dtype or tuple(t.shape) != tuple(shape) or not t.is_contiguous():
        raise ValueError(
            f"{kernel}: {name} must be contiguous {dtype} {tuple(shape)}, got "
            f"{t.dtype} {tuple(t.shape)}")


def error_string(err: int) -> str:
    return f"{err} ({load().fries_error_string(err).decode()})"
