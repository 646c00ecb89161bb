"""Kernel loader: builds ``csrc/*.cu`` with nvcc into one shared library with
a plain C interface and loads it with ctypes.  Each source compiles in its
own nvcc process, all started together, and one more nvcc links them.

The library goes to ``build/fries_tpu_torch/libfries_kernels.so`` under the
repository root, keyed on a hash of the sources (a stale build is rebuilt).
It is built at first use, never at import.  There is no fallback: without
nvcc or a CUDA device the loader raises, and after loading it launches the
backend probe (:func:`probe_copy`, ``csrc/probe_copy.cu``) once and raises
if the launch fails or the copy differs.
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
              "-Xcompiler", "-fPIC"]

PROBE_SHAPE = (16, 128)   # two blocks of (8, 128), as pallas_merge.py:77

_LIB: ctypes.CDLL | None = None


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*sources(), *CSRC.glob("*.cuh")]):
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
    nvcc = _nvcc()
    tag = f"{os.getpid()}.tmp"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    procs = [subprocess.Popen(
        [nvcc, *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []), "-c",
         "-o", str(obj), str(src)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for src, obj in zip(sources(), objs)]
    outs = [proc.communicate() for proc in procs]
    for src, proc, (_, err) in zip(sources(), procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{err}")
        if verbose:
            print(err, end="")
    tmp = BUILD_DIR / f"{LIB_NAME}.{tag}"
    proc = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    for obj in objs:
        obj.unlink()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
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
        x = torch.arange(PROBE_SHAPE[0] * PROBE_SHAPE[1], dtype=torch.float32,
                         device="cuda").reshape(PROBE_SHAPE)
        if not torch.equal(_probe_copy(lib, x), probe_copy_plain(x)):
            raise RuntimeError("the kernel library's probe copy gave a wrong result")
        _LIB = lib
    return _LIB


def probe_copy_plain(x):
    """Kernel #5's plain version: a copy."""
    return x.clone()


def probe_copy(x):
    """The backend probe's (16, 128) f32 copy: the CUDA kernel for a tensor
    on the card, the plain version for a tensor on the CPU."""
    if not x.is_cuda:
        return probe_copy_plain(x)
    return _probe_copy(load(), x)


def _probe_copy(lib, x):
    import torch

    from fries_tpu_torch import profiling

    check_tensor("probe_copy", "x", x, torch.float32, PROBE_SHAPE)
    out = torch.empty_like(x)
    err = lib.fries_probe_copy(ctypes.c_void_p(x.data_ptr()), ctypes.c_void_p(out.data_ptr()),
                               ctypes.c_void_p(torch.cuda.current_stream(x.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"probe_copy launch failed: {err} "
                           f"({lib.fries_error_string(err).decode()})")
    profiling.count("launch.probe_copy")
    return out


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
