"""The native (C++) FCIDUMP and vector-file reader, loaded with ctypes.

Counterpart of ``fries_tpu/native``: ``fries_io.cpp`` (the port's own copy of
the reference's source) parses the FCIDUMP record body and bulk numeric
tables.  It is host code, not a device kernel.  The shared library is built
with ``g++ -O3 -shared -fPIC -std=c++17`` at first use, never at import,
into ``build/fries_tpu_torch/`` (:data:`fries_tpu_torch._build.BUILD_DIR`),
keyed by a hash of the source.  ``FRIES_NATIVE=0`` turns it off.

:func:`lib` gives the loaded library or None with the reason;
:func:`fries_tpu_torch.io`'s readers choose between it and their Python
paths with the reference's switch (``native=None`` the library when it
builds, ``True`` the library or an error, ``False`` Python).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

from fries_tpu_torch import _build

SRC = Path(__file__).with_name("fries_io.cpp")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_F64P = ctypes.POINTER(ctypes.c_double)
_U64P = ctypes.POINTER(ctypes.c_ulonglong)


def build() -> Path:
    """Compile ``fries_io.cpp`` unless a build of this source exists; return
    the library's path.  Raises ``OSError`` (no ``g++``) or
    ``subprocess.CalledProcessError`` (a failed compile)."""
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"libfries_io_{tag}.so"
    if not so.exists():
        _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *CXX_FLAGS, str(SRC), "-o", str(tmp)], check=True,
                       capture_output=True, timeout=120)
        os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=1)
def lib():
    """(library, None), or (None, reason) when ``FRIES_NATIVE=0`` or the
    build or load fails; built and loaded once per process."""
    if os.environ.get("FRIES_NATIVE", "1") == "0":
        return None, "FRIES_NATIVE=0"
    try:
        so = ctypes.CDLL(str(build()))
    except (OSError, subprocess.SubprocessError) as e:
        detail = getattr(e, "stderr", b"") or b""
        return None, f"{type(e).__name__}: {e} {detail.decode(errors='replace')}".strip()
    so.fries_parse_fcidump_body.restype = ctypes.c_long
    so.fries_parse_fcidump_body.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_long,
                                            _F64P, _F64P, _F64P]
    so.fries_parse_doubles.restype = ctypes.c_long
    so.fries_parse_doubles.argtypes = [ctypes.c_char_p, _F64P, ctypes.c_long]
    so.fries_parse_u64.restype = ctypes.c_long
    so.fries_parse_u64.argtypes = [ctypes.c_char_p, _U64P, ctypes.c_long]
    return so, None


def _checked(count, path):
    if count < 0:
        raise OSError(-count, os.strerror(-count), str(path))
    return count


def parse_fcidump_body(so, path, offset: int, n_orb: int):
    """The FCIDUMP records from byte ``offset`` on -> (hcore (n, n), chemist
    ERIs (n, n, n, n) over all 8 images, core energy); lines without five
    fields are skipped."""
    hcore = np.zeros((n_orb, n_orb), np.float64)
    eris = np.zeros((n_orb,) * 4, np.float64)
    core = ctypes.c_double(0.0)
    _checked(so.fries_parse_fcidump_body(os.fsencode(str(path)), offset, n_orb,
                                         hcore.ctypes.data_as(_F64P),
                                         eris.ctypes.data_as(_F64P), ctypes.byref(core)),
             path)
    return hcore, eris, float(core.value)


def parse_doubles(so, path):
    """Every whitespace-separated float of the file (unparsable tokens
    skipped)."""
    out = np.empty(os.path.getsize(path) // 2 + 1, np.float64)
    n = _checked(so.fries_parse_doubles(os.fsencode(str(path)), out.ctypes.data_as(_F64P),
                                        out.shape[0]), path)
    return out[:n].copy()


def parse_u64(so, path):
    """Every whitespace-separated decimal token of the file as uint64."""
    out = np.empty(os.path.getsize(path) // 2 + 1, np.uint64)
    n = _checked(so.fries_parse_u64(os.fsencode(str(path)), out.ctypes.data_as(_U64P),
                                    out.shape[0]), path)
    return out[:n].copy()
