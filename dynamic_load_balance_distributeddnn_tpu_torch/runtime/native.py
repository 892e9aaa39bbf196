"""ctypes bridge to the repo's C++ host runtime (``native/src/dbs_native.cpp``).

The row gather of the JAX package's ``runtime/native.py``, copied: the host
side of the host-fed path, the multithreaded gather that packs a window's
examples (``take_rows``). The C++ source is a repo-level file outside either
package; this port builds its own copy of the library from it with ``$CXX``
(``g++`` by default) into ``build/native/`` under the checkout, at the first
call, never at import. The JAX package's loader writes and mtime-checks
``native/libdbs_native.so``; nothing here touches that file. The library's
solver entry points are not bound: ``balance/solver.py`` solves in numpy, a
4-8 element update once per epoch or window.

Like the JAX package, ``take_rows`` falls back to ``np.take``, with
identical results, when the library cannot be built or loaded (no compiler,
or ``DBS_NATIVE=0``). This is host code, not a kernel. Which implementation
answers is logged once, the fallback as a warning (``native_impl`` names
it).

Env knobs:
  DBS_NATIVE=0        disable the native path entirely (forces numpy)
  DBS_NATIVE_THREADS  gather thread count (default: hardware concurrency)
"""

from __future__ import annotations

import ctypes
import logging
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "src" / "dbs_native.cpp"
BUILD_DIR = _REPO / "build" / "native"
_LIB_NAME = "libdbs_native.so"
_ABI_VERSION = 1

_log = logging.getLogger(__name__)
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_attempted = False


def _build() -> Optional[Path]:
    """``build/native/libdbs_native.so``, rebuilt when the source is newer.
    Compiled to a process-unique temporary file and renamed: processes that
    race to build (ranks) never rewrite a library another has loaded."""
    out = BUILD_DIR / _LIB_NAME
    if not SOURCE.exists():
        return None
    if out.exists() and out.stat().st_mtime >= SOURCE.stat().st_mtime:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{_LIB_NAME}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            [os.environ.get("CXX", "g++"), "-O3", "-std=c++17", "-fPIC", "-shared",
             "-pthread", "-o", str(tmp), str(SOURCE)],
            check=True, capture_output=True, timeout=120,
        )
        os.replace(tmp, out)
    except (OSError, subprocess.SubprocessError):
        return None
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _bind(lib: ctypes.CDLL) -> bool:
    try:
        lib.dbs_native_abi_version.restype = ctypes.c_int
        if lib.dbs_native_abi_version() != _ABI_VERSION:
            return False
        lib.dbs_gather_rows.restype = ctypes.c_int
        lib.dbs_gather_rows.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64, ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_void_p, ctypes.c_int,
        ]
    except AttributeError:
        return False
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_attempted
    if _lib is not None or _load_attempted:
        return _lib
    with _lock:
        if _lib is not None or _load_attempted:
            return _lib
        _load_attempted = True
        why = "DBS_NATIVE=0"
        if os.environ.get("DBS_NATIVE", "1") != "0":
            path = _build()
            why = f"no library built from {SOURCE}"
            if path is not None:
                try:
                    lib = ctypes.CDLL(str(path))
                    why = f"{path}: ABI mismatch"
                    if _bind(lib):
                        _lib = lib
                except OSError as e:
                    why = f"{path}: {e}"
        if _lib is not None:
            _log.info(f"host runtime: native C++ ({BUILD_DIR / _LIB_NAME})")
        else:
            _log.warning(f"host runtime: numpy fallback ({why})")
        return _lib


def native_available() -> bool:
    """True when the C++ runtime is loaded (building it on the first call)."""
    return _load() is not None


def native_impl() -> str:
    """The implementation that answers: ``"native"`` or ``"numpy"``."""
    return "native" if native_available() else "numpy"


# ------------------------------------------------------------------- gather


def take_rows(data: np.ndarray, idx: np.ndarray, out: Optional[np.ndarray] = None) -> np.ndarray:
    """``data[idx]`` along axis 0 via the multithreaded C++ gather.

    ``data`` must be C-contiguous; ``idx`` may have any shape. The result has
    shape ``idx.shape + data.shape[1:]``, exactly ``np.take(data, idx, 0)``,
    which is also the fallback when the native library is unavailable.
    ``out``: a C-contiguous array of that shape and ``data``'s dtype to pack
    into (a pinned staging buffer's view), returned."""
    lib = _load()
    idx = np.ascontiguousarray(idx, dtype=np.int64)
    # uniform bounds on both backends: numpy's negative-index wrapping would
    # otherwise make the fallback diverge from the C++ bounds check
    if idx.size and (idx.min() < 0 or idx.max() >= data.shape[0]):
        raise ValueError("take_rows: index out of range")
    shape = idx.shape + data.shape[1:]
    if out is not None and (out.shape != shape or out.dtype != data.dtype
                            or not out.flags["C_CONTIGUOUS"]):
        raise ValueError(f"take_rows: out must be a C-contiguous {data.dtype} array of "
                         f"shape {shape}")
    if lib is None:
        return np.take(data, idx, axis=0, out=out)
    if not data.flags["C_CONTIGUOUS"]:
        data = np.ascontiguousarray(data)
    flat = idx.ravel()
    row_bytes = int(data.dtype.itemsize * int(np.prod(data.shape[1:], dtype=np.int64)))
    if out is None:
        out = np.empty(shape, dtype=data.dtype)
    rc = lib.dbs_gather_rows(
        data.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(data.shape[0]),
        ctypes.c_int64(row_bytes),
        flat.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(flat.size),
        out.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(int(os.environ.get("DBS_NATIVE_THREADS", "0"))),
    )
    if rc != 0:
        raise ValueError(f"dbs_gather_rows failed with code {rc}")
    return out

