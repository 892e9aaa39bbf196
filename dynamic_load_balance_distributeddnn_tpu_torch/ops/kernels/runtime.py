"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints, the
stream; returns ``cudaError_t``). It is compiled with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/<name>-<hash>.so`` under the checkout
at first use and loaded with ``ctypes``; the hash covers the source and the
flags, so an edited kernel rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module.

``LAUNCHES`` counts, per kernel wrapper, the launches that reached the card:
a wrapper adds one right after its C call returns success, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("groupnorm", "xent", "flash_attention")

LAUNCHES: Dict[str, int] = {
    "groupnorm_fwd": 0,
    "groupnorm_bwd": 0,
    "xent_fwd": 0,
    "xent_bwd": 0,
    "attn_fwd": 0,
    "attn_bwd_dkv": 0,
    "attn_bwd_dq": 0,
}

_LIBS: Dict[str, ctypes.CDLL] = {}
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output per built source


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        os.path.join(home, "bin", "nvcc") if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: set CUDA_HOME or put the CUDA toolkit's nvcc on PATH"
    )


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    h = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def build(names=SOURCES) -> Dict[str, Path]:
    """Compile every listed source that has no up-to-date library yet, all
    ``nvcc`` processes started together, and wait for them. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if todo:
        nvcc = _nvcc()
        procs = []
        for n, p in todo.items():
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{n}.cu")]
            procs.append((n, p, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        failed: List[str] = []
        for n, p, tmp, proc in procs:
            out, _ = proc.communicate()
            BUILD_LOG[n] = out
            if proc.returncode != 0:
                os.unlink(tmp)
                failed.append(f"--- {n}.cu (exit {proc.returncode}) ---\n{out}")
            else:
                os.replace(tmp, p)  # atomic: a reader never sees half a file
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error (a refused
    launch never runs, and a later synchronize would not report it)."""
    if err != 0:
        msg = lib.error_string(err).decode(errors="replace")
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
