"""Build, load and count the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface (pointers, ints, the
stream; returns ``cudaError_t``). It is compiled with ``nvcc`` for
``sm_90a`` into ``build/torch_kernels/<name>-<hash>.so`` under the checkout
at first use and loaded with ``ctypes``; the hash covers the source and the
flags, so an edited kernel rebuilds and an unchanged one is reused. Nothing
here runs at import time: the CPU tests import every module.

``LAUNCHES`` counts, per kernel wrapper, the launches that reached the card:
a wrapper adds one (``count``) right after its C call returns success, and
nowhere else. Counts are kept a *context*: the CUDA stream the launch went
to, or the calling thread for a count with no device. ``LAUNCHES`` reads the
sum over the contexts, every addition under one lock, so tenants that
launch from several threads (``runtime/scheduler.py``) lose no count. A
step graph's capture reads the context of its capture stream alone
(``LAUNCHES.of``): that holds the backward's launches, which autograd
makes from its own device thread on the forward's stream, and none of
another tenant's, which go to that tenant's streams.

GroupNorm's ``groupnorm_fwd``/``groupnorm_bwd`` count both of its routes
and both dtypes; ``groupnorm_fwd_general``/``groupnorm_bwd_general`` the
general route's share of them, and the ``_bf16`` keys (GroupNorm and
cross-entropy) the share whose operands were bf16, so a run under
``--precision bfloat16`` shows which dtype each kernel took.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections.abc import MutableMapping
from pathlib import Path
from typing import Dict, Hashable, Iterator, List

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
SOURCES = ("groupnorm", "xent", "flash_attention", "faultload")

KERNELS = (  # the counters, one a kernel wrapper (and its shares)
    "groupnorm_fwd",
    "groupnorm_bwd",
    "groupnorm_fwd_general",  # of which the general route (K1's first kernels)
    "groupnorm_bwd_general",
    "groupnorm_fwd_bf16",  # of which on bf16 activations
    "groupnorm_bwd_bf16",
    "xent_fwd",
    "xent_bwd",
    "xent_fwd_bf16",  # of which on bf16 logits
    "xent_bwd_bf16",
    "attn_fwd",  # the short forward (T <= 64)
    "attn_bwd",  # the fused short backward
    "attn_fwd_tiled",  # the tiled kernels (T > 64)
    "attn_bwd_dkv",
    "attn_bwd_dq",
    "synthetic_load",  # the compute-mode straggler's chain
)


class LaunchCounts(MutableMapping):
    """The launch counts a kernel name, summed over the counting contexts
    (:func:`context`). Every addition holds one lock, so no increment is
    lost between threads. Assigning a name sets the calling thread's
    context so that the sum reads the value (``LAUNCHES[k] += n`` in one
    thread); deleting is refused."""

    def __init__(self, names):
        self._names = tuple(names)
        self._lock = threading.Lock()
        self._tables: Dict[Hashable, Dict[str, int]] = {}

    def add(self, ctx: Hashable, name: str, n: int) -> None:
        if name not in self._names:
            raise KeyError(name)
        with self._lock:
            table = self._tables.get(ctx)
            if table is None:
                table = self._tables[ctx] = dict.fromkeys(self._names, 0)
            table[name] += n

    def of(self, ctx: Hashable) -> Dict[str, int]:
        """A copy of one context's counts."""
        with self._lock:
            return dict(self._tables.get(ctx) or dict.fromkeys(self._names, 0))

    def __getitem__(self, name: str) -> int:
        if name not in self._names:
            raise KeyError(name)
        with self._lock:
            return sum(t[name] for t in self._tables.values())

    def __setitem__(self, name: str, value: int) -> None:
        self.add(context(), name, int(value) - self[name])

    def __delitem__(self, name: str) -> None:
        raise TypeError("launch counters are fixed; reset_launches() zeroes them")

    def __iter__(self) -> Iterator[str]:
        return iter(self._names)

    def __len__(self) -> int:
        return len(self._names)

    def reset(self) -> None:
        with self._lock:
            self._tables.clear()


LAUNCHES = LaunchCounts(KERNELS)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LIBS_LOCK = threading.Lock()  # one build and one load a source, whichever thread asks first
BUILD_LOG: Dict[str, str] = {}  # nvcc/ptxas output per built source


def context(device=None) -> Hashable:
    """The counting context of a launch on ``device``: its current CUDA
    stream on a CUDA device, else the calling thread.

    A stream is keyed by its handle. ``torch.cuda.Stream()`` hands out the
    streams of a pool (32 a device and priority, round robin), so past 16
    tenants of ``runtime/scheduler.py`` (a stream and a capture stream
    each) two tenants can share a handle, and their counts then merge in
    one context. The sum over contexts, which ``LAUNCHES`` reads, is exact
    all the same."""
    if device is not None and device.type == "cuda":
        import torch

        return ("stream", torch.cuda.current_stream(device).cuda_stream)
    return ("thread", threading.get_ident())


def count(name: str, n: int = 1, device=None) -> None:
    """Add ``n`` launches of ``name`` to the context of ``device``."""
    LAUNCHES.add(context(device), name, n)


def reset_launches() -> None:
    LAUNCHES.reset()


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
        with _LIBS_LOCK:
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
