"""The compute-mode straggler's synthetic load as one CUDA kernel.

``csrc/faultload.cu`` runs the whole chain of ``n`` dependent 256 x 256 f32
products ``acc <- tanh(acc @ acc) * 0.5 + 0.5`` in one cooperative launch
(a grid-wide barrier between iterations) and writes ``sum(acc) * 1e-12``,
so the load is device time and costs the host one launch, whatever ``n``.
The kernel reads ``n`` from a device int32 scalar, so a launch captured in a
CUDA graph (``train/supersteps.py``) takes a new count by a copy into that
scalar before a replay. It replaces the JAX package's ``ops/faultload.py`` ``synthetic_load``,
which XLA runs as one device loop. :func:`synthetic_load_cuda` launches it
on a CUDA tensor and raises on anything else; the plain version is
``ops/faultload.py`` :func:`synthetic_load`.
"""

from __future__ import annotations

import ctypes
from typing import Union

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

SIZE = 256  # the product's side, fixed in the kernel


def _lib() -> ctypes.CDLL:
    lib = runtime.load("faultload")
    if lib.synthetic_load.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.synthetic_load.argtypes = [p, p, p, p, p]
        lib.synthetic_load.restype = i
        lib.synthetic_load_work_floats.argtypes = []
        lib.synthetic_load_work_floats.restype = i
    return lib


def synthetic_load_cuda(n_iters: Union[int, torch.Tensor], seed_val: torch.Tensor) -> torch.Tensor:
    """``n_iters`` dependent products seeded off the scalar ``seed_val``,
    in one kernel; returns the f32 scalar ``sum(acc) * 1e-12``. ``n_iters``
    is an int, or the device int32 scalar the kernel reads (its value is
    not read here, so the call never waits on the card)."""
    if not seed_val.is_cuda:
        raise ValueError("the synthetic-load kernel takes a CUDA tensor")
    if seed_val.numel() != 1:
        raise ValueError(f"synthetic-load kernel: the seed must be a scalar, got shape {tuple(seed_val.shape)}")
    dev = seed_val.device
    if isinstance(n_iters, torch.Tensor):
        if n_iters.device != dev or n_iters.dtype != torch.int32 or n_iters.numel() != 1:
            raise ValueError(
                "synthetic-load kernel: the count must be an int32 scalar on the seed's device, "
                f"got {n_iters.dtype} {tuple(n_iters.shape)} on {n_iters.device}"
            )
        count = n_iters
    else:
        n = int(n_iters)
        if not 0 <= n < 2**31:
            raise ValueError(f"synthetic-load kernel: {n} iterations")
        count = torch.full((), n, dtype=torch.int32, device=dev)
    seed = seed_val.detach().reshape(()).to(torch.float32).contiguous()
    lib = _lib()
    work = torch.empty(lib.synthetic_load_work_floats(), device=dev, dtype=torch.float32)
    out = torch.empty((), device=dev, dtype=torch.float32)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.synthetic_load(
            ctypes.c_void_p(seed.data_ptr()), ctypes.c_void_p(count.data_ptr()),
            ctypes.c_void_p(work.data_ptr()), ctypes.c_void_p(out.data_ptr()),
            ctypes.c_void_p(stream),
        )
    runtime.check(lib, err, "synthetic_load")
    runtime.count("synthetic_load", device=dev)
    return out
