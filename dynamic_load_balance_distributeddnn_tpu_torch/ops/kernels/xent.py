"""K2: per-example softmax cross-entropy on row-contiguous ``[R, V]`` logits.

The CUDA kernels live in ``csrc/xent.cu`` (they replace the JAX package's
``ops/pallas/xent.py`` ``_xent_fwd_kernel`` and ``_xent_bwd_kernel``). The
forward reads each row once and writes the loss and the row's logsumexp
(``lse``); :class:`SoftmaxXentFunction` saves the logits, labels and lse,
and the backward reads each row once more to write
``g * (exp(x - lse) - onehot)``. No softmax is stored, as in the TPU kernel.

:func:`xent_fwd` and :func:`xent_bwd` launch the kernels on CUDA tensors and
raise on anything else; :func:`xent_fwd_ref` and :func:`xent_bwd_ref` are
their plain PyTorch versions with the same signatures. ``softmax_xent``
routes by where the tensor lives: a CUDA tensor through
:class:`SoftmaxXentFunction`, a CPU tensor through :func:`softmax_xent_ref`,
the plain loss differentiated by autograd.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.losses import (
    per_example_cross_entropy as softmax_xent_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Launch plan, set by measurement on an H100 (scripts/xent_bench.py, which
# sweeps these constants): below SMALL_V classes a warp owns a row; from it
# up a block owns a row, of FWD_THREADS threads in the forward and of
# BWD_THREADS in the backward.
SMALL_V = 1024
FWD_THREADS = 128
BWD_THREADS = 512

__all__ = [
    "SoftmaxXentFunction",
    "plan",
    "softmax_xent",
    "softmax_xent_ref",
    "xent_bwd",
    "xent_bwd_ref",
    "xent_fwd",
    "xent_fwd_ref",
]


def _onehot(labels: torch.Tensor, v: int) -> torch.Tensor:
    """[R, V] bool; a label outside [0, V) hits nothing."""
    return torch.arange(v, device=labels.device) == labels[:, None]


def xent_fwd_ref(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel: ``(loss, lse)``, both ``[R]`` f32."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    gold = torch.where(_onehot(labels, x.shape[-1]), x, torch.zeros((), device=x.device)).sum(-1)
    return lse - gold, lse


def xent_bwd_ref(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
                 lse: torch.Tensor) -> torch.Tensor:
    """Plain version of the backward kernel: ``g[:, None] * (exp(logits -
    lse) - onehot(labels))`` in the logits dtype."""
    p = torch.exp(logits.float() - lse[:, None])
    return (g[:, None] * (p - _onehot(labels, logits.shape[-1]).float())).to(logits.dtype)


def plan(v: int) -> Tuple[int, int]:
    """``(forward threads, backward threads)`` for rows of ``v`` classes: 0
    is the warp-per-row kernel, else the block size of the block-per-row
    kernel."""
    if v < SMALL_V:
        return 0, 0
    return FWD_THREADS, BWD_THREADS


def _check(logits: torch.Tensor, labels: torch.Tensor, *rows: torch.Tensor) -> None:
    if not logits.is_cuda:
        raise ValueError("the cross-entropy kernel takes CUDA tensors")
    if logits.dtype not in _DTYPES:
        raise TypeError(f"cross-entropy kernel: dtype {logits.dtype} (f32 or bf16 only)")
    if logits.dim() != 2 or not logits.is_contiguous() or logits.numel() == 0:
        raise ValueError(
            "cross-entropy kernel: logits must be a non-empty row-contiguous "
            f"[R, V], got shape {tuple(logits.shape)} strides {logits.stride()}"
        )
    r, v = logits.shape
    if r * v >= 2**31:
        raise ValueError("cross-entropy kernel: more than 2**31 logits")
    if (
        labels.dtype != torch.int64
        or labels.shape != (r,)
        or not labels.is_contiguous()
        or labels.device != logits.device
    ):
        raise ValueError(f"cross-entropy kernel: labels must be contiguous int64 [{r}] on {logits.device}")
    for t in rows:
        if t.shape != (r,) or t.dtype != torch.float32 or not t.is_contiguous() or t.device != logits.device:
            raise ValueError(f"cross-entropy kernel: g and lse must be contiguous f32 [{r}] on {logits.device}")


def _lib() -> ctypes.CDLL:
    lib = runtime.load("xent")
    if lib.xent_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xent_forward.argtypes = [p, p, p, p, i, i, i, i, p]
        lib.xent_forward.restype = i
        lib.xent_backward.argtypes = [p, p, p, p, p, i, i, i, i, p]
        lib.xent_backward.restype = i
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel forward: ``(loss, lse)``, both ``[R]`` f32."""
    _check(logits, labels)
    r, v = logits.shape
    threads = plan(v)[0]
    loss = torch.empty((r,), device=logits.device, dtype=torch.float32)
    lse = torch.empty_like(loss)
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_forward(
            _ptr(logits), _ptr(labels), _ptr(loss), _ptr(lse), r, v,
            _DTYPES[logits.dtype], threads, ctypes.c_void_p(stream),
        )
    runtime.check(lib, err, "xent_forward")
    runtime.LAUNCHES["xent_fwd"] += 1
    return loss, lse


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor,
             lse: torch.Tensor) -> torch.Tensor:
    """Kernel backward: ``g[:, None] * (exp(logits - lse) - onehot(labels))``
    in the logits dtype, ``lse`` being the forward's."""
    _check(logits, labels, g, lse)
    r, v = logits.shape
    threads = plan(v)[1]
    dx = torch.empty_like(logits)
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_backward(
            _ptr(logits), _ptr(labels), _ptr(g), _ptr(lse), _ptr(dx), r, v,
            _DTYPES[logits.dtype], threads, ctypes.c_void_p(stream),
        )
    runtime.check(lib, err, "xent_backward")
    runtime.LAUNCHES["xent_bwd"] += 1
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """Autograd for the kernel pair; saves the logits, labels and the
    forward's ``[R]`` f32 lse."""

    @staticmethod
    def forward(ctx, logits, labels):
        loss, lse = xent_fwd(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return loss

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        return xent_bwd(logits, labels, g.float().contiguous(), lse), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-example softmax cross-entropy, logits ``[..., V]``, labels
    ``[...]``: the CUDA kernels for a CUDA tensor, the plain version for a
    CPU one."""
    if logits.is_cuda:
        v = logits.shape[-1]
        loss = SoftmaxXentFunction.apply(
            logits.reshape(-1, v).contiguous(), labels.reshape(-1).long().contiguous()
        )
        return loss.reshape(labels.shape)
    if logits.device.type == "cpu":
        return softmax_xent_ref(logits, labels)
    raise ValueError(f"softmax_xent: no kernel for device {logits.device}")
