"""K2: per-example softmax cross-entropy on row-contiguous ``[R, V]`` logits.

The CUDA kernels live in ``csrc/xent.cu`` (they replace the JAX package's
``ops/pallas/xent.py`` ``_xent_fwd_kernel`` and ``_xent_bwd_kernel``).
``softmax_xent`` routes by where the tensor lives: a CUDA tensor goes
through :class:`SoftmaxXentFunction` (kernel forward; kernel backward that
recomputes the softmax, storing none), a CPU tensor through
:func:`softmax_xent_ref`, the plain PyTorch version, differentiated by
autograd.
"""

from __future__ import annotations

import ctypes

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.losses import (
    per_example_cross_entropy as softmax_xent_ref,
)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

__all__ = ["softmax_xent", "softmax_xent_ref", "xent_fwd", "xent_bwd"]


def _check(logits: torch.Tensor, labels: torch.Tensor) -> None:
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


def _lib() -> ctypes.CDLL:
    lib = runtime.load("xent")
    if lib.xent_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.xent_forward.argtypes = [p, p, p, i, i, i, p]
        lib.xent_forward.restype = i
        lib.xent_backward.argtypes = [p, p, p, p, i, i, i, p]
        lib.xent_backward.restype = i
    return lib


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def xent_fwd(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Kernel forward: per-row loss ``[R]`` f32."""
    _check(logits, labels)
    r, v = logits.shape
    loss = torch.empty((r,), device=logits.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_forward(
            _ptr(logits), _ptr(labels), _ptr(loss), r, v,
            _DTYPES[logits.dtype], ctypes.c_void_p(stream),
        )
    runtime.check(lib, err, "xent_forward")
    runtime.LAUNCHES["xent_fwd"] += 1
    return loss


def xent_bwd(logits: torch.Tensor, labels: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Kernel backward: ``g[:, None] * (softmax(logits) - onehot(labels))`` in
    the logits dtype."""
    _check(logits, labels)
    r, v = logits.shape
    if g.shape != (r,) or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError(f"cross-entropy kernel: g must be contiguous f32 [{r}]")
    dx = torch.empty_like(logits)
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.xent_backward(
            _ptr(logits), _ptr(labels), _ptr(g), _ptr(dx), r, v,
            _DTYPES[logits.dtype], ctypes.c_void_p(stream),
        )
    runtime.check(lib, err, "xent_backward")
    runtime.LAUNCHES["xent_bwd"] += 1
    return dx


class SoftmaxXentFunction(torch.autograd.Function):
    """Autograd for the kernel pair; saves only the logits and labels."""

    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return xent_fwd(logits, labels)

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        return xent_bwd(logits, labels, g.float().contiguous()), None


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
