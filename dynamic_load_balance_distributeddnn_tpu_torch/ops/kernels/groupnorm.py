"""K1: fused GroupNorm (+ relu) on channels-last ``[B, S, C]`` activations.

The CUDA kernels live in ``csrc/groupnorm.cu`` (they replace the JAX
package's ``ops/pallas/groupnorm.py`` ``_gn_fwd_kernel`` and
``_fused_gn_bwd``). ``group_norm`` routes by where the tensor lives: a CUDA
tensor goes through :class:`GroupNormFunction` (kernel forward, kernel
backward), a CPU tensor through :func:`group_norm_ref`, the plain PyTorch
version with the same arithmetic, differentiated by autograd.

Statistics are f32 whatever the input dtype (f32 or bf16); the output keeps
the input dtype; the variance is ``max(E[x^2] - mean^2, 0)`` like the TPU
kernel's.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_SMEM = 48 * 1024  # the backward's dynamic shared memory, default limit
_THREADS = 256  # kThreads in csrc/groupnorm.cu


def group_norm_ref(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    relu: bool = False,
) -> torch.Tensor:
    """Plain PyTorch GroupNorm over the trailing channel axis of ``[B, S, C]``
    with the TPU kernel's arithmetic. Reference for the kernel, and the path
    CPU tensors take."""
    b, s, c = x.shape
    xf = x.float().reshape(b, s, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    xhat = ((xf - mean) * torch.rsqrt(var + eps)).reshape(b, s, c)
    y = xhat * weight.float() + bias.float()
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def _check(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, groups: int):
    if not x.is_cuda:
        raise ValueError("the GroupNorm kernel takes CUDA tensors")
    if x.dtype not in _DTYPES:
        raise TypeError(f"GroupNorm kernel: dtype {x.dtype} (f32 or bf16 only)")
    if x.dim() != 3 or not x.is_contiguous():
        raise ValueError(
            "GroupNorm kernel: x must be a contiguous channels-last [B, S, C], "
            f"got shape {tuple(x.shape)} strides {x.stride()}"
        )
    b, s, c = x.shape
    if b * s * c == 0:
        raise ValueError(f"GroupNorm kernel: empty input {tuple(x.shape)}")
    if groups < 1 or c % groups:
        raise ValueError(f"GroupNorm kernel: {c} channels not divisible by {groups} groups")
    if b * s * c >= 2**31:
        raise ValueError("GroupNorm kernel: more than 2**31 elements")
    for name, p in (("weight", weight), ("bias", bias)):
        if p.dtype != torch.float32 or p.shape != (c,) or not p.is_contiguous():
            raise ValueError(f"GroupNorm kernel: {name} must be contiguous f32 [{c}]")
        if p.device != x.device:
            raise ValueError(f"GroupNorm kernel: {name} on {p.device}, x on {x.device}")


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _lib() -> ctypes.CDLL:
    lib = runtime.load("groupnorm")
    if lib.gn_forward.argtypes is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gn_forward.argtypes = [p] * 6 + [i] * 4 + [ctypes.c_float, i, i, p]
        lib.gn_forward.restype = i
        lib.gn_backward.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.gn_backward.restype = i
    return lib


def group_norm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel forward: ``(y, mean, rstd)`` with ``mean``/``rstd`` [B, G] f32."""
    _check(x, weight, bias, groups)
    b, s, c = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_forward(
            _ptr(x), _ptr(weight), _ptr(bias), _ptr(y), _ptr(mean), _ptr(rstd),
            b, s, c, groups, float(eps), int(relu), _DTYPES[x.dtype], _stream(x),
        )
    runtime.check(lib, err, "gn_forward")
    runtime.LAUNCHES["groupnorm_fwd"] += 1
    return y, mean, rstd


def group_norm_bwd(
    x: torch.Tensor,
    dy: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    groups: int,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel backward: ``(dx, dweight, dbias)`` from the forward's saved
    ``mean``/``rstd``; the relu mask is recomputed from them."""
    _check(x, weight, bias, groups)
    b, s, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("GroupNorm kernel: dy must match x in shape, dtype and layout")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (b, groups) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"GroupNorm kernel: {name} must be contiguous f32 [{b}, {groups}]")
    cg = c // groups
    if 2 * 4 * max(_THREADS // cg, 1) * cg > _MAX_SMEM:
        raise ValueError(f"GroupNorm kernel: {cg} channels per group is too many")
    dx = torch.empty_like(x)
    part = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    dw = torch.empty((c,), device=x.device, dtype=torch.float32)
    db = torch.empty_like(dw)
    lib = _lib()
    with torch.cuda.device(x.device):
        err = lib.gn_backward(
            _ptr(x), _ptr(dy), _ptr(weight), _ptr(bias), _ptr(mean), _ptr(rstd),
            _ptr(dx), _ptr(part[0]), _ptr(part[1]), _ptr(dw), _ptr(db),
            b, s, c, groups, int(relu), _DTYPES[x.dtype], _stream(x),
        )
    runtime.check(lib, err, "gn_backward")
    runtime.LAUNCHES["groupnorm_bwd"] += 1
    return dx, dw, db


class GroupNormFunction(torch.autograd.Function):
    """Autograd for the kernel pair; saves x and the [B, G] statistics."""

    @staticmethod
    def forward(ctx, x, weight, bias, groups, eps, relu):
        y, mean, rstd = group_norm_fwd(x, weight, bias, groups, eps, relu)
        ctx.save_for_backward(x, weight, bias, mean, rstd)
        ctx.groups, ctx.relu = groups, relu
        return y

    @staticmethod
    def backward(ctx, dy):
        x, weight, bias, mean, rstd = ctx.saved_tensors
        dx, dw, db = group_norm_bwd(
            x, dy.contiguous(), weight, bias, mean, rstd, ctx.groups, ctx.relu
        )
        return dx, dw, db, None, None, None


def group_norm(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    relu: bool = False,
) -> torch.Tensor:
    """GroupNorm (+ relu) over the trailing channel axis of ``[B, S, C]``:
    the CUDA kernels for a CUDA tensor, the plain version for a CPU one."""
    if x.is_cuda:
        return GroupNormFunction.apply(x, weight, bias, groups, eps, relu)
    if x.device.type == "cpu":
        return group_norm_ref(x, weight, bias, groups, eps, relu)
    raise ValueError(f"group_norm: no kernel for device {x.device}")
