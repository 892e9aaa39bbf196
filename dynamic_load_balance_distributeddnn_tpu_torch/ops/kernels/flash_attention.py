"""K3: flash attention on ``[B, H, T, D]`` f32 tensors, forward and backward.

The CUDA kernels live in ``csrc/flash_attention.cu``; they replace the JAX
package's ``ops/pallas/flash_attention.py`` ``_attn_fwd_kernel``,
``_attn_bwd_dkv_kernel`` and ``_attn_bwd_dq_kernel``. The forward writes the
output and the per-row log-sum-exp; :class:`FlashAttentionFunction` saves
q, k, v, o and lse only, and its backward recomputes the scores in the two
backward kernels from ``delta = rowsum(dO * O)``, which stays a plain torch
op as it stays outside Pallas in the JAX package.

Each launcher takes ``[BH, T, D]`` row-contiguous f32 CUDA tensors and raises
on anything else; :func:`attn_fwd_ref`, :func:`attn_bwd_dkv_ref` and
:func:`attn_bwd_dq_ref` are their plain PyTorch versions, the same math on
whole ``[T, T]`` score matrices. :func:`flash_attention` routes by where the tensors live: CUDA through the
kernels, CPU through the plain versions, with the same autograd function.
:func:`attention_ref` is plain softmax attention differentiated by autograd,
the counterpart of the JAX package's ``parallel/ring.py``
``reference_attention``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

MAX_HEAD_DIM = 128
_NEG_INF = -1e30  # the TPU kernel's mask value

__all__ = [
    "FlashAttentionFunction",
    "attention_ref",
    "attn_bwd_dkv",
    "attn_bwd_dkv_ref",
    "attn_bwd_dq",
    "attn_bwd_dq_ref",
    "attn_bwd_ref",
    "attn_fwd",
    "attn_fwd_ref",
    "flash_attention",
]


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _visible(t: int, causal: bool, device) -> torch.Tensor:
    """[T, T] bool: query row i sees key column j."""
    if not causal:
        return torch.ones((t, t), dtype=torch.bool, device=device)
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def attention_ref(q, k, v, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention, ``[B, H, T, D]`` -> ``[B, H, T, D]``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q.shape[-1])
    if causal:
        s = s.masked_fill(~_visible(q.shape[2], True, q.device), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def attn_fwd_ref(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernel on ``[BH, T, D]``: ``(o, lse)``."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * _scale(q.shape[-1])
    vis = _visible(q.shape[1], causal, q.device)
    s = s.masked_fill(~vis, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * vis
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("bqk,bkd->bqd", p, v) / l
    return o, (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool):
    """``P = exp(S - lse)`` (0 where masked) and ``dS = P * (dP - delta)``."""
    s = torch.einsum("bqd,bkd->bqk", q, k) * _scale(q.shape[-1])
    p = torch.exp(s - lse[..., None]) * _visible(q.shape[1], causal, q.device)
    dp = torch.einsum("bqd,bkd->bqk", do, v)
    return p, p * (dp - delta[..., None])


def attn_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dK/dV kernel on ``[BH, T, D]``: ``(dk, dv)`` from
    the saved ``lse`` and ``delta = rowsum(dO * O)``."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    dk = _scale(q.shape[-1]) * torch.einsum("bqk,bqd->bkd", ds, q)
    return dk, torch.einsum("bqk,bqd->bkd", p, do)


def attn_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dQ kernel on ``[BH, T, D]``."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    return _scale(q.shape[-1]) * torch.einsum("bqk,bkd->bqd", ds, k)


def attn_bwd_ref(q, k, v, do, lse, delta, causal: bool):
    """Both backward kernels' plain versions: ``(dq, dk, dv)``."""
    dk, dv = attn_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    return attn_bwd_dq_ref(q, k, v, do, lse, delta, causal), dk, dv


# ------------------------------------------------------------------ kernels


def _check(*ts: torch.Tensor) -> Tuple[int, int, int]:
    """(BH, T, D) of the [BH, T, D] operands; raises on what the kernels do
    not take."""
    q = ts[0]
    if not q.is_cuda:
        raise ValueError("the flash-attention kernels take CUDA tensors")
    if q.dim() != 3 or q.numel() == 0:
        raise ValueError(f"flash-attention kernel: want a non-empty [BH, T, D], got {tuple(q.shape)}")
    bh, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash-attention kernel: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if bh > 65535 or bh * t * d >= 2**31:
        raise ValueError(f"flash-attention kernel: shape {tuple(q.shape)} too large")
    for x in ts:
        if x.dtype != torch.float32 or x.shape != q.shape or not x.is_contiguous() or x.device != q.device:
            raise ValueError(
                "flash-attention kernel: operands must be contiguous f32 "
                f"{tuple(q.shape)} on {q.device}, got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
    return bh, t, d


def _check_rows(bh: int, t: int, device, *rows: torch.Tensor) -> None:
    for r in rows:
        if r.dtype != torch.float32 or r.shape != (bh, t) or not r.is_contiguous() or r.device != device:
            raise ValueError(f"flash-attention kernel: lse/delta must be contiguous f32 [{bh}, {t}] on {device}")


def _lib() -> ctypes.CDLL:
    lib = runtime.load("flash_attention")
    if lib.attn_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_forward.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
        for fn in (lib.attn_forward, lib.attn_backward_dkv, lib.attn_backward_dq):
            fn.restype = i
    return lib


def _ptrs(*ts: torch.Tensor):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def attn_fwd(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward kernel: ``(o [BH, T, D], lse [BH, T])``."""
    bh, t, d = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device=q.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_forward(*_ptrs(q, k, v, o, lse), bh, t, d, int(causal), _scale(d), _stream(q))
    runtime.check(lib, err, "attn_forward")
    runtime.LAUNCHES["attn_fwd"] += 1
    return o, lse


def attn_bwd_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """dK/dV kernel: ``(dk, dv)``, each ``[BH, T, D]``."""
    bh, t, d = _check(q, k, v, do)
    _check_rows(bh, t, q.device, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_backward_dkv(
            *_ptrs(q, k, v, do, lse, delta, dk, dv), bh, t, d, int(causal), _scale(d), _stream(q)
        )
    runtime.check(lib, err, "attn_backward_dkv")
    runtime.LAUNCHES["attn_bwd_dkv"] += 1
    return dk, dv


def attn_bwd_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """dQ kernel: ``dq [BH, T, D]``."""
    bh, t, d = _check(q, k, v, do)
    _check_rows(bh, t, q.device, lse, delta)
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_backward_dq(
            *_ptrs(q, k, v, do, lse, delta, dq), bh, t, d, int(causal), _scale(d), _stream(q)
        )
    runtime.check(lib, err, "attn_backward_dq")
    runtime.LAUNCHES["attn_bwd_dq"] += 1
    return dq


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd over ``[BH, T, D]``: the kernels for CUDA tensors, their plain
    versions for CPU tensors. Saves q, k, v, o and lse only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        o, lse = attn_fwd(q, k, v, causal) if q.is_cuda else attn_fwd_ref(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do * o).sum(dim=-1)
        if q.is_cuda:
            dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, ctx.causal)
            dq = attn_bwd_dq(q, k, v, do, lse, delta, ctx.causal)
        else:
            dq, dk, dv = attn_bwd_ref(q, k, v, do, lse, delta, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Streaming-softmax attention, ``[B, H, T, D]`` -> ``[B, H, T, D]``, f32,
    differentiable. CUDA tensors run the K3 kernels, CPU tensors their plain
    versions."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    b, h, t, d = q.shape
    flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v)]
    return FlashAttentionFunction.apply(*flat, causal).reshape(b, h, t, d)
