"""K3: flash attention on ``[B, H, T, D]`` f32 tensors, forward and backward.

The CUDA kernels live in ``csrc/flash_attention.cu``; they replace the JAX
package's ``ops/pallas/flash_attention.py`` ``_attn_fwd_kernel``,
``_attn_bwd_dkv_kernel`` and ``_attn_bwd_dq_kernel``. Two routes, chosen by
the sequence length:

- ``T <= SHORT_T`` (64; the language model's T = 35): :func:`attn_fwd_short`
  and :func:`attn_bwd_short` take the ``[B, H, T, D]`` operands as the
  strided views the model passes (last dimension contiguous), with no copy.
  The forward writes o into a ``[B, T, H, D]`` buffer and returns its
  ``[B, H, T, D]`` view, so the model's ``o.transpose(1, 2).reshape(b, t,
  e)`` is a view too; the one backward kernel computes ``delta =
  rowsum(dO * O)`` itself and writes dq, dk and dv in the layouts of q, k
  and v. :func:`plan` gives their launch plans.
- ``T > SHORT_T``: the tiled kernels :func:`attn_fwd`, :func:`attn_bwd_dkv`
  and :func:`attn_bwd_dq` on row-contiguous ``[BH, T, D]``, with ``delta``
  a plain torch op, as it stays outside Pallas in the JAX package. They
  compute on the tensor cores in 3xTF32; their tiles, shared-memory layout
  and block order are the kernels' own, and :func:`tiled_occupancy` reads
  what a block takes from them.

Each launcher takes CUDA tensors and raises on anything else. Their plain
PyTorch versions, the same math on whole ``[T, T]`` score matrices over any
leading dimensions, are :func:`attn_fwd_ref`, :func:`attn_bwd_short_ref`,
:func:`attn_bwd_dkv_ref` and :func:`attn_bwd_dq_ref`.
:class:`FlashAttentionFunction` saves q, k, v, o and lse; it runs the kernels
for CUDA tensors and the plain versions for CPU tensors, whose outputs take
the layouts the kernels give. :func:`attention_ref` is plain softmax
attention differentiated by autograd, the counterpart of the JAX package's
``parallel/ring.py`` ``reference_attention``.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

MAX_HEAD_DIM = 128
SHORT_T = 64  # the longest sequence of the short route
_NEG_INF = -1e30  # the TPU kernel's mask value

# Launch plan of the short route, set by measurement on an H100
# (scripts/flash_bench.py sweeps it): below SPLIT_BH heads the forward gives
# each block FWD_ROWS query rows (a few blocks a head, to fill the card),
# from it up a block takes a whole head; below BWD_SPLIT_BH heads the
# backward gives a head's dK/dV and its dQ to two blocks (one wave on the 132
# SMs), from it up one block takes both.
SPLIT_BH = 128
FWD_ROWS = 16
FWD_THREADS = 288
BWD_SPLIT_BH = 66
BWD_THREADS = 384

__all__ = [
    "FlashAttentionFunction",
    "SHORT_T",
    "attention_ref",
    "attn_bwd_dkv",
    "attn_bwd_dkv_ref",
    "attn_bwd_dq",
    "attn_bwd_dq_ref",
    "attn_bwd_ref",
    "attn_bwd_short",
    "attn_bwd_short_ref",
    "attn_fwd",
    "attn_fwd_ref",
    "attn_fwd_short",
    "flash_attention",
    "plan",
    "tiled_occupancy",
]


def _scale(d: int) -> float:
    return 1.0 / math.sqrt(d)


def _visible(t: int, causal: bool, device) -> torch.Tensor:
    """[T, T] bool: query row i sees key column j."""
    if not causal:
        return torch.ones((t, t), dtype=torch.bool, device=device)
    pos = torch.arange(t, device=device)
    return pos[:, None] >= pos[None, :]


def _heads_inner(b: int, h: int, t: int, d: int, like: torch.Tensor) -> torch.Tensor:
    """An empty ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer: the layout
    in which the model reads the attention output back as ``[B, T, H*D]``."""
    return torch.empty((b, t, h, d), dtype=like.dtype, device=like.device).transpose(1, 2)


def attention_ref(q, k, v, causal: bool = False) -> torch.Tensor:
    """Plain softmax attention, ``[B, H, T, D]`` -> ``[B, H, T, D]``."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q.shape[-1])
    if causal:
        s = s.masked_fill(~_visible(q.shape[2], True, q.device), float("-inf"))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)


def attn_fwd_ref(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of the forward kernels: ``(o, lse)`` over any leading
    dimensions (``[BH, T, D]`` or ``[B, H, T, D]``). For ``[B, H, T, D]`` o
    comes in the layout :func:`attn_fwd_short` gives it."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * _scale(q.shape[-1])
    vis = _visible(q.shape[-2], causal, q.device)
    s = s.masked_fill(~vis, _NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * vis
    l = p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    o = torch.einsum("...qk,...kd->...qd", p, v) / l
    if o.dim() == 4:
        o = _heads_inner(*o.shape, o).copy_(o)
    return o, (m + torch.log(l)).squeeze(-1)


def _probs_and_dscores(q, k, v, do, lse, delta, causal: bool):
    """``P = exp(S - lse)`` (0 where masked) and ``dS = P * (dP - delta)``."""
    s = torch.einsum("...qd,...kd->...qk", q, k) * _scale(q.shape[-1])
    p = torch.exp(s - lse[..., None]) * _visible(q.shape[-2], causal, q.device)
    dp = torch.einsum("...qd,...kd->...qk", do, v)
    return p, p * (dp - delta[..., None])


def attn_bwd_dkv_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dK/dV kernel: ``(dk, dv)`` from the saved ``lse``
    and ``delta = rowsum(dO * O)``."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    dk = _scale(q.shape[-1]) * torch.einsum("...qk,...qd->...kd", ds, q)
    return dk, torch.einsum("...qk,...qd->...kd", p, do)


def attn_bwd_dq_ref(q, k, v, do, lse, delta, causal: bool):
    """Plain version of the dQ kernel."""
    _, ds = _probs_and_dscores(q, k, v, do, lse, delta, causal)
    return _scale(q.shape[-1]) * torch.einsum("...qk,...kd->...qd", ds, k)


def attn_bwd_ref(q, k, v, do, lse, delta, causal: bool):
    """Both tiled backward kernels' plain versions: ``(dq, dk, dv)``."""
    dk, dv = attn_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
    return attn_bwd_dq_ref(q, k, v, do, lse, delta, causal), dk, dv


def attn_bwd_short_ref(q, k, v, do, o, lse, causal: bool):
    """Plain version of the fused backward kernel: ``(dq, dk, dv)`` from the
    saved o and lse, ``delta = rowsum(dO * O)`` computed inside; each
    gradient in the layout of its operand."""
    p, ds = _probs_and_dscores(q, k, v, do, lse, (do * o).sum(dim=-1), causal)
    scale = _scale(q.shape[-1])
    grads = (
        scale * torch.einsum("...qk,...kd->...qd", ds, k),
        scale * torch.einsum("...qk,...qd->...kd", ds, q),
        torch.einsum("...qk,...qd->...kd", p, do),
    )
    return tuple(torch.empty_like(x).copy_(g) for x, g in zip((q, k, v), grads))


def plan(bh: int, t: int, d: int) -> Tuple[Tuple[int, int], Tuple[int, int]]:
    """Launch plans of the short route for ``bh`` heads of ``[t, d]``:
    ``((rows, threads), (threads, parts))``, the forward's query rows a block
    and block size, and the backward's block size and blocks a head. ``d``
    does not enter yet: the constants were measured at the model's D = 100."""
    whole = (t + 3) // 4 * 4
    rows = min(FWD_ROWS, whole) if bh < SPLIT_BH else whole
    return (rows, FWD_THREADS), (BWD_THREADS, 2 if bh < BWD_SPLIT_BH else 1)


# ------------------------------------------------------------------ kernels


def _check(*ts: torch.Tensor) -> Tuple[int, int, int]:
    """(BH, T, D) of the tiled kernels' [BH, T, D] operands; raises on what
    they do not take."""
    q = ts[0]
    if not q.is_cuda:
        raise ValueError("the flash-attention kernels take CUDA tensors")
    if q.dim() != 3 or q.numel() == 0:
        raise ValueError(f"flash-attention kernel: want a non-empty [BH, T, D], got {tuple(q.shape)}")
    bh, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash-attention kernel: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if bh * t * d >= 2**31:
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


def _check_views(*ts: torch.Tensor) -> Tuple[int, int, int, int]:
    """(B, H, T, D) of the short kernels' [B, H, T, D] operands (any strides,
    last dimension contiguous); raises on what they do not take."""
    q = ts[0]
    if not q.is_cuda:
        raise ValueError("the flash-attention kernels take CUDA tensors")
    if q.dim() != 4 or q.numel() == 0:
        raise ValueError(f"flash-attention kernel: want a non-empty [B, H, T, D], got {tuple(q.shape)}")
    b, h, t, d = q.shape
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"flash-attention kernel: head dim {d} outside [1, {MAX_HEAD_DIM}]")
    if t > SHORT_T:
        raise ValueError(f"flash-attention short kernel: T = {t} > {SHORT_T}")
    if b * h >= 2**31:
        raise ValueError(f"flash-attention kernel: shape {tuple(q.shape)} too large")
    for x in ts:
        if x.dtype != torch.float32 or x.shape != q.shape or x.device != q.device:
            raise ValueError(
                f"flash-attention kernel: operands must be f32 {tuple(q.shape)} on {q.device}, "
                f"got {x.dtype} {tuple(x.shape)} on {x.device}"
            )
        if x.stride(-1) != 1:
            raise ValueError(
                f"flash-attention kernel: the last dimension must be contiguous, got strides {x.stride()}"
            )
    return b, h, t, d


def _lib() -> ctypes.CDLL:
    lib = runtime.load("flash_attention")
    if lib.attn_forward.argtypes is None:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.attn_forward.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_tiled_occupancy.argtypes = [i, i] + [ctypes.POINTER(i)] * 3
        lib.attn_forward_short.argtypes = [p, p, p, p, p, p, i, i, i, i, i, f, i, i, p]
        lib.attn_backward_short.argtypes = [p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, f, i, i, p]
        for fn in (lib.attn_forward, lib.attn_backward_dkv, lib.attn_backward_dq,
                   lib.attn_forward_short, lib.attn_backward_short, lib.attn_tiled_occupancy):
            fn.restype = i
    return lib


def _ptrs(*ts: torch.Tensor):
    return [ctypes.c_void_p(t.data_ptr()) for t in ts]


def _strides(*ts: torch.Tensor):
    """The (b, h, t) strides of each [B, H, T, D] operand, as a C array."""
    flat = [s for x in ts for s in x.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def _stream(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def attn_fwd_short(q, k, v, causal: bool, launch=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Short forward kernel (T <= 64) on ``[B, H, T, D]`` views: ``(o, lse)``,
    o a ``[B, H, T, D]`` view of a ``[B, T, H, D]`` buffer, lse a contiguous
    ``[B, H, T]``. ``launch`` = (rows, threads) overrides :func:`plan`."""
    b, h, t, d = _check_views(q, k, v)
    rows, threads = launch or plan(b * h, t, d)[0]
    o = _heads_inner(b, h, t, d, q)
    lse = torch.empty((b, h, t), device=q.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_forward_short(
            *_ptrs(q, k, v, o, lse), _strides(q, k, v, o), b, h, t, d, int(causal), _scale(d),
            rows, threads, _stream(q),
        )
    runtime.check(lib, err, "attn_forward_short")
    runtime.count("attn_fwd", device=q.device)
    return o, lse


def attn_bwd_short(q, k, v, do, o, lse, causal: bool, launch=None):
    """Fused backward kernel (T <= 64): ``(dq, dk, dv)`` from the saved o and
    lse, each in the layout of its operand (``torch.empty_like``).
    ``launch`` = (threads, parts) overrides :func:`plan`."""
    b, h, t, d = _check_views(q, k, v, do, o)
    if lse.dtype != torch.float32 or lse.shape != (b, h, t) or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"flash-attention kernel: lse must be contiguous f32 [{b}, {h}, {t}] on {q.device}")
    threads, parts = launch or plan(b * h, t, d)[1]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_backward_short(
            *_ptrs(q, k, v, do, o, lse, dq, dk, dv), _strides(q, k, v, do, o, dq, dk, dv),
            b, h, t, d, int(causal), _scale(d), threads, parts, _stream(q),
        )
    runtime.check(lib, err, "attn_backward_short")
    runtime.count("attn_bwd", device=q.device)
    return dq, dk, dv


def attn_fwd(q, k, v, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled forward kernel: ``(o [BH, T, D], lse [BH, T])``."""
    bh, t, d = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((bh, t), device=q.device, dtype=torch.float32)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_forward(*_ptrs(q, k, v, o, lse), bh, t, d, int(causal), _scale(d), _stream(q))
    runtime.check(lib, err, "attn_forward")
    runtime.count("attn_fwd_tiled", device=q.device)
    return o, lse


def attn_bwd_dkv(q, k, v, do, lse, delta, causal: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tiled dK/dV kernel: ``(dk, dv)``, each ``[BH, T, D]``."""
    bh, t, d = _check(q, k, v, do)
    _check_rows(bh, t, q.device, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_backward_dkv(
            *_ptrs(q, k, v, do, lse, delta, dk, dv), bh, t, d, int(causal), _scale(d), _stream(q)
        )
    runtime.check(lib, err, "attn_backward_dkv")
    runtime.count("attn_bwd_dkv", device=q.device)
    return dk, dv


def attn_bwd_dq(q, k, v, do, lse, delta, causal: bool) -> torch.Tensor:
    """Tiled dQ kernel: ``dq [BH, T, D]``."""
    bh, t, d = _check(q, k, v, do)
    _check_rows(bh, t, q.device, lse, delta)
    dq = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.attn_backward_dq(
            *_ptrs(q, k, v, do, lse, delta, dq), bh, t, d, int(causal), _scale(d), _stream(q)
        )
    runtime.check(lib, err, "attn_backward_dq")
    runtime.count("attn_bwd_dq", device=q.device)
    return dq


def tiled_occupancy(d: int) -> dict:
    """{"fwd", "dkv", "dq"} -> (blocks an SM holds, warps an SM, shared
    bytes a block, columns a staged row) of each tiled kernel at head dim
    ``d``, as the kernels lay out their tiles, by CUDA's occupancy
    calculator on the current card."""
    lib = _lib()
    out = {}
    for which, kernel in enumerate(("fwd", "dkv", "dq")):
        blocks, smem, cols = ctypes.c_int(0), ctypes.c_int(0), ctypes.c_int(0)
        err = lib.attn_tiled_occupancy(which, d, ctypes.byref(blocks), ctypes.byref(smem),
                                       ctypes.byref(cols))
        runtime.check(lib, err, "attn_tiled_occupancy")
        out[kernel] = (blocks.value, blocks.value * (4 if kernel == "fwd" else 8), smem.value, cols.value)
    return out


def _tiled_fwd(q, k, v, causal: bool):
    """The tiled forward on ``[B, H, T, D]``: flattened to ``[BH, T, D]``;
    the kernel for CUDA tensors, its plain version for CPU ones."""
    b, h, t, d = q.shape
    fwd = attn_fwd if q.is_cuda else attn_fwd_ref
    o, lse = fwd(*(x.reshape(b * h, t, d).contiguous() for x in (q, k, v)), causal)
    return o.view(b, h, t, d), lse.view(b, h, t)


def _tiled_bwd(q, k, v, do, o, lse, causal: bool):
    b, h, t, d = q.shape
    flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v, do, o)]
    lse = lse.reshape(b * h, t)
    delta = (flat[3] * flat[4]).sum(dim=-1)
    if q.is_cuda:
        dk, dv = attn_bwd_dkv(*flat[:4], lse, delta, causal)
        dq = attn_bwd_dq(*flat[:4], lse, delta, causal)
    else:
        dq, dk, dv = attn_bwd_ref(*flat[:4], lse, delta, causal)
    return tuple(g.view(b, h, t, d) for g in (dq, dk, dv))


class FlashAttentionFunction(torch.autograd.Function):
    """Autograd over ``[B, H, T, D]``: the short kernels at ``T <= SHORT_T``
    and the tiled ones above it for CUDA tensors, each route's plain
    versions for CPU tensors. Saves q, k, v, o and lse only."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        if q.shape[2] > SHORT_T:
            o, lse = _tiled_fwd(q, k, v, causal)
        elif q.is_cuda:
            o, lse = attn_fwd_short(q, k, v, causal)
        else:
            o, lse = attn_fwd_ref(q, k, v, causal)
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        if q.shape[2] > SHORT_T:
            dq, dk, dv = _tiled_bwd(q, k, v, do, o, lse, ctx.causal)
        elif q.is_cuda:
            dq, dk, dv = attn_bwd_short(q, k, v, do, o, lse, ctx.causal)
        else:
            dq, dk, dv = attn_bwd_short_ref(q, k, v, do, o, lse, ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Streaming-softmax attention, ``[B, H, T, D]`` -> ``[B, H, T, D]``, f32,
    differentiable. CUDA tensors run the K3 kernels, CPU tensors their plain
    versions. Views whose last dimension is contiguous (as the model's
    ``[B, T, H, D] -> [B, H, T, D]`` transposes are) are read in place."""
    if q.device.type not in ("cuda", "cpu"):
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    q, k, v = (x if x.stride(-1) == 1 else x.contiguous() for x in (q, k, v))
    return FlashAttentionFunction.apply(q, k, v, causal)
