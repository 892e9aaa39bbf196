"""K1: fused GroupNorm (+ relu) on channels-last ``[B, S, C]`` activations.

The CUDA kernels live in ``csrc/groupnorm.cu`` (they replace the JAX
package's ``ops/pallas/groupnorm.py`` ``_gn_fwd_kernel`` and
``_fused_gn_bwd``). ``group_norm`` routes by where the tensor lives: a CUDA
tensor goes through :class:`GroupNormFunction` (kernel forward, kernel
backward), a CPU tensor through :func:`group_norm_ref`, the plain PyTorch
version with the same arithmetic, differentiated by autograd.

On the card, :func:`plan` picks one of two routes by shape:

- ``"tiled"``: a block, or a cluster of up to 8 blocks splitting S, stages
  a (batch element, channel tile) slab in shared memory and reads x (and
  dy) from device memory once. A tile is a whole number of groups whose
  rows are 16-byte vectors, so C must be a multiple of 4 (f32) or 8 (bf16),
  and the slab must fit the cluster's shared memory.
- ``"general"``: one block per (batch element, group), for every other
  shape (the first port's kernels).

Statistics are f32 whatever the input dtype (f32 or bf16); the output keeps
the input dtype; the variance is ``max(E[x^2] - mean^2, 0)`` like the TPU
kernel's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ELEM = {torch.float32: 4, torch.bfloat16: 2}
_VEC_BYTES = 16  # a thread's load on the tiled route
_MAX_SMEM = 227 * 1024  # dynamic shared memory a block may hold on an H100
_GENERAL_SMEM = 48 * 1024  # the general backward's, default limit
_THREADS = 256  # kThreads in csrc/groupnorm.cu (the general route)
MAX_THREADS = 512  # kMaxThreads (the tiled route)
MAX_CLUSTER = 8  # the portable cluster size

# Launch plan of the tiled route, set by measurement on an H100
# (scripts/gn_bench.py sweeps these constants). A tile row spans at least
# TILE_BYTES where C allows; S is split over a cluster while a block would
# stage more than SLAB_BYTES (x, and dy in the backward); a block has
# ROW_THREADS threads a staged row, a power of two from MIN_THREADS to
# THREADS, and never more than its slab has 16-byte vectors.
TILE_BYTES = 128
SLAB_BYTES = 96 * 1024
ROW_THREADS = 2
MIN_THREADS = 64
THREADS = 256


class Plan(NamedTuple):
    """A launch plan: the route; the channels a block owns (the tiled
    route's tile, the general route's group); the blocks of a cluster that
    split S; threads a block; rows of S a block stages; 16-byte vector slots
    a tile row (a power of two; 0 on the general route); dynamic shared
    memory a block, in bytes."""

    route: str
    tile: int
    cluster: int
    threads: int
    rows: int
    vpad: int
    smem: int


def _pow2(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def general_plan(s: int, cg: int, backward: bool) -> Plan:
    """The general route: a block of 256 threads per (batch element, group);
    the backward's partial sums take 2 * R * cg floats of shared memory."""
    return Plan("general", cg, 1, _THREADS, s, 0,
                2 * 4 * max(_THREADS // cg, 1) * cg if backward else 0)


def tiled_plan(s: int, tile: int, cg: int, cluster: int, threads: int,
               dtype: torch.dtype = torch.float32, backward: bool = False) -> Plan:
    """The tiled route's launch for a tile of ``tile`` channels (whole groups
    of ``cg``, whole 16-byte vectors), S split over ``cluster`` blocks of at
    most ``threads`` threads: the block is cut to the slab's vectors and
    kept at least one warp and one tile row; shared memory holds the staged
    rows and the sums, as ``csrc/groupnorm.cu`` lays them out."""
    nvec = tile * _ELEM[dtype] // _VEC_BYTES
    vpad = _pow2(nvec)
    rows = -(-s // cluster)
    nt = max(min(threads, _pow2(rows * vpad)), vpad, 32)
    parts = nt // max(vpad, 32)  # partial rows of the block's reduction
    smem = (rows * nvec * _VEC_BYTES * (2 if backward else 1)
            + 4 * (2 * parts * tile + 4 * tile + 2 * (tile // cg)))
    return Plan("tiled", tile, cluster, nt, rows, vpad, smem)


@functools.lru_cache(maxsize=4096)
def plan(
    b: int,
    s: int,
    c: int,
    groups: int,
    dtype: torch.dtype = torch.float32,
    backward: bool = False,
) -> Plan:
    """The launch plan for ``[b, s, c]`` in ``groups`` groups, forward or
    backward, from the shape alone and the module's constants. Cached: the
    wrapper asks for every call, and a model asks again for the same shapes
    every step (``scripts/gn_bench.py`` clears the cache when it sets the
    constants)."""
    cg = c // groups
    general = general_plan(s, cg, backward)
    elem = _ELEM[dtype]
    vec = _VEC_BYTES // elem
    if c % vec or b > 65535:
        return general
    # k groups a tile, k | groups, rows of whole 16-byte vectors: the
    # narrowest such tile of at least TILE_BYTES a row, else the whole row
    ks = [k for k in range(1, groups + 1) if groups % k == 0 and k * cg % vec == 0]
    k = next((k for k in ks if k * cg * elem >= TILE_BYTES), ks[-1])
    w = k * cg
    if _pow2(w // vec) > MAX_THREADS:
        return general
    staged = s * w * elem * (2 if backward else 1)
    cluster = 1
    # double the cluster while every rank keeps at least one row
    while (cluster < MAX_CLUSTER and (2 * cluster - 1) * -(-s // (2 * cluster)) < s
           and staged > cluster * SLAB_BYTES):
        cluster *= 2
    rows = -(-s // cluster)
    threads = min(THREADS, max(MIN_THREADS, _pow2(rows * ROW_THREADS)))
    p = tiled_plan(s, w, cg, cluster, threads, dtype, backward)
    return general if p.smem > _MAX_SMEM else p


def _stats(xg: torch.Tensor, eps: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 mean and rstd over dims 1 and 3 of ``[B, S, G, C/G]``, kept."""
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = torch.clamp((xg * xg).mean(dim=(1, 3), keepdim=True) - mean * mean, min=0.0)
    return mean, torch.rsqrt(var + eps)


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
    CPU tensors take. Computes in f32, or f64 for an f64 input (flax's
    GroupNorm promotes to at least f32 the same way)."""
    b, s, c = x.shape
    dt = torch.promote_types(x.dtype, torch.float32)
    xf = x.to(dt).reshape(b, s, groups, c // groups)
    mean, rstd = _stats(xf, eps)
    xhat = ((xf - mean) * rstd).reshape(b, s, c)
    y = xhat * weight.to(dt) + bias.to(dt)
    if relu:
        y = torch.relu(y)
    return y.to(x.dtype)


def group_norm_stats_ref(x: torch.Tensor, groups: int, eps: float = 1e-6):
    """Plain version of the forward kernel's saved statistics: ``(mean,
    rstd)``, [B, G] f32."""
    b, s, c = x.shape
    mean, rstd = _stats(x.float().reshape(b, s, groups, c // groups), eps)
    return mean.reshape(b, groups), rstd.reshape(b, groups)


def group_norm_bwd_ref(
    x: torch.Tensor,
    dy: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    groups: int,
    relu: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the backward kernel on the same inputs: ``(dx,
    dweight, dbias)`` from the saved [B, G] ``mean``/``rstd``, in f32, dx in
    x's dtype. The relu mask is recomputed from them as the kernel does it,
    ``xhat * w + b > 0`` rounded after the product and after the sum, so the
    two agree on it bit for bit; autograd through :func:`group_norm_ref`
    takes it from its own statistics instead, and disagrees where the
    pre-activation is within rounding of zero."""
    b, s, c = x.shape
    cg = c // groups
    xf = x.float().reshape(b, s, groups, cg)
    mu, rs = mean.reshape(b, 1, groups, 1), rstd.reshape(b, 1, groups, 1)
    w = weight.float().reshape(1, 1, groups, cg)
    xhat = (xf - mu) * rs
    d = dy.float().reshape(b, s, groups, cg)
    if relu:
        d = torch.where(xhat * w + bias.float().reshape(1, 1, groups, cg) > 0, d, torch.zeros_like(d))
    dxhat = d * w
    n = s * cg
    sdx = dxhat.sum(dim=(1, 3), keepdim=True)
    sdxx = (dxhat * xhat).sum(dim=(1, 3), keepdim=True)
    dx = rs / n * (n * dxhat - sdx - xhat * sdxx)
    return (dx.reshape(b, s, c).to(x.dtype), (d * xhat).sum(dim=(0, 1)).reshape(c),
            d.sum(dim=(0, 1)).reshape(c))


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
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gn_forward.argtypes = [p] * 6 + [i] * 4 + [f, i, i, p]
        lib.gn_forward.restype = i
        lib.gn_backward.argtypes = [p] * 11 + [i] * 6 + [p]
        lib.gn_backward.restype = i
        lib.gn_forward_tiled.argtypes = [p] * 6 + [i] * 10 + [f, i, i, p]
        lib.gn_forward_tiled.restype = i
        lib.gn_backward_tiled.argtypes = [p] * 11 + [i] * 12 + [p]
        lib.gn_backward_tiled.restype = i
    return lib


def _route(x: torch.Tensor, groups: int, backward: bool, launch: Optional[Plan],
           *operands: torch.Tensor) -> Plan:
    """``launch`` or :func:`plan`'s choice. A tiled plan needs 16-byte
    aligned operands (a contiguous view whose storage offset is not a whole
    number of vectors is not): such inputs take the general route, and a
    tiled ``launch`` for them raises."""
    b, s, c = x.shape
    p = launch or plan(b, s, c, groups, x.dtype, backward)
    if p.route == "tiled" and any(t.data_ptr() % _VEC_BYTES for t in operands):
        if launch is not None:
            raise ValueError("GroupNorm kernel: the tiled route needs 16-byte aligned operands")
        p = general_plan(s, c // groups, backward)
    if p.route == "general" and backward and p.smem > _GENERAL_SMEM:
        raise ValueError(f"GroupNorm kernel: {c // groups} channels per group is too many")
    return p


def _count(key: str, p: Plan, x: torch.Tensor) -> None:
    """One launch of ``key``, and of its general-route and bf16 shares."""
    runtime.count(key, device=x.device)
    if p.route == "general":
        runtime.count(key + "_general", device=x.device)
    if x.dtype == torch.bfloat16:
        runtime.count(key + "_bf16", device=x.device)


def _tiled_args(p: Plan):
    return (p.tile, p.vpad.bit_length() - 1, p.rows, p.cluster, p.threads, p.smem)


def group_norm_fwd(
    x: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    groups: int,
    eps: float = 1e-6,
    relu: bool = False,
    launch: Optional[Plan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel forward: ``(y, mean, rstd)`` with ``mean``/``rstd`` [B, G] f32.
    ``launch`` overrides :func:`plan`."""
    _check(x, weight, bias, groups)
    p = _route(x, groups, False, launch, x)
    b, s, c = x.shape
    y = torch.empty_like(x)
    mean = torch.empty((b, groups), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    lib = _lib()
    ptrs = (_ptr(x), _ptr(weight), _ptr(bias), _ptr(y), _ptr(mean), _ptr(rstd))
    with torch.cuda.device(x.device):
        if p.route == "tiled":
            err = lib.gn_forward_tiled(*ptrs, b, s, c, groups, *_tiled_args(p), float(eps),
                                       int(relu), _DTYPES[x.dtype], _stream(x))
        else:
            err = lib.gn_forward(*ptrs, b, s, c, groups, float(eps), int(relu),
                                 _DTYPES[x.dtype], _stream(x))
    runtime.check(lib, err, f"gn_forward ({p.route})")
    _count("groupnorm_fwd", p, x)
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
    launch: Optional[Plan] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel backward: ``(dx, dweight, dbias)`` from the forward's saved
    ``mean``/``rstd``; the relu mask is recomputed from them. ``launch``
    overrides :func:`plan`."""
    _check(x, weight, bias, groups)
    b, s, c = x.shape
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError("GroupNorm kernel: dy must match x in shape, dtype and layout")
    for name, t in (("mean", mean), ("rstd", rstd)):
        if t.shape != (b, groups) or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"GroupNorm kernel: {name} must be contiguous f32 [{b}, {groups}]")
    p = _route(x, groups, True, launch, x, dy)
    dx = torch.empty_like(x)
    part = torch.empty((2, b, c), device=x.device, dtype=torch.float32)
    dw = torch.empty((c,), device=x.device, dtype=torch.float32)
    db = torch.empty_like(dw)
    lib = _lib()
    ptrs = (_ptr(x), _ptr(dy), _ptr(weight), _ptr(bias), _ptr(mean), _ptr(rstd), _ptr(dx),
            _ptr(part[0]), _ptr(part[1]), _ptr(dw), _ptr(db))
    with torch.cuda.device(x.device):
        if p.route == "tiled":
            err = lib.gn_backward_tiled(*ptrs, b, s, c, groups, *_tiled_args(p), int(relu),
                                        _DTYPES[x.dtype], _stream(x))
        else:
            err = lib.gn_backward(*ptrs, b, s, c, groups, int(relu), _DTYPES[x.dtype],
                                  _stream(x))
    runtime.check(lib, err, f"gn_backward ({p.route})")
    _count("groupnorm_bwd", p, x)
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
