"""Kernel timing on an NVIDIA card: device time, event wall and bounds.

``chip_smoke.py``, ``scripts/gn_bench.py``, ``scripts/xent_bench.py`` and
``scripts/flash_bench.py`` time the port's kernels with these helpers, so
all read one measuring stick. Everything here needs a CUDA device except
:func:`bound`, :func:`bound_3xtf32`, :func:`gn_work`, :func:`xent_work` and
:func:`attn_work`.
"""

from __future__ import annotations

import statistics
import subprocess
import warnings
from typing import Callable, Dict, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet): device memory rate, f32 outside the
# tensor cores (the type these kernels compute in), and dense TF32 on the
# tensor cores (K3's tiled route: each f32 product as three TF32 ones).
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
TF32_FLOPS_PER_S = 494.7e12


def cuda_ms(fn: Callable[[], object], reps: int = 10, warmup: int = 2) -> float:
    """Median wall of ``fn`` in ms between CUDA events recorded around each
    call: device time plus any gap where the card waited for the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_us(prof) -> Dict[str, Tuple[float, int]]:
    """{name: (microseconds, records)} of the device's activity (kernels,
    copies, fills) in a finished ``torch.profiler.profile``, read off its
    raw records. ``key_averages()`` builds a Python event for every record,
    host and device, first: read that way, ``chip_smoke.py`` [3]'s timing
    took 127-149 s on an H100 (700 W), and 44 s read off the records, with
    the same readings."""
    out: Dict[str, Tuple[float, int]] = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == torch.autograd.DeviceType.CUDA and ev.duration_ns() > 0:
            us, n = out.get(ev.name(), (0.0, 0))
            out[ev.name()] = (us + ev.duration_ns() / 1e3, n + 1)
    return out


def device_ms(fn: Callable[[], object], reps: int = 5, windows: int = 3) -> float:
    """Device time of ``fn`` in ms: the CUDA kernel time ``torch.profiler``
    records over ``reps`` calls (after two warm-up calls), per call, the
    median of ``windows`` profiled windows. Unlike an event wall it excludes
    the gaps where the card waits for the host.

    On the card the profiler sometimes loses kernel records: a window came
    back with none (after 8 and after 108 windows in one process), and in
    one process every 5-call window held 4 records. So each kernel name
    adds its mean time per record times the records of it one call makes
    (``round(count / reps)``), which a lost record does not shorten; an
    empty window is profiled again, up to ``windows`` more times."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    times, empty = [], 0
    while len(times) < windows:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            per_call_us = sum(us / n * max(1, round(n / reps)) for us, n in kernel_us(prof).values())
        if per_call_us > 0:
            times.append(per_call_us / 1e3)
            continue
        empty += 1
        print("  (a profiled window recorded no device time; profiling it again)", flush=True)
        if empty > windows:
            raise RuntimeError(f"the profiler recorded no device time in {empty} windows")
    return statistics.median(times)


def timed(fn: Callable[[], object], reps: int = 5) -> Dict[str, float]:
    """{"ms": device time, "wall_ms": CUDA-event wall} of ``fn``."""
    return {"ms": device_ms(fn, reps), "wall_ms": cuda_ms(fn, reps)}


def bound(nbytes: float, flops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def bound_3xtf32(nbytes: float, flops: float) -> Tuple[float, str]:
    """(bound_ms, bound_by) of a kernel that forms each f32 product from
    three TF32 products on the tensor cores: the larger of bytes over the
    memory rate and 3 x operations over the TF32 peak."""
    return bound(nbytes, 3 * flops * F32_FLOPS_PER_S / TF32_FLOPS_PER_S)


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def gn_work(shapes, groups: int = 32, elem: int = 4) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} of K1 over a set of ``[b, s, c]`` calls
    in ``groups`` groups (or ``[b, s, c, groups]`` calls, each with its
    own), ``elem`` bytes an activation: the forward reads x, scale and bias
    once and writes y, mean and rstd; the backward reads x, dy, scale, bias,
    mean and rstd once and writes dx, dscale and dbias. Operations: 6 an
    element forward (sum, square, normalise, affine, relu), 16 backward."""
    n = sum(sh[0] * sh[1] * sh[2] for sh in shapes)
    params = sum(2 * sh[2] * 4 for sh in shapes)
    stats = sum(2 * sh[0] * (sh[3] if len(sh) > 3 else groups) * 4 for sh in shapes)
    return {
        "groupnorm_fwd": (2 * n * elem + params + stats, 6 * n),
        "groupnorm_bwd": (3 * n * elem + params + stats + params, 16 * n),
    }


def xent_work(r: int, v: int) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} of K2 on [r, v] f32: the forward reads
    the logits and labels once and writes loss and lse; the backward reads
    logits, labels, g and lse once and writes dx once. Operations: about
    four per element each way (max, subtract, exp, add; subtract, exp,
    subtract the onehot, scale)."""
    n = r * v
    return {
        "xent_fwd": (4 * n + 8 * r + 4 * r + 4 * r, 4 * n),
        "xent_bwd": (4 * n + 8 * r + 4 * r + 4 * r + 4 * n, 4 * n),
    }


def xent_inputs(r: int, v: int, dev: torch.device, seed: int = 3):
    """K2's timing inputs on the card: seeded f32 logits ``[r, v]`` (randn),
    labels, ``g`` = 1/512 a row, and the forward kernel's lse."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import xent_fwd

    gen = torch.Generator(device=dev).manual_seed(seed)
    logits = torch.randn((r, v), device=dev, generator=gen)
    labels = torch.randint(0, v, (r,), device=dev, generator=gen)
    g = torch.full((r,), 1.0 / 512, device=dev)
    return logits, labels, g, xent_fwd(logits, labels)[1]


def xent_yardsticks(logits, labels, g, lse, reps: int, backward: bool = True) -> Dict[str, dict]:
    """{kernel: {"plain_ms", "library_ms", "bound_ms", "bound_by"}} for K2's
    forward (and backward) on these inputs: the plain versions, and
    ``F.cross_entropy(reduction="none")`` as the library yardstick (its
    backward through autograd)."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        xent_bwd_ref,
        xent_fwd_ref,
    )

    out = {"xent_fwd": {
        "plain_ms": device_ms(lambda: xent_fwd_ref(logits, labels), reps),
        "library_ms": device_ms(lambda: F.cross_entropy(logits, labels, reduction="none"), reps),
    }}
    if backward:
        lr = logits.clone().requires_grad_()
        lib = F.cross_entropy(lr, labels, reduction="none")
        out["xent_bwd"] = {
            "plain_ms": device_ms(lambda: xent_bwd_ref(logits, labels, g, lse), reps),
            "library_ms": device_ms(lambda: torch.autograd.grad(lib, lr, g, retain_graph=True), reps),
        }
        del lr, lib
    for name, (nbytes, ops) in xent_work(*logits.shape).items():
        if name in out:
            out[name]["bound_ms"], out[name]["bound_by"] = bound(nbytes, ops)
    return out


def attn_work(shape, causal: bool) -> Dict[str, Tuple[int, int]]:
    """{kernel: (bytes, operations)} of K3 on ``(B, H, T, D)`` f32: each input
    read once and each output written once; the flops of the two (forward),
    five (fused backward: S, dP, dV, dK, dQ), four (dK/dV) or three (dQ)
    products over the (query, key) pairs the mask leaves visible, 2*D each,
    and the fused backward's 2*D per row for delta = rowsum(dO * O) (the exps
    and the softmax arithmetic are not counted). The fused backward reads o
    and writes no delta; the tiled ones read the caller's delta."""
    b, h, t, d = shape
    bh = b * h
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    mat, rows = bh * t * d * 4, bh * t * 4
    fwd = (3 * mat + mat + rows, 2 * 2 * d * pairs)
    return {
        "attn_fwd": fwd,
        "attn_bwd": (5 * mat + rows + 3 * mat, 5 * 2 * d * pairs + 2 * d * bh * t),
        "attn_fwd_tiled": fwd,
        "attn_bwd_dkv": (4 * mat + 2 * rows + 2 * mat, 4 * 2 * d * pairs),
        "attn_bwd_dq": (4 * mat + 2 * rows + mat, 3 * 2 * d * pairs),
    }


def attn_inputs(shape, dev: torch.device, seed: int = 11, layout: str = "model"):
    """K3's inputs q, k (0.5 randn), v and dO (randn) as ``[B, H, T, D]`` f32
    on the card, seeded: ``layout="model"`` gives views of ``[B, T, H*D]``
    buffers, as the language model's projections (and autograd's dO) give
    them; ``"contiguous"`` gives contiguous tensors."""
    b, h, t, d = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    out = []
    for scale in (0.5, 0.5, 1.0, 1.0):
        if layout == "model":
            x = torch.randn((b, t, h * d), device=dev, generator=gen).view(b, t, h, d).transpose(1, 2)
        else:
            x = torch.randn((b, h, t, d), device=dev, generator=gen)
        out.append(x.mul_(scale))
    return out


def attn_yardsticks(q, k, v, do, causal: bool, reps: int, backward: bool = True) -> Dict[str, dict]:
    """{kernel: {"plain_ms", "library_ms", "bound_ms", "bound_by"}} for the
    short route's forward (and fused backward) on these ``[B, H, T, D]``
    inputs: the plain versions, and ``F.scaled_dot_product_attention`` on the
    same views as the library yardstick (forward on inputs that require
    grad; its backward, one call for dq, dk and dv, through autograd)."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attn_bwd_short_ref,
        attn_fwd_ref,
    )

    ql, kl, vl = (x.detach().requires_grad_() for x in (q, k, v))
    out = {"attn_fwd": {
        "plain_ms": device_ms(lambda: attn_fwd_ref(q, k, v, causal), reps),
        "library_ms": device_ms(
            lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal), reps),
    }}
    if backward:
        o, lse = attn_fwd_ref(q, k, v, causal)
        lib = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal)
        out["attn_bwd"] = {
            "plain_ms": device_ms(lambda: attn_bwd_short_ref(q, k, v, do, o, lse, causal), reps),
            "library_ms": device_ms(
                lambda: torch.autograd.grad(lib, (ql, kl, vl), do, retain_graph=True), reps),
        }
        del o, lse, lib
    for name, (nbytes, ops) in attn_work(tuple(q.shape), causal).items():
        if name in out:
            out[name]["bound_ms"], out[name]["bound_by"] = bound(nbytes, ops)
    return out
