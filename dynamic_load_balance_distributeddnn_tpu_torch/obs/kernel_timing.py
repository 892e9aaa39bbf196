"""Kernel timing on an NVIDIA card: device time, event wall and bounds.

``chip_smoke.py`` and ``scripts/xent_bench.py`` time the port's kernels
with these helpers, so both read one measuring stick. Everything here needs
a CUDA device except :func:`bound` and :func:`xent_work`.
"""

from __future__ import annotations

import statistics
import subprocess
import warnings
from typing import Callable, Dict, Tuple

import torch

# H100 SXM peaks (NVIDIA data sheet): device memory rate and f32 outside the
# tensor cores, the type these kernels compute in.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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
            per_call_us = 0.0
            for ev in prof.key_averages():  # one entry per kernel name
                us = getattr(ev, "self_device_time_total", None)
                us = us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)
                if us > 0:
                    per_call_us += us / ev.count * max(1, round(ev.count / reps))
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


def card() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]


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
