#!/usr/bin/env python3
"""K1 (GroupNorm + relu) launch plans on an NVIDIA card.

    python3 scripts/gn_bench.py [--batches 32,128,160] [--rounds N] [--dtype f32|bf16] [--out DIR]

Times the forward and backward kernels of ``csrc/groupnorm.cu`` over the 120
GroupNorm calls of one DenseNet-121 forward (relu on, the shapes of
``models/densenet.py`` ``gn_shapes``) at each batch of the vision path's
plans (32, 128, 160), under each candidate launch plan: ``plan`` as it
stands, then ``plan`` with its module constants set otherwise (a fixed
block size in place of the threads-a-row rule, ``SLAB_BYTES``,
``TILE_BYTES``), and the general route (the first port's kernels, "was").
Each
set is timed stage by stage (S = 1024, 256, 64, 16: blocks 1-4 with their
transitions), the candidates alternating over ``--rounds`` rounds (default
3), so each one's spread shows beside the differences; a candidate's set
time is the sum of its stages' medians. Device time, bounds and the
measuring helpers are those of ``chip_smoke.py`` (``obs/kernel_timing.py``).

Then, for ``plan`` as it stands and for the general route: the device time
of each kernel (in the backward, the route's kernel and the second kernel
that sums the dscale/dbias partials over B) at each batch; the host time of
one wrapper call; and whether ``GroupNormFunction.backward`` ever receives
a ``dy`` that is not contiguous in one DenseNet-121 training step (forward
and backward at b = 32), i.e. whether its ``dy.contiguous()`` copies.

These are the numbers behind ``plan`` in ``ops/kernels/groupnorm.py``. The
table goes to ``<out>/gn_bench.json`` (default ``chiprun_out/gn_bench``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import statistics
import sys
import warnings

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GROUPS = 32
# (name, constants of ops/kernels/groupnorm.py for plan); "general" is the
# general route
CANDIDATES = [
    ("plan", {}),
    ("threads 64", {"MIN_THREADS": 64, "THREADS": 64}),
    ("threads 128", {"MIN_THREADS": 128, "THREADS": 128}),
    ("threads 256", {"MIN_THREADS": 256, "THREADS": 256}),
    ("slab 32K", {"SLAB_BYTES": 32 * 1024}),
    ("slab 192K", {"SLAB_BYTES": 192 * 1024}),
    ("tile 256B", {"TILE_BYTES": 256}),
    ("general", None),
]


@contextlib.contextmanager
def constants(groupnorm, values):
    """``groupnorm.plan`` under ``values`` in place of the module's
    constants (its cache cleared on the way in and out)."""
    saved = {k: getattr(groupnorm, k) for k in values}
    for k, v in values.items():
        setattr(groupnorm, k, v)
    groupnorm.plan.cache_clear()
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(groupnorm, k, v)
        groupnorm.plan.cache_clear()


def kernel_ms(torch, fn, reps: int = 5):
    """{kernel name: device ms a call of ``fn``}, one profiled window."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        us = us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)
        if us > 0:
            out[ev.key] = us / reps / 1e3
    return out


def host_us(torch, dev, calls: int = 2000):
    """Host time of one wrapper call in µs, at a shape small enough that the
    card waits on the host: the wall of ``calls`` calls over ``calls``, for
    the forward and backward on the route ``plan`` picks and, forced, on the
    general route."""
    import time

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        general_plan,
        group_norm_bwd,
        group_norm_fwd,
    )

    x = torch.randn(2, 16, 64, device=dev)
    w, bias = torch.ones(64, device=dev), torch.zeros(64, device=dev)
    _, mean, rstd = group_norm_fwd(x, w, bias, GROUPS, 1e-6, True)
    runs = {
        "fwd": lambda: group_norm_fwd(x, w, bias, GROUPS, 1e-6, True),
        "bwd": lambda: group_norm_bwd(x, x, w, bias, mean, rstd, GROUPS, True),
        "fwd general": lambda: group_norm_fwd(x, w, bias, GROUPS, 1e-6, True,
                                              launch=general_plan(16, 2, False)),
        "bwd general": lambda: group_norm_bwd(x, x, w, bias, mean, rstd, GROUPS, True,
                                              launch=general_plan(16, 2, True)),
    }
    out = {}
    for name, fn in runs.items():
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) / calls * 1e6
    return out


def dy_layouts(torch, dev):
    """Runs one DenseNet-121 forward and backward at b = 32 on the card and
    returns (calls, calls whose dy was not contiguous, their strides)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet121
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import groupnorm
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

    seen = []
    original = groupnorm.GroupNormFunction.backward

    def backward(ctx, dy):
        seen.append((dy.is_contiguous(), tuple(dy.shape), dy.stride()))
        return original(ctx, dy)

    model = DenseNet121()
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    model = model.to(dev, memory_format=torch.channels_last)
    x = torch.randn(32, 32, 32, 3, device=dev)
    y = torch.randint(0, 10, (32,), device=dev)
    groupnorm.GroupNormFunction.backward = staticmethod(backward)
    try:
        softmax_xent(model(x), y).mean().backward()
        torch.cuda.synchronize()
    finally:
        groupnorm.GroupNormFunction.backward = staticmethod(original)
    strided = [(shape, stride) for ok, shape, stride in seen if not ok]
    return len(seen), len(strided), strided


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", default="32,128,160")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32")
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "gn_bench"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("gn_bench: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import gn_shapes
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import (
        bound,
        card,
        device_ms,
        gn_work,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import groupnorm
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        general_plan,
        group_norm_bwd,
        group_norm_fwd,
    )

    smi = card()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    dtype = {"f32": torch.float32, "bf16": torch.bfloat16}[args.dtype]
    elem = torch.empty((), dtype=dtype).element_size()
    rows = []
    for b in (int(v) for v in args.batches.split(",") if v):
        shapes = gn_shapes(b, (6, 12, 24, 16), 32)
        gen = torch.Generator(device=dev).manual_seed(2)
        calls = []
        for _, s, c in shapes:
            x = torch.randn((b, s, c), device=dev, generator=gen).to(dtype)
            dy = torch.randn((b, s, c), device=dev, generator=gen).to(dtype)
            w, bias = torch.ones(c, device=dev), torch.zeros(c, device=dev)
            _, mean, rstd = group_norm_fwd(x, w, bias, GROUPS, 1e-6, True)
            calls.append((s, c, x, dy, w, bias, mean, rstd))
        stages = sorted({s for _, s, _ in shapes}, reverse=True)

        def launches(kw, backward):
            if kw is None:
                return [general_plan(s, c // GROUPS, backward) for s, c, *_ in calls]
            with constants(groupnorm, kw):
                return [groupnorm.plan(b, s, c, GROUPS, dtype, backward) for s, c, *_ in calls]

        plans = {name: (launches(kw, False), launches(kw, True)) for name, kw in CANDIDATES}

        def runner(name, stage, backward):
            todo = [(call, p) for call, p in zip(calls, plans[name][backward]) if call[0] == stage]
            if backward:
                return lambda: [group_norm_bwd(x, dy, w, bi, m, r, GROUPS, True, launch=p)
                                for (_, _, x, dy, w, bi, m, r), p in todo]
            return lambda: [group_norm_fwd(x, w, bi, GROUPS, 1e-6, True, launch=p)
                            for (_, _, x, _, w, bi, _, _), p in todo]

        times = {name: {k: {s: [] for s in stages} for k in ("fwd", "bwd")} for name, _ in CANDIDATES}
        for _ in range(args.rounds):
            for name, _ in CANDIDATES:
                for k, backward in (("fwd", False), ("bwd", True)):
                    for s in stages:
                        times[name][k][s].append(device_ms(runner(name, s, backward), reps=5, windows=1))
        work = gn_work(shapes, GROUPS, elem)
        bounds = {k: bound(*work[f"groupnorm_{k}"])[0] for k in ("fwd", "bwd")}
        stage_bounds = {k: {s: bound(*gn_work([sh for sh in shapes if sh[1] == s], GROUPS, elem)[
            f"groupnorm_{k}"])[0] for s in stages} for k in ("fwd", "bwd")}
        split = {route: {k: {} for k in ("fwd", "bwd")} for route in ("plan", "general")}
        for route, per_route in split.items():
            for k, backward in (("fwd", False), ("bwd", True)):
                for s in stages:
                    for name, ms in kernel_ms(torch, runner(route, s, backward)).items():
                        short = re.search(r"gn_\w+(<[^>]*>)?", name)
                        name = short.group(0) if short else name
                        per_route[k][name] = per_route[k].get(name, 0.0) + ms
        row = {"b": b, "bound_ms": bounds, "stage_bound_ms": stage_bounds, "times": times,
               "kernels_ms": split,
               "plans": {name: [list(p) for p in pl[0]] for name, pl in plans.items() if name == "plan"}}
        rows.append(row)
        print(f"b = {b}: 120 calls, bound fwd {bounds['fwd']:.3f} ms, bwd {bounds['bwd']:.3f} ms",
              flush=True)
        for k in ("fwd", "bwd"):
            total = {name: sum(statistics.median(times[name][k][s]) for s in stages)
                     for name, _ in CANDIDATES}
            best = min(total, key=total.get)
            print(f"  {k}: fastest {best}; stage bounds "
                  + " ".join(f"S={s} {stage_bounds[k][s]:.3f}" for s in stages), flush=True)
            for name, _ in CANDIDATES:
                per = " ".join(f"S={s} {statistics.median(times[name][k][s]):.4f}" for s in stages)
                spread = max(sum(times[name][k][s][i] for s in stages) for i in range(args.rounds)) - \
                    min(sum(times[name][k][s][i] for s in stages) for i in range(args.rounds))
                print(f"    {name:15s} {total[name]:.4f} ms ({100 * bounds[k] / total[name]:.0f}% of "
                      f"bound; rounds spread {spread:.4f}): {per}", flush=True)
            for route, per_route in split.items():
                print(f"    {route}'s kernels: "
                      + ", ".join(f"{n} {ms:.4f} ms" for n, ms in per_route[k].items()), flush=True)
        del calls
        torch.cuda.empty_cache()

    host = host_us(torch, dev)
    print("host time a call, at [2, 16, 64] (the card waits on the host): " + ", ".join(
        f"{k} {v:.1f} us" for k, v in host.items()), flush=True)
    n, n_strided, strided = dy_layouts(torch, dev)
    print(f"DenseNet-121 b=32 forward + backward: {n} GroupNorm backward calls, "
          f"{n_strided} with a non-contiguous dy {strided[:4]}", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "gn_bench.json"), "w") as f:
        json.dump({"card": smi, "dtype": args.dtype, "rounds": args.rounds, "rows": rows,
                   "host_us": host,
                   "dy": {"calls": n, "not_contiguous": n_strided, "strided": strided}},
                  f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
