#!/usr/bin/env python3
"""K3 (flash attention) short-route launch plans on an NVIDIA card.

    python3 scripts/flash_bench.py [--rounds N] [--out DIR]

Times the short route's kernels of ``csrc/flash_attention.cu`` (causal f32,
on the ``[B, H, T, D]`` views the language model passes) under each launch
plan, at the language model's shapes: (3 | 20 | 26 | 40, 2, 35, 100),
forward and fused backward, and (128 | 256 | 1024, 2, 35, 100), the last
the validation chunk, forward only. Forward plans: query rows a block (8, 16, or
the whole head) times threads (256, 288, 384); backward plans: threads
(256, 288, 384) times blocks a head (1, 2). Beside them the tiled route (the kernels that
ran at these shapes before the short route; forward, and dK/dV plus dQ from
a precomputed delta, on contiguous ``[BH, T, D]`` copies), the plain
versions, ``F.scaled_dot_product_attention`` and the bound, as in
``chip_smoke.py`` (``obs/kernel_timing.py``). The plans and the tiled route
alternate over ``--rounds`` rounds (default 3), so each one's spread over
the rounds shows beside the differences between them. Each row marks the
plan ``plan`` picks. These are the numbers behind ``plan`` in
``ops/kernels/flash_attention.py``. The table goes to
``<out>/flash_bench.json`` (default ``chiprun_out/flash_bench``). Needs a
CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

PATH_SHAPES = [(3, 2, 35, 100), (20, 2, 35, 100), (26, 2, 35, 100), (40, 2, 35, 100)]
# forward only: B*H from 256 to 2,048 (the validation chunk), where the
# forward's plan changes from a few blocks a head to one
WIDE_SHAPES = [(128, 2, 35, 100), (256, 2, 35, 100), (1024, 2, 35, 100)]
WHOLE = 0  # rows: the whole head
FWD_PLANS = [(r, t) for r in (8, 16, WHOLE) for t in (256, 288, 384)]  # (rows, threads)
BWD_PLANS = [(t, p) for t in (256, 288, 384) for p in (1, 2)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "flash_bench"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_bench: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import (
        attn_inputs,
        attn_work,
        attn_yardsticks,
        bound,
        card,
        device_ms,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import flash_attention as fa

    smi = card()
    print(smi, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    rows_out = []

    def measure(shape, backward):
        b, h, t, d = shape
        q, k, v, do = attn_inputs(shape, dev)
        o, lse = fa.attn_fwd_short(q, k, v, True)
        flat = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v, do)]
        o_t, lse_t = fa.attn_fwd(*flat[:3], True)
        delta = (flat[3] * o_t).sum(-1)
        whole = (t + 3) // 4 * 4
        calls = {}
        for r, th in FWD_PLANS:
            rr = min(r, whole) if r else whole
            calls[f"fwd rows={rr} threads={th}"] = (
                "attn_fwd", lambda rr=rr, th=th: fa.attn_fwd_short(q, k, v, True, launch=(rr, th)))
        calls["fwd tiled"] = ("attn_fwd_tiled", lambda: fa.attn_fwd(*flat[:3], True))
        if backward:
            for th, p in BWD_PLANS:
                calls[f"bwd threads={th} parts={p}"] = (
                    "attn_bwd", lambda th=th, p=p: fa.attn_bwd_short(q, k, v, do, o, lse, True, launch=(th, p)))
            calls["bwd tiled (dkv + dq)"] = ("attn_bwd_tiled", lambda: (
                fa.attn_bwd_dkv(*flat, lse_t, delta, True), fa.attn_bwd_dq(*flat, lse_t, delta, True)))
        times = {name: [] for name in calls}
        reps = 20 if backward else 5
        for _ in range(args.rounds):
            for name, (_, fn) in calls.items():
                times[name].append(device_ms(fn, reps=reps))
        (f_rows, f_threads), (b_threads, b_parts) = fa.plan(b * h, t, d)
        chosen = {"attn_fwd": f"fwd rows={f_rows} threads={f_threads}",
                  "attn_bwd": f"bwd threads={b_threads} parts={b_parts}"}
        ys = attn_yardsticks(q, k, v, do, True, reps, backward)
        work = attn_work(shape, True)
        tiled_bwd = [a + b for a, b in zip(work["attn_bwd_dkv"], work["attn_bwd_dq"])]
        ys["attn_bwd_tiled"] = dict(zip(("bound_ms", "bound_by"), bound(*tiled_bwd)))
        row = {"shape": list(shape), "chosen": chosen, "yardsticks": ys,
               "plans": {name: {"kernel": kern, "ms": times[name]} for name, (kern, _) in calls.items()}}
        rows_out.append(row)
        print(f"{shape} plan fwd {chosen['attn_fwd']!r}, bwd {chosen['attn_bwd']!r}", flush=True)
        for kern in ("attn_fwd", "attn_bwd") if backward else ("attn_fwd",):
            y = ys[kern]
            names = [n for n, (kk, _) in calls.items() if kk == kern]
            best = min(names, key=lambda n: statistics.median(times[n]))
            print(f"  {kern}: plain {y['plain_ms']:.4f} ms, library {y['library_ms']:.4f} ms, "
                  f"bound {y['bound_ms']:.5f} ms ({y['bound_by']}), fastest median {best!r}", flush=True)
        for name in calls:
            mark = " <- plan" if name in chosen.values() else ""
            ts = times[name]
            print(f"    {name:28s} median {statistics.median(ts):.4f} ms (rounds "
                  f"{' '.join(f'{x:.4f}' for x in ts)}){mark}", flush=True)
        del q, k, v, do, o, lse, flat, o_t, lse_t, delta
        torch.cuda.empty_cache()

    for shape in PATH_SHAPES:
        measure(shape, True)
    for shape in WIDE_SHAPES:
        measure(shape, False)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "flash_bench.json"), "w") as f:
        json.dump({"card": smi, "rounds": args.rounds, "rows": rows_out}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
