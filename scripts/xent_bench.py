#!/usr/bin/env python3
"""K2 (softmax cross-entropy) launch plans on an NVIDIA card.

    python3 scripts/xent_bench.py [--group lm|small] [--rounds N] [--out DIR]

Times the forward and backward kernels of ``csrc/xent.cu`` f32 under each
launch plan (0 = the warp-per-row kernel; 128, 256 or 512 threads for the
block-per-row kernel), set through the constants of ``ops/kernels/xent.py``
that ``plan`` reads, beside ``F.cross_entropy(reduction="none")`` and the
bytes bound: ``--group lm`` (default) at the language model's shapes
([105 | 700 | 910 | 1400, 18328] and the validation chunk's [35840, 18328],
forward only), ``--group small`` at small vocabularies (V = 10 ... 4099)
for the threshold between the two kernels. The plans alternate over
``--rounds`` rounds (default 3), so each plan's spread over the rounds
shows beside the differences between plans. Device time, yardsticks and
bounds are those of ``chip_smoke.py`` (``obs/kernel_timing.py``). Each row
marks the plan ``plan`` picks. The table goes to
``<out>/xent_bench_<group>.json`` (default ``chiprun_out/xent_bench``).
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

BLOCKS = (128, 256, 512)
LM_V, LM_ROWS, VAL_ROWS = 18328, (105, 700, 910, 1400), 1024 * 35
SMALL = [(128, 10), (4096, 10), (512, 100), (1400, 256), (1400, 512), (1400, 1000),
         (1400, 2048), (1400, 4099)]


@contextlib.contextmanager
def launch_plan(xent, v: int, threads: int):
    """``xent.plan`` picks ``threads`` (0: the warp kernel) for ``v``
    classes while inside."""
    saved = xent.SMALL_V, xent.FWD_THREADS, xent.BWD_THREADS
    xent.SMALL_V = v + 1 if threads == 0 else 0
    if threads:
        xent.FWD_THREADS = xent.BWD_THREADS = threads
    try:
        yield
    finally:
        xent.SMALL_V, xent.FWD_THREADS, xent.BWD_THREADS = saved


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--group", choices=("lm", "small"), default="lm")
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "xent_bench"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("xent_bench: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import (
        card,
        device_ms,
        xent_inputs,
        xent_yardsticks,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import xent

    smi = card()
    print(smi, flush=True)
    dev = torch.device("cuda", 0)
    rows = []

    def measure(r, v, plans, backward=True):
        logits, labels, g, lse = xent_inputs(r, v, dev)
        kernels = ("xent_fwd", "xent_bwd") if backward else ("xent_fwd",)
        calls = {"xent_fwd": lambda: xent.xent_fwd(logits, labels),
                 "xent_bwd": lambda: xent.xent_bwd(logits, labels, g, lse)}
        times = {t: {k: [] for k in kernels} for t in plans}
        for _ in range(args.rounds):
            for t in plans:
                with launch_plan(xent, v, t):
                    for k in kernels:
                        times[t][k].append(device_ms(calls[k], reps=20))
        row = {"shape": [r, v], "chosen": list(xent.plan(v)),
               "yardsticks": xent_yardsticks(logits, labels, g, lse, 20, backward),
               "plans": times}
        rows.append(row)
        print(f"[{r}, {v}] plan {tuple(row['chosen'])}", flush=True)
        for i, k in enumerate(kernels):
            y = row["yardsticks"][k]
            best = min(plans, key=lambda t: statistics.median(times[t][k]))
            print(f"  {k}: library {y['library_ms']:.4f} ms, bound {y['bound_ms']:.4f} ms, "
                  f"fastest median {best}", flush=True)
            for t in plans:
                ts = times[t][k]
                mark = " <- plan" if t == row["chosen"][i] else ""
                print(f"    {t:4d}: median {statistics.median(ts):.4f} ms (rounds "
                      f"{' '.join(f'{x:.4f}' for x in ts)}){mark}", flush=True)
        del logits, labels, g, lse
        torch.cuda.empty_cache()

    if args.group == "lm":
        for r in LM_ROWS:
            measure(r, LM_V, BLOCKS)
        measure(VAL_ROWS, LM_V, BLOCKS, backward=False)
    else:
        for r, v in SMALL:
            measure(r, v, (0,) + BLOCKS)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"xent_bench_{args.group}.json"), "w") as f:
        json.dump({"card": smi, "rounds": args.rounds, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
