#!/usr/bin/env python3
"""Profile each window-controller evaluation of ``chip_smoke.py``'s [4e]
recipe on the card.

    python3 scripts/window_profile.py [--top 18]

Builds the kernels, runs ``chip_smoke.WINDOW_ARGV`` (DenseNet-121, 4
workers, B=512, a compute-mode 8:1 ``sin`` straggler, ``--rebalance
window``) through the port's ``cli`` with ``Trainer._maybe_window_rebalance``
wrapped in ``cProfile``, prints each call's wall in ms (the calls that
return at once, with no window left to act on, included) and the switch
events, and writes each call's top functions by cumulative time to
``window_profile/evals.txt`` beside ``chip_smoke.py``'s tables (the parent
of ``chip_smoke.OUT``). Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import os
import pstats
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--top", type=int, default=18, help="functions listed a call")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("window_profile: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.train import engine

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.card(), flush=True)
    runtime.build()
    orig = engine.Trainer._maybe_window_rebalance
    calls = []

    def profiled(self, *a, **k):
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.enable()
        try:
            return orig(self, *a, **k)
        finally:
            prof.disable()
            dt = time.perf_counter() - t0
            text = io.StringIO()
            pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(args.top)
            calls.append((dt, text.getvalue()))

    engine.Trainer._maybe_window_rebalance = profiled
    os.makedirs(cs.OUT, exist_ok=True)
    series = cs.run_path(torch, cs.WINDOW_ARGV, "window_profile")[1]
    out = os.path.join(os.path.dirname(cs.OUT), "window_profile")
    os.makedirs(out, exist_ok=True)
    with open(os.path.join(out, "evals.txt"), "w") as f:
        for i, (dt, text) in enumerate(calls):
            f.write(f"=== call {i}: {dt * 1e3:.3f} ms\n{text}\n")
    print("calls (ms):", [round(dt * 1e3, 2) for dt, _ in calls])
    print("switches an epoch:", series["plan_switches"])
    for ev in series["_meta"].get("rebalance_events", []):
        print(f"switch: epoch {ev['epoch']} window {ev['window']} step {ev['step']} -> "
              f"{ev['batches']}, cost {ev['switch_cost_s'] * 1e3:.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
