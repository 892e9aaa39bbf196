#!/usr/bin/env python3
"""Where one DBS epoch's time goes on an NVIDIA card.

    python3 scripts/torch_profile.py [--recipe densenet|lm] [--epochs-warm 1] [--out DIR]

Recipes:

- ``densenet`` (default): the port's ``Trainer`` on the canonical recipe
  (DenseNet-121, synthetic CIFAR-10, 4 workers on one card, B=512, 3:1
  virtual straggler, 4096 training examples: 8 steps per epoch);
- ``lm``: the port's ``LMTrainer`` on the language-model recipe of
  ``chip_smoke.py`` (Transformer LM, EMSIZE 200, 2 heads, 2 layers, flash
  attention, the committed wikitext-2 files, 4 workers, 80 columns, bptt
  35, clipping at 0.25, 3:1 virtual straggler: 78 steps per epoch).

It builds the trainer and runs warm-up epochs. Then it runs the training
steps of one more epoch's plan three times, probes off:
once to warm up that plan's batch shapes, once plain for its host wall, and
once under ``torch.profiler`` for the device's kernel time. It prints:

- the first pass's wall (new batch shapes pay cuDNN's and the driver's
  first-use costs) beside the steady one;
- the training wall, the device's summed kernel time and the device's busy
  share (kernel time over the unprofiled wall; the profiler's own host cost
  would otherwise inflate the idle share);
- device time per kernel family (the port's kernels, cuDNN convolutions or
  cuBLAS products, concatenation, elementwise, optimizer ...);
- the 15 kernels with the most device time.

The full table goes to ``<out>/profile.json`` (default
``chiprun_out/profile`` or ``chiprun_out/profile_lm``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RECIPES = {
    "densenet": "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 "
                "--straggler 3,1,1,1 -e 100 --n_train 4096",
    "lm": "-m transformer -ds wikitext2 -d false -ws 4 -b 80 -gpu 0,0,0,0 --bptt 35 "
          "--grad_clip 0.25 --straggler 3,1,1,1 --use_flash_attention true -e 100",
}

LM_FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("flash attention (port)", ("attn_fwd", "attn_bwd_")),
    ("cross-entropy (port)", ("xent_",)),
    ("matrix products (cuBLAS)", ("gemm", "sm90", "xmma", "cutlass", "splitk")),
    ("layer norm", ("layer_norm", "layernorm")),
    ("embedding", ("embedding",)),
    ("optimizer / clip (foreach)", ("foreach", "multi_tensor", "norm")),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / index", ("copy", "index", "gather", "scatter", "fill")),
)

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("groupnorm (port)", ("gn_fwd_", "gn_bwd_", "gn_param_")),
    ("cross-entropy (port)", ("xent_",)),
    ("layout transposes (cuDNN)", ("nhwcToNchw", "nchwToNhwc")),
    ("convolution (cuDNN)", ("conv", "xmma", "fft", "region_transform", "implicit", "winograd", "cudnn", "sm90", "gemm", "dgrad", "wgrad")),
    ("concatenation", ("CatArray",)),
    ("pooling", ("pool",)),
    ("reduction", ("reduce",)),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
    ("copy / index", ("copy", "index", "gather", "scatter", "fill")),
)


def family(name: str, families=FAMILIES) -> str:
    low = name.lower()
    for fam, keys in families:
        if any(k.lower() in low for k in keys):
            return fam
    return "other"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--recipe", choices=sorted(RECIPES), default="densenet")
    ap.add_argument("--epochs-warm", type=int, default=1)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out is None:
        args.out = os.path.join(ROOT, "chiprun_out", "profile" + ("_lm" if args.recipe == "lm" else ""))

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("torch_profile: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.makedirs(args.out, exist_ok=True)
    cfg = config_from_args(
        RECIPES[args.recipe].split()
        + ["--log_dir", os.path.join(args.out, "logs"), "--stat_dir", os.path.join(args.out, "statis")]
    )
    families = LM_FAMILIES if args.recipe == "lm" else FAMILIES
    tr = (LMTrainer if args.recipe == "lm" else Trainer)(cfg, log_to_file=False)
    for e in range(args.epochs_warm):
        tr.run_epoch(e)
    epoch = args.epochs_warm
    plan, faults = tr._plan_epoch(epoch)

    def train_steps():
        tr._probe_this_epoch = False  # the training steps alone
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr._train_epoch_elastic(plan, faults, epoch)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    wall_first = train_steps()  # first pass over this plan's batch shapes
    wall = train_steps()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_profiled = train_steps()

    kernels = {}
    for ev in prof.key_averages():
        dev_us = getattr(ev, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(ev, "self_cuda_time_total", 0.0)
        if dev_us and ev.device_type == torch.autograd.DeviceType.CUDA:
            kernels[ev.key] = {"us": dev_us, "count": ev.count}
    dev_total_s = sum(k["us"] for k in kernels.values()) / 1e6
    fams = {}
    for name, k in kernels.items():
        f = fams.setdefault(family(name, families), {"us": 0.0, "count": 0})
        f["us"] += k["us"]
        f["count"] += k["count"]
    print(f"epoch {epoch} training steps ({plan.num_steps} steps x {cfg.world_size} workers, "
          f"batches {plan.batch_sizes.tolist()}): wall {wall:.3f}s (first pass over these "
          f"shapes {wall_first:.3f}s, profiled {wall_profiled:.3f}s), device kernel time "
          f"{dev_total_s:.3f}s, busy share "
          f"{dev_total_s / wall:.3f}, {tr.n_train / wall:.1f} "
          f"{'tokens' if args.recipe == 'lm' else 'examples'}/s")
    for fam, f in sorted(fams.items(), key=lambda kv: -kv[1]["us"]):
        print(f"  {fam:24s} {f['us'] / 1e3:10.1f} ms  {100 * f['us'] / 1e6 / dev_total_s:5.1f}%  "
              f"{f['count']} launches")
    print("top kernels:")
    top = sorted(kernels.items(), key=lambda kv: -kv[1]["us"])[:15]
    for name, k in top:
        print(f"  {k['us'] / 1e3:9.1f} ms  x{k['count']:6d}  {name[:110]}")
    with open(os.path.join(args.out, "profile.json"), "w") as f:
        json.dump({"card": smi, "recipe": args.recipe, "epoch": epoch, "batch_sizes": plan.batch_sizes.tolist(),
                   "wall_s": wall, "wall_first_pass_s": wall_first,
                   "wall_profiled_s": wall_profiled, "device_kernel_s": dev_total_s,
                   "per_s": tr.n_train / wall,
                   "families": fams, "kernels": kernels}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
