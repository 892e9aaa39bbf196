#!/usr/bin/env python3
"""Train losses of the CNN zoo through the port's trainer, on one device, by
path, from one seed.

    python3 scripts/zoo_loss.py [--device cuda|cpu] [--models resnet,regnet]
                                [--arms packed,elastic] [-b 128] [--n_train 512]
                                [--n_test 256] [-e 3] [--seed 1] [--out DIR]

For each model (the reference's ``-m`` names) and each arm (``--packed
on|off``) it builds the port's ``Trainer`` on synthetic CIFAR-10 with 4
workers and the recipe's optimizer (lr 0.01, momentum 0.9), no straggler,
and a timing model in place of the wall-clock probes (each worker's time
its examples), so the plan, the data order and the initial weights are the
same on every device and arm. On the card the kernels run (TF32 off); on
the CPU their plain versions. The augmentation's random crops and flips
come from a generator on the device, so they differ between the CPU and the
card. It prints each epoch's train loss, validation loss and accuracy, and
writes them to ``<out>/<device>.json`` (default ``chiprun_out/zoo_loss``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def uniform_time(plan):
    """Each worker's modeled time is its examples: the balanced plan stays
    the first one."""
    return np.array([w.batch_size * w.steps for w in plan.workers], dtype=np.float64)


def main() -> int:
    import torch

    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.data.datasets import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--models", default="resnet,regnet")
    p.add_argument("--arms", default="packed,elastic")
    p.add_argument("-b", "--batch_size", type=int, default=128)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_test", type=int, default=256)
    p.add_argument("-e", "--epochs", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "zoo_loss"))
    args = p.parse_args()
    if args.device.startswith("cuda"):
        if not torch.cuda.is_available():
            print("zoo_loss: no CUDA device (pass --device cpu for the plain versions)",
                  file=sys.stderr)
            return 1
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    bundle = synthetic_dataset("cifar10", n_train=args.n_train, n_test=args.n_test)
    out = {"args": vars(args), "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models.split(","):
            for arm in args.arms.split(","):
                tag = f"{name} {arm}"
                cfg = config_from_args(
                    f"-m {name} -ds cifar10 -d false -ws 4 -b {args.batch_size} "
                    f"-e {args.epochs} --n_train {args.n_train} --seed {args.seed} "
                    f"--packed {'on' if arm == 'packed' else 'off'} "
                    f"--log_dir {tmp}/{name}_{arm}/logs --stat_dir {tmp}/{name}_{arm}/statis".split())
                t0 = time.perf_counter()
                rec = Trainer(cfg, bundle=bundle, timing_model=uniform_time,
                              device=args.device, log_to_file=False).run()
                row = {k: rec.data[k] for k in ("train_loss", "val_loss", "accuracy", "partition")}
                row["paths"] = rec.meta["paths"]
                row["seconds"] = time.perf_counter() - t0
                out["runs"][tag] = row
                print(f"{tag} on {args.device}: train_loss "
                      f"{[round(v, 4) for v in row['train_loss']]}  val_loss "
                      f"{[round(v, 4) for v in row['val_loss']]}  accuracy {row['accuracy']}  "
                      f"paths {row['paths']}  ({row['seconds']:.1f}s)", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, f"{args.device.split(':')[0]}.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
