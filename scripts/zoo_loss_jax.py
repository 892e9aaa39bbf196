#!/usr/bin/env python3
"""The JAX package's side of ``scripts/zoo_loss.py``: the same models, arms,
settings and synthetic data through the JAX package's ``Trainer``, on the
CPU.

    python3 scripts/zoo_loss_jax.py [--models resnet,regnet] [--arms packed,elastic]
                                    [-b 128] [--n_train 512] [--n_test 256] [-e 3]
                                    [--seed 1] [--out DIR]

Each arm is ``packed="on"`` or ``"off"`` with every worker on one device
(``device=0``), 4 workers, lr 0.01 and momentum 0.9, no straggler, and the
timing model of ``zoo_loss.py`` (each worker's time its examples). It
prints each epoch's train loss, validation loss and accuracy, and writes
them to ``<out>/jax_cpu.json`` (default ``chiprun_out/zoo_loss``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402


def uniform_time(plan):
    return np.array([w.batch_size * w.steps for w in plan.workers], dtype=np.float64)


def main() -> int:
    import jax

    jax.config.update("jax_platforms", "cpu")
    from dynamic_load_balance_distributeddnn_tpu.config import Config
    from dynamic_load_balance_distributeddnn_tpu.data.datasets import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu.train.engine import Trainer

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", default="resnet,regnet")
    p.add_argument("--arms", default="packed,elastic")
    p.add_argument("-b", "--batch_size", type=int, default=128)
    p.add_argument("--n_train", type=int, default=512)
    p.add_argument("--n_test", type=int, default=256)
    p.add_argument("-e", "--epochs", type=int, default=3)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "zoo_loss"))
    args = p.parse_args()
    bundle = synthetic_dataset("cifar10", n_train=args.n_train, n_test=args.n_test)
    out = {"args": vars(args), "runs": {}}
    with tempfile.TemporaryDirectory() as tmp:
        for name in args.models.split(","):
            for arm in args.arms.split(","):
                tag = f"{name} {arm}"
                cfg = Config(
                    model=name, dataset="cifar10", debug=False, world_size=4,
                    batch_size=args.batch_size, epoch_size=args.epochs, n_train=args.n_train,
                    seed=args.seed, device=0, packed="on" if arm == "packed" else "off",
                    log_dir=f"{tmp}/{name}_{arm}/logs", stat_dir=f"{tmp}/{name}_{arm}/statis",
                )
                t0 = time.perf_counter()
                rec = Trainer(cfg, bundle=bundle, timing_model=uniform_time, log_to_file=False).run()
                row = {k: rec.data[k] for k in ("train_loss", "val_loss", "accuracy", "partition")}
                row["seconds"] = time.perf_counter() - t0
                out["runs"][tag] = row
                print(f"{tag} on the JAX package (CPU): train_loss "
                      f"{[round(v, 4) for v in row['train_loss']]}  val_loss "
                      f"{[round(v, 4) for v in row['val_loss']]}  accuracy {row['accuracy']}  "
                      f"({row['seconds']:.1f}s)", flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "jax_cpu.json"), "w") as f:
        json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
