"""The sweep harness (the JAX package's ``sweep.py``, the reference's
``run.sh`` grid) on the port's ``cli``.

    python -m dynamic_load_balance_distributeddnn_tpu_torch.sweep [-ws 4] [-b 512] [-e 10]
        [-dev 0] [--models resnet,densenet,googlenet,regnet] [--datasets cifar10,cifar100]

Runs {dbs on, off} x datasets x models with the one-cycle policy on, in the
JAX package's order, stopping at the first leg that fails. A finished leg
is skipped through its completion sentinel (``cli``), so a second call
runs only what is left. ``-dev`` is the ``-gpu`` map of every leg:
``0``, the default, puts every worker on ``cuda:0`` (a process of this port
owns one device). ``main(argv, device="cpu")`` runs the legs on the CPU.
"""

from __future__ import annotations

import argparse
import itertools
import sys

from dynamic_load_balance_distributeddnn_tpu_torch import cli


def main(argv=None, device="cuda") -> int:
    p = argparse.ArgumentParser(description="DBS sweep (run.sh parity)")
    p.add_argument("-ws", "--world_size", type=int, default=4)
    p.add_argument("-b", "--batch_size", type=int, default=512)
    p.add_argument("-e", "--epoch_size", type=int, default=10)
    p.add_argument("-lr", "--learning_rate", type=float, default=0.01)
    p.add_argument("-dev", "--device", type=str, default="0")
    p.add_argument("-de", "--disable_enhancements", type=str, default="false")
    p.add_argument("-d", "--debug", type=str, default="false",
                   help="pass debug mode through to every leg (smoke runs)")
    p.add_argument("--models", type=str, default="resnet,densenet,googlenet,regnet")
    p.add_argument("--datasets", type=str, default="cifar10,cifar100")
    ns = p.parse_args(argv)

    grid = itertools.product(("true", "false"), ns.datasets.split(","), ns.models.split(","))
    for dbs, dataset, model in grid:
        args = [
            "-d", ns.debug,
            "-ws", str(ns.world_size),
            "-b", str(ns.batch_size),
            "-e", str(ns.epoch_size),
            "-lr", str(ns.learning_rate),
            "-m", model,
            "-ds", dataset,
            "-dbs", dbs,
            "-gpu", ns.device,
            "-ocp", "true",
            "-de", ns.disable_enhancements,
        ]
        print(f"==> sweep leg: model={model} dataset={dataset} dbs={dbs}")
        try:
            rc = cli.main(args, device=device)
        except Exception as e:  # fail fast, as run.sh does
            import traceback

            traceback.print_exc()
            print(f"sweep leg failed ({type(e).__name__}: {e}); aborting")
            return 1
        if rc != 0:
            print(f"sweep leg failed (rc={rc}); aborting")
            return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
