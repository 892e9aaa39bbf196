#!/usr/bin/env python3
"""The zoo's first-conv loss gradient on the card against exact arithmetic.

    python3 scripts/zoo_numerics.py [--models resnet,resnet18,googlenet,regnetx200mf,regnet]
                                    [--seeds 0,1,2] [--batch 8] [--out DIR]

For each model (the reference's ``-m`` names) and weight seed, with the
inputs of ``chip_smoke.py`` phase 6 (seed s: inputs from seeds 1 + 10 s and
2 + 10 s), eval mode, it computes the first conv's gradient of the mean
cross-entropy in f64 on the CPU, the reference, and prints how far each
f32 run lies from it (the largest entry, and the entries beyond 2e-3):

- ``cpu``: the CPU, plain versions;
- ``card``: the card, the kernels (K1, K2) and cuDNN's convolutions;
- ``card_plain``: the card, the plain GroupNorm and cross-entropy on CUDA
  tensors (the kernels bypassed), cuDNN's convolutions.

TF32 is off. Writes ``<out>/zoo_numerics.json`` (default
``chiprun_out/zoo_numerics``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch

    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model, common
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import group_norm_ref
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        softmax_xent,
        softmax_xent_ref,
    )

    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--models", default="resnet,resnet18,googlenet,regnetx200mf,regnet")
    p.add_argument("--seeds", default="0,1,2")
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "zoo_numerics"))
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("zoo_numerics: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    kernel_gn = common._group_norm

    def grad(model, d, dtype, x, y, plain=False):
        common._group_norm = group_norm_ref if plain else kernel_gn
        try:
            model = model.to(d, dtype, memory_format=torch.channels_last).eval()
            logits = model(x.to(d, dtype))
            (softmax_xent_ref if plain else softmax_xent)(logits, y.to(d)).mean().backward()
            return model.Conv_0.weight.grad.cpu().double()
        finally:
            common._group_norm = kernel_gn

    arms = {"cpu": ("cpu", False), "card": (dev, False), "card_plain": (dev, True)}
    rows = []
    for name in args.models.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            ref = build_model(name)
            init_flax_defaults(ref, torch.Generator().manual_seed(seed))
            x = torch.randn(args.batch, 32, 32, 3, generator=torch.Generator().manual_seed(1 + 10 * seed))
            y = torch.randint(0, 10, (args.batch,), generator=torch.Generator().manual_seed(2 + 10 * seed))

            def fresh():
                m = build_model(name)
                m.load_state_dict(ref.state_dict())
                return m

            exact = grad(fresh(), "cpu", torch.float64, x, y)
            row = {"model": name, "seed": seed, "batch": args.batch,
                   "max_abs_grad": exact.abs().max().item()}
            for arm, (d, plain) in arms.items():
                diff = (grad(fresh(), d, torch.float32, x, y, plain) - exact).abs()
                row[arm] = {"max": diff.max().item(), "over_2e-3": int((diff > 2e-3).sum())}
            rows.append(row)
            print(f"{name} seed {seed} b={args.batch} (max |grad| {row['max_abs_grad']:.3e}): "
                  + "  ".join(f"{arm} {row[arm]['max']:.2e} ({row[arm]['over_2e-3']} > 2e-3)"
                              for arm in arms), flush=True)
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "zoo_numerics.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
