#!/usr/bin/env python3
"""Where a combine's collective time goes with ranks on one NVIDIA card.

    python3 scripts/collective_bench.py [--ranks 2] [--reps 20] [--out DIR]

Starts ``--ranks`` processes on ``cuda:0`` in one gloo group (``tcp://`` on
localhost, the backend ``parallel/mesh.py`` picks when ranks share a card)
and times, on DenseNet-121's flat gradient (its 6,956,298 f32 elements, the
362 leaves in the flat order of ``train/combine.py``), each piece of the
port's combines, the median over ``--reps`` after a barrier and two warm
runs each:

- ``d2h``: the device-to-pinned-host copy and the stream synchronize;
- ``gloo_sum``: gloo's all-reduce of the pinned host copy;
- ``h2d``: the copy back and a synchronize;
- ``sum``: ``DataMesh.all_reduce_`` of the device buffer (all three staged);
- ``int8_wire``: ``compressed_reduce_leaves`` (the ``--compress_grads int8``
  combine: each leaf's scale, the murmur dither at each element's flax
  ravel position, the float16 sum);
- ``zero1``: ZeRO-1's reduce-scatter and all-gather of the buffer;
- ``zero1_int8``: the same with the int8 reduce-scatter;

and with 4 or more ranks (an even count) the ``--grad_comm hier`` combine
on the tree (2, ranks / 2), a synthetic two-host split
(``train/combine.py`` ``RankCombine`` on the tree): the buffer permuted
into the JAX ravel order, ``tree_allreduce`` with its residuals, and the
permutation back,

- ``hier_fp32``, ``hier_int8``, ``hier_int4``: on the wires fp32, int8 and
  int4 over the outer hop (fp32 inside);
- ``hier_zero1``: ZeRO-1 on the tree, int8 over the outer hop: the
  scatter up the tree, then the gather of the chunks back down.

Each rank prints its medians beside the card's name and power limit (its
output in ``<out>/rank<i>.out``, printed at the end); rank 0's table also
goes to ``<out>/collective_bench.json`` (default
``chiprun_out/collective_bench``). The ranks are started and joined by
``scripts/rank_launch.py`` ``launch_ranks``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def rank_main(args) -> None:
    import torch
    import torch.distributed as dist

    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import card
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import (
        data_mesh,
        initialize_multihost,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import fold_in_many, prng_key
    from dynamic_load_balance_distributeddnn_tpu_torch.train.combine import FlatGrads

    initialize_multihost(f"127.0.0.1:{args.port}", args.ranks, args.rank, timeout_s=300)
    dev = torch.device("cuda", 0)
    model = build_model("densenet", num_classes=10, in_channels=3).to(
        dev, memory_format=torch.channels_last)
    fg = FlatGrads(model, args.ranks, flax_layout=True)
    flat = fg.flat
    flat.copy_(torch.randn(flat.numel(), device=dev, generator=torch.Generator(device=dev).manual_seed(
        args.rank)) * 1e-3)
    mesh = data_mesh(dev)
    assert mesh.backend == "gloo" and mesh.staged, mesh.describe()
    keys = fold_in_many(prng_key(args.rank), [i + 0x7FFF for i in range(len(fg.sizes))])
    host = torch.empty(flat.numel(), dtype=flat.dtype, pin_memory=True)
    chunk = torch.empty(flat.numel() // args.ranks, device=dev)
    gathered = torch.empty_like(flat)

    def d2h():
        host.copy_(flat, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()

    def h2d():
        flat.copy_(host, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()

    def sync_after(fn):
        def run():
            fn()
            torch.cuda.synchronize(dev)
        return run

    work = {}
    if args.ranks >= 4 and args.ranks % 2 == 0:
        work.update(hier_work(args, model, mesh, dev))
    work_flat = {
        "d2h": d2h,
        "gloo_sum": lambda: dist.all_reduce(host),
        "h2d": h2d,
        "sum": sync_after(lambda: mesh.all_reduce_(flat)),
        "int8_wire": sync_after(lambda: wire.compressed_reduce_leaves(flat, fg.sizes, keys, mesh,
                                                                      args.ranks, index=fg.index)),
        "zero1": sync_after(lambda: mesh.all_gather(gathered, mesh.reduce_scatter(chunk, flat))),
        "zero1_int8": sync_after(lambda: mesh.all_gather(gathered, wire.compressed_reduce_scatter(
            flat, keys[0], mesh, args.ranks, "int8", fg.index))),
    }
    work = dict(work_flat, **work)
    out = {"card": card(), "rank": args.rank, "ranks": args.ranks, "elems": int(flat.numel()),
           "leaves": len(fg.sizes), "ms": {}}
    for name, fn in work.items():
        times = []
        for i in range(args.reps + 2):
            torch.cuda.synchronize(dev)
            dist.barrier()
            t0 = time.perf_counter()
            fn()
            if i >= 2:
                times.append(1e3 * (time.perf_counter() - t0))
        out["ms"][name] = {"median": statistics.median(times), "min": min(times),
                           "max": max(times)}
    print(json.dumps(out), flush=True)
    if args.rank == 0:
        os.makedirs(args.out, exist_ok=True)
        with open(os.path.join(args.out, "collective_bench.json"), "w") as f:
            json.dump(out, f, indent=1)
    dist.destroy_process_group()


def hier_work(args, model, mesh, dev):
    """The hier arms (module docstring): each a ``RankCombine`` of its own
    on the tree (2, ranks / 2), its buffer filled from a seed, its
    collective timed without the optimizer's update."""
    import torch

    from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import prng_key
    from dynamic_load_balance_distributeddnn_tpu_torch.train.combine import RankCombine

    tree = (("host", "device"), (2, args.ranks // 2))
    opt = torch.optim.SGD(model.parameters(), lr=0.0, momentum=0.9)
    key = prng_key(args.rank)
    work = {}
    for name, wires, zero1 in (("hier_fp32", ("fp32", "fp32"), False),
                               ("hier_int8", ("int8", "fp32"), False),
                               ("hier_int4", ("int4", "fp32"), False),
                               ("hier_zero1", ("int8", "fp32"), True)):
        rc = RankCombine(mesh, model, opt, 0.9, shard_update=zero1, tree=tree, wires=wires)
        rc.grads.flat.copy_(torch.randn(rc.grads.flat.numel(), device=dev, generator=torch.Generator(
            device=dev).manual_seed(args.rank)) * 1e-3)

        def run(rc=rc):
            flat = rc.grads.flat
            if rc.shard_update:
                g, rc.residuals = rc._tree_scatter(flat, key, rc.residuals)
                rc._from_jax(rc._tree_gather(g), rc.trace)
            else:
                out, rc.residuals = wire.tree_allreduce(rc._to_jax(flat), key, rc.axes, rc.wires,
                                                        rc.residuals)
                rc._from_jax(out, torch.empty_like(flat))
            torch.cuda.synchronize(dev)

        work[name] = run
    return work


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "collective_bench"))
    ap.add_argument("--rank", type=int, default=-1, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.rank >= 0:
        rank_main(args)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("collective_bench: no CUDA device", file=sys.stderr)
        return 1
    from scripts.rank_launch import RanksFailed, free_port, launch_ranks

    port = free_port()
    cmds = [[sys.executable, os.path.abspath(__file__), "--ranks", str(args.ranks), "--reps",
             str(args.reps), "--out", args.out, "--rank", str(r), "--port", str(port)]
            for r in range(args.ranks)]
    try:
        launch_ranks(cmds, args.out, timeout=600)
    except RanksFailed as e:
        print(e)
        return 1
    for r in range(args.ranks):
        with open(os.path.join(args.out, f"rank{r}.out")) as f:
            print(f.read(), end="")
    return 0


if __name__ == "__main__":
    sys.exit(main())
