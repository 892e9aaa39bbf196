#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions.
2. Build every CUDA kernel from ``dynamic_load_balance_distributeddnn_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) into ``build/torch_kernels``.
3. Each kernel against its plain PyTorch version on the card, at DenseNet-121
   shapes, f32 and bf16; then its device time (the profiler's sum of kernel
   time, so host launch gaps are not counted) beside its bound, the plain
   version's and one PyTorch library call's; the CUDA-event wall, which
   includes the host's launch gaps, is printed beside it.
4. The main path: the port's ``cli.main`` trains DenseNet-121 on synthetic
   CIFAR-10 with 4 workers, B=512 and a 3:1 virtual straggler for 3 epochs;
   the launch counters show the kernels ran, the rebalancer moved share off
   worker 0 and the 9 series were written.
5. DenseNet-121 on the card against the same model on the CPU (plain
   versions), same weights and inputs.

The last two lines are the kernels' JSON record and the result line. Full
tables go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
import warnings

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

# H100 SXM peaks (NVIDIA data sheet): device memory rate and f32 outside the
# tensor cores, the type these kernels compute in.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12

MAIN_ARGV = (
    "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 "
    "--use_pallas true --straggler 3,1,1,1 --fault_mode virtual -e 3 "
    "--n_train 4096"
).split()
EPOCHS, WORKERS, GN_PER_FORWARD, MIN_STEPS = 3, 4, 120, 8


def log(*a):
    print(*a, flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median wall of ``fn`` in ms between CUDA events recorded around each
    call: device time plus any gap where the card waited for the host."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def device_ms(fn, reps: int = 5) -> float:
    """Device time of ``fn`` in ms: the CUDA kernel time ``torch.profiler``
    records over ``reps`` calls (after two warm-up calls), per call. Unlike
    an event wall it excludes the gaps where the card waits for the host."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total_us = 0.0
        for ev in prof.key_averages():
            us = getattr(ev, "self_device_time_total", None)
            total_us += us if us is not None else getattr(ev, "self_cuda_time_total", 0.0)
    if total_us <= 0:
        raise RuntimeError("the profiler recorded no device time")
    return total_us / reps / 1e3


def timed(fn, reps: int = 5) -> dict:
    """{"ms": device time, "wall_ms": CUDA-event wall} of ``fn``."""
    return {"ms": device_ms(fn, reps), "wall_ms": cuda_ms(fn, reps)}


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the f32 peak."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def densenet121_gn_shapes(torch, dev, b: int = 128):
    """The [B, S, C] of every GroupNorm call in one DenseNet-121 forward at
    batch ``b``, read off the model with forward hooks."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm
    from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet121

    model = DenseNet121().to(dev, memory_format=torch.channels_last)
    shapes = []

    def hook(m, inp, out):
        n, c, h, w = inp[0].shape
        shapes.append((n, h * w, c))

    handles = [m.register_forward_hook(hook) for m in model.modules() if isinstance(m, GroupNorm)]
    with torch.no_grad():
        model(torch.zeros(b, 32, 32, 3, device=dev))
    for h in handles:
        h.remove()
    assert len(shapes) == GN_PER_FORWARD, len(shapes)
    return shapes


def check_groupnorm(torch, dev, records):
    """K1 forward and backward against the plain version: the ISSUE's five
    DenseNet-121 shapes at b=128, f32 and bf16, relu on (the main path) and
    off."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        group_norm_bwd,
        group_norm_fwd,
        group_norm_ref,
    )

    gen = torch.Generator().manual_seed(0)
    cases = [(128, 1024, 64), (128, 1024, 224), (128, 256, 480), (128, 64, 992), (128, 16, 1024)]
    # tolerances: f32 forward 1e-4 and dx 5e-4 (f32 statistics, another
    # reduction order); dscale/dbias are sums over B*S terms, so their error
    # is held relative to their size (1e-4); bf16 rounds inputs and outputs
    # to 8 significant bits (2e-2 plus 1e-2 relative)
    tol = {torch.float32: (1e-4, 5e-4, 0.0), torch.bfloat16: (2e-2, 2e-2, 1e-2)}
    err = {"groupnorm_fwd": 0.0, "groupnorm_bwd": 0.0}
    for dtype in (torch.float32, torch.bfloat16):
        ty, tg, rt = tol[dtype]
        for shape in cases:
            for relu in ((True, False) if shape == cases[0] else (True,)):
                c = shape[-1]
                x = torch.randn(shape, generator=gen).to(dev, dtype)
                dy = torch.randn(shape, generator=gen).to(dev, dtype)
                w = (1 + 0.1 * torch.randn(c, generator=gen)).to(dev)
                b = (0.1 * torch.randn(c, generator=gen)).to(dev)
                y, mean, rstd = group_norm_fwd(x, w, b, 32, 1e-6, relu)
                dx, dw, db = group_norm_bwd(x, dy, w, b, mean, rstd, 32, relu)
                xr, wr, br = (t.detach().float().clone().requires_grad_() for t in (x, w, b))
                yr = group_norm_ref(xr, wr, br, 32, 1e-6, relu)
                gx, gw, gb = torch.autograd.grad(yr, (xr, wr, br), dy.float())
                torch.cuda.synchronize()
                e_y = (y.float() - yr).abs().max().item()
                e_x = (dx.float() - gx).abs().max().item()
                e_p = max((dw - gw).abs().max().item(), (db - gb).abs().max().item())
                log(f"  groupnorm {str(dtype)[6:]:8s} {shape} relu={relu}: "
                    f"|dy| {e_y:.2e}  |dx| {e_x:.2e}  |dscale,dbias| {e_p:.2e}")
                torch.testing.assert_close(y.float(), yr.detach(), atol=ty, rtol=rt)
                torch.testing.assert_close(dx.float(), gx, atol=tg, rtol=rt)
                torch.testing.assert_close(dw, gw, atol=tg, rtol=max(rt, 1e-4))
                torch.testing.assert_close(db, gb, atol=tg, rtol=max(rt, 1e-4))
                if dtype == torch.float32:
                    err["groupnorm_fwd"] = max(err["groupnorm_fwd"], e_y)
                    err["groupnorm_bwd"] = max(err["groupnorm_bwd"], e_x, e_p)
                records.append({"kernel": "groupnorm", "dtype": str(dtype), "shape": shape,
                                "relu": relu, "err_y": e_y, "err_dx": e_x, "err_params": e_p})
    return err


def check_xent(torch, dev, records):
    """K2 forward and backward against the plain version at [128, 10] (one
    worker's logits) and [256, 33278] (the language model's vocabulary),
    f32; atol 1e-5."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        softmax_xent_ref,
        xent_bwd,
        xent_fwd,
    )

    gen = torch.Generator().manual_seed(1)
    err = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    for r, v in ((128, 10), (256, 33278)):
        logits = (3 * torch.randn(r, v, generator=gen)).to(dev)
        labels = torch.randint(0, v, (r,), generator=gen)
        labels[0], labels[-1] = 0, v - 1
        labels = labels.to(dev)
        g = torch.full((r,), 1.0 / 512).to(dev)
        loss = xent_fwd(logits, labels)
        dx = xent_bwd(logits, labels, g)
        lr = logits.clone().requires_grad_()
        ref = softmax_xent_ref(lr, labels)
        (gref,) = torch.autograd.grad(ref, lr, g)
        e_f = (loss - ref.detach()).abs().max().item()
        e_b = (dx - gref).abs().max().item()
        log(f"  xent [{r}, {v}]: |loss| {e_f:.2e}  |dlogits| {e_b:.2e}")
        torch.testing.assert_close(loss, ref.detach(), atol=1e-5, rtol=0)
        torch.testing.assert_close(dx, gref, atol=1e-5, rtol=0)
        err["xent_fwd"] = max(err["xent_fwd"], e_f)
        err["xent_bwd"] = max(err["xent_bwd"], e_b)
        records.append({"kernel": "xent", "shape": [r, v], "err_loss": e_f, "err_dlogits": e_b})
    return err


def time_groupnorm(torch, dev, shapes):
    """K1 over the 120 GroupNorm calls of one DenseNet-121 worker forward
    (and backward) at b=128, f32, relu on: the kernel, the plain version and
    ``relu(F.group_norm)`` (cuDNN/ATen, the yardstick only)."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
        group_norm_bwd,
        group_norm_fwd,
        group_norm_ref,
    )

    gen = torch.Generator(device=dev).manual_seed(2)
    calls = []
    for b, s, c in shapes:
        x = torch.randn((b, s, c), device=dev, generator=gen)
        dy = torch.randn((b, s, c), device=dev, generator=gen)
        w = torch.ones(c, device=dev)
        bias = torch.zeros(c, device=dev)
        calls.append([x, dy, w, bias, None, None])
    for call in calls:
        x, _, w, bias, _, _ = call
        _, call[4], call[5] = group_norm_fwd(x, w, bias, 32, 1e-6, True)

    def k_fwd():
        for x, _, w, bias, _, _ in calls:
            group_norm_fwd(x, w, bias, 32, 1e-6, True)

    def k_bwd():
        for x, dy, w, bias, mean, rstd in calls:
            group_norm_bwd(x, dy, w, bias, mean, rstd, 32, True)

    def p_fwd():
        for x, _, w, bias, _, _ in calls:
            group_norm_ref(x, w, bias, 32, 1e-6, True)

    def lib_view(x):  # [B, S, C] -> NCHW view in channels-last memory
        b, s, c = x.shape
        h = int(round(s ** 0.5))
        return x.view(b, h, h, c).permute(0, 3, 1, 2)

    def l_fwd():
        for x, _, w, bias, _, _ in calls:
            F.relu(F.group_norm(lib_view(x), 32, w, bias, 1e-6))

    out = {"groupnorm_fwd": timed(k_fwd)}
    out["groupnorm_fwd"]["plain_ms"] = device_ms(p_fwd)
    out["groupnorm_fwd"]["library_ms"] = device_ms(l_fwd)
    n_el = sum(b * s * c for b, s, c in shapes)
    small = sum(2 * c * 4 + 2 * b * 32 * 4 for b, s, c in shapes)
    out["groupnorm_fwd"]["bound_ms"], out["groupnorm_fwd"]["bound_by"] = bound(
        2 * n_el * 4 + small, 6 * n_el
    )
    out["groupnorm_bwd"] = timed(k_bwd)
    # backward yardsticks: autograd through graphs built outside the timing
    for key, fwd in (("plain_ms", lambda x, w, bias: group_norm_ref(x, w, bias, 32, 1e-6, True)),
                     ("library_ms", lambda x, w, bias: F.relu(F.group_norm(lib_view(x), 32, w, bias, 1e-6)))):
        graphs = []
        for x, dy, w, bias, _, _ in calls:
            xr, wr, br = (t.detach().requires_grad_() for t in (x, w, bias))
            y = fwd(xr, wr, br)
            graphs.append((y, (xr, wr, br), dy.view(y.shape) if y.dim() == 3 else lib_view(dy)))

        def bwd(graphs=graphs):
            for y, ins, g in graphs:
                torch.autograd.grad(y, ins, g, retain_graph=True)

        out["groupnorm_bwd"][key] = device_ms(bwd)
        del graphs
        torch.cuda.empty_cache()
    out["groupnorm_bwd"]["bound_ms"], out["groupnorm_bwd"]["bound_by"] = bound(
        3 * n_el * 4 + small + sum(2 * c * 4 for b, s, c in shapes), 16 * n_el
    )
    return out


def time_xent(torch, dev):
    """K2 at one worker step's logits, [128, 10] f32 (the main path), with
    ``F.cross_entropy(reduction="none")`` as the yardstick; [256, 33278] is
    printed for the later language-model path."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        softmax_xent_ref,
        xent_bwd,
        xent_fwd,
    )

    out = {}
    for r, v in ((128, 10), (256, 33278)):
        gen = torch.Generator(device=dev).manual_seed(3)
        logits = torch.randn((r, v), device=dev, generator=gen)
        labels = torch.randint(0, v, (r,), device=dev, generator=gen)
        g = torch.full((r,), 1.0 / 512, device=dev)
        lr = logits.clone().requires_grad_()
        ref = softmax_xent_ref(lr, labels)
        lib = F.cross_entropy(lr, labels, reduction="none")
        row = {
            "xent_fwd": dict(
                timed(lambda: xent_fwd(logits, labels), reps=50),
                plain_ms=device_ms(lambda: softmax_xent_ref(logits, labels), reps=50),
                library_ms=device_ms(
                    lambda: F.cross_entropy(logits, labels, reduction="none"), reps=50),
            ),
            "xent_bwd": dict(
                timed(lambda: xent_bwd(logits, labels, g), reps=50),
                plain_ms=device_ms(
                    lambda: torch.autograd.grad(ref, lr, g, retain_graph=True), reps=50),
                library_ms=device_ms(
                    lambda: torch.autograd.grad(lib, lr, g, retain_graph=True), reps=50),
            ),
        }
        row["xent_fwd"]["bound_ms"], row["xent_fwd"]["bound_by"] = bound(
            r * v * 4 + r * 8 + r * 4, 4 * r * v
        )
        row["xent_bwd"]["bound_ms"], row["xent_bwd"]["bound_by"] = bound(
            2 * r * v * 4 + r * 8 + r * 4, 5 * r * v
        )
        out[(r, v)] = row
    return out


def run_main_path(torch):
    """The port's cli on the canonical recipe; returns (launch counts, series)."""
    from dynamic_load_balance_distributeddnn_tpu_torch import cli
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")
    run_dir = os.path.join(OUT, "run")
    shutil.rmtree(run_dir, ignore_errors=True)  # a done-sentinel would skip the run
    argv = MAIN_ARGV + ["--log_dir", os.path.join(run_dir, "logs"),
                        "--stat_dir", os.path.join(run_dir, "statis")]
    log("  python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(MAIN_ARGV))
    runtime.reset_launches()
    t0 = time.perf_counter()
    assert cli.main(argv) == 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(runtime.LAUNCHES)
    cfg = config_from_args(argv)
    with open(os.path.join(cfg.stat_dir, cfg.base_filename().format(0) + ".json")) as f:
        series = json.load(f)
    log(f"  cli.main wall {wall:.1f}s (data, model build and validation included)")
    return counts, series


def check_main_path(counts, series):
    from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES

    for k in SERIES:
        assert len(series[k]) == EPOCHS, (k, series[k])
    loss = series["train_loss"]
    assert all(math.isfinite(v) for v in loss), loss
    assert all(math.isfinite(v) for v in series["val_loss"]), series["val_loss"]
    share0 = [p[0] for p in series["partition"]]
    assert share0[-1] < 0.25, f"worker 0 share did not drop: {share0}"
    need = GN_PER_FORWARD * 2 * WORKERS * MIN_STEPS * EPOCHS
    gn = counts["groupnorm_fwd"] + counts["groupnorm_bwd"]
    assert gn >= need, f"GroupNorm launches {gn} < {need}"
    for k, n in counts.items():
        assert n > 0, f"kernel {k} never launched on the main path"
    walls = [series["wallclock_time"][0]] + [
        b - a for a, b in zip(series["wallclock_time"], series["wallclock_time"][1:])
    ]
    for e in range(EPOCHS):
        log(f"  epoch {e}: wall {walls[e]:.3f}s  examples/s {series['examples_per_s'][e]:.1f}  "
            f"train_loss {loss[e]:.4f}  val_loss {series['val_loss'][e]:.4f}  "
            f"accuracy {series['accuracy'][e]:.2f}  partition "
            f"{[round(p, 4) for p in series['partition'][e]]}  sync_time "
            f"{series['sync_time'][e]:.4f}s")
    log(f"  launches: {counts}")


def check_against_cpu(torch, dev):
    """DenseNet-121 through the kernels on the card vs the plain versions on
    the CPU, same seeded weights and 8 inputs: logits and the first conv's
    loss gradient within atol 2e-3 (121 layers of differently ordered f32
    sums; TF32 off)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet121
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

    cpu = DenseNet121()
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    gpu = DenseNet121()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev, memory_format=torch.channels_last)
    x = torch.randn(8, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (8,), generator=torch.Generator().manual_seed(2))
    res = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        logits = model(x.to(d))
        softmax_xent(logits, y.to(d)).mean().backward()
        res.append((logits.detach().cpu(), model.Conv_0.weight.grad.cpu()))
    e_l = (res[1][0] - res[0][0]).abs().max().item()
    e_g = (res[1][1] - res[0][1]).abs().max().item()
    log(f"  DenseNet-121 card vs CPU: |logits| {e_l:.2e} (max |logit| "
        f"{res[0][0].abs().max().item():.2f}), |dConv_0| {e_g:.2e}")
    assert res[1][0].shape == (8, 10) and torch.isfinite(res[1][0]).all()
    torch.testing.assert_close(res[1][0], res[0][0], atol=2e-3, rtol=0)
    torch.testing.assert_close(res[1][1], res[0][1], atol=2e-3, rtol=0)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs the port on an NVIDIA card",
              file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    t_start = time.perf_counter()
    os.makedirs(OUT, exist_ok=True)
    dev = torch.device("cuda", 0)

    log("[1] card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    log("[2] build")
    t0 = time.perf_counter()
    runtime.build()
    log(f"  built {list(runtime.SOURCES)} in {time.perf_counter() - t0:.1f}s into {runtime.BUILD_DIR}")
    for name, text in runtime.BUILD_LOG.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  {name}: {line.strip()}")

    log("[3] kernels against their plain versions")
    records = []
    err = check_groupnorm(torch, dev, records)
    err.update(check_xent(torch, dev, records))
    shapes = densenet121_gn_shapes(torch, dev)
    timing = time_groupnorm(torch, dev, shapes)
    xt = time_xent(torch, dev)
    timing.update(xt[(128, 10)])
    for (r, v), row in xt.items():
        for k, t in row.items():
            log(f"  {k} [{r}, {v}]: kernel {t['ms']:.4f} ms (event wall {t['wall_ms']:.4f}), "
                f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
                f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    for k in ("groupnorm_fwd", "groupnorm_bwd"):
        t = timing[k]
        log(f"  {k} x{len(shapes)} (one DenseNet-121 worker pass, b=128): kernel {t['ms']:.3f} ms "
            f"(event wall {t['wall_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    torch.cuda.empty_cache()

    log("[4] main path")
    counts, series = run_main_path(torch)
    check_main_path(counts, series)

    log("[5] end-to-end numerics")
    check_against_cpu(torch, dev)

    sources = {
        "groupnorm_fwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:32"),
        "groupnorm_bwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:110"),
        "xent_fwd": ("csrc/xent.cu", "ops/pallas/xent.py:30"),
        "xent_bwd": ("csrc/xent.cu", "ops/pallas/xent.py:40"),
    }
    kernels = []
    for name, (src, tpu) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dynamic_load_balance_distributeddnn_tpu_torch/" + src,
            "replaces": "dynamic_load_balance_distributeddnn_tpu/" + tpu,
            "launches": counts[name],
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
        })
    with open(os.path.join(OUT, "kernels.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "checks": records,
                   "groupnorm_shapes": shapes, "series": series,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
