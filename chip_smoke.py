#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA card and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits nonzero; there is no CPU fallback):

1. The card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
   TF32 off for matrix products and convolutions (the plain versions and the
   CPU references are full f32).
2. Build every CUDA kernel from ``dynamic_load_balance_distributeddnn_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together) into ``build/torch_kernels``.
3. Each kernel against its plain PyTorch version on the card: GroupNorm (K1)
   at DenseNet-121 shapes, f32 and bf16; cross-entropy (K2) at one DenseNet
   worker's logits, at the language model's worker shapes and the full
   wikitext-2 vocabulary (33,278), f32 and bf16, with labels out of range
   and a row slice that starts off a 16-byte boundary; flash attention (K3,
   forward, dK/dV, dQ) at the language model's shape and at a long-context
   shape. Then each kernel's device time (the profiler's sum of kernel
   time, so host launch gaps are not counted) beside its bound, the plain
   version's and one PyTorch library call's; the CUDA-event wall, which
   includes the host's launch gaps, is printed beside it. K2 is timed at
   every row count the language-model path gives it (below).
4. The vision path: the port's ``cli.main`` trains DenseNet-121 on synthetic
   CIFAR-10 with 4 workers, B=512 and a 3:1 virtual straggler for 3 epochs;
   the launch counters (zeroed just before) show K1 and K2 ran, the
   rebalancer moved share off worker 0 and the 9 series were written.
5. The language-model path: ``cli.main`` trains the Transformer LM (EMSIZE
   200, 2 heads, 2 layers) on the committed wikitext-2 files with 4 workers,
   80 columns, bptt 35, per-worker clipping at 0.25, flash attention and a
   3:1 virtual straggler for 3 epochs; the counters (zeroed just before)
   show K3 and K2 ran, share moved off worker 0, the 9 series were written.
6. DenseNet-121 and the Transformer LM on the card against the same models
   on the CPU (plain versions), same weights and inputs.

The last two lines are the kernels' JSON record and the result line. Full
tables go to ``chiprun_out/chip_smoke/``.
"""

from __future__ import annotations

import json
import math
import os
import shutil
import sys
import time

from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import (
    bound,
    card,
    device_ms,
    timed,
    xent_inputs,
    xent_yardsticks,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(ROOT, "chiprun_out", "chip_smoke")

MAIN_ARGV = (
    "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 "
    "--use_pallas true --straggler 3,1,1,1 --fault_mode virtual -e 3 "
    "--n_train 4096"
).split()
EPOCHS, WORKERS, GN_PER_FORWARD, MIN_STEPS = 3, 4, 120, 8

LM_ARGV = (
    "-m transformer -ds wikitext2 -d false -ws 4 -b 80 -gpu 0,0,0,0 --bptt 35 "
    "--grad_clip 0.25 --straggler 3,1,1,1 --fault_mode virtual "
    "--use_flash_attention true -e 3"
).split()
# 217,646 training tokens over 80 columns make 2,720 rows, 78 windows of 35
# tokens per epoch; 70 leaves room for the rounding of the column split
LM_LAYERS, LM_MIN_STEPS = 2, 70
# K3 shapes: the language model's (B*H = 2 heads x 40 columns, T = bptt,
# D = 200 / 2 heads) and the long-context one of scripts/kernel_bench.py
ATTN_PATH_SHAPE, ATTN_LONG_SHAPE = (40, 2, 35, 100), (4, 4, 2048, 128)
# K2 on the language model's path, over the 18,328-word vocabulary of the
# committed wikitext-2 files: 80 columns x 35 tokens split over 4 workers
# give 700 rows a worker under the first (uniform) plan; after rebalancing
# the straggler takes about 105 rows (3 columns) and each other worker about
# 910; validation runs 1,024-window chunks, 35,840 rows (forward only).
# XENT_LM_SHAPE, 40 columns (the size of two uniform workers' logits), is the
# JSON line's shape, kept from the earlier slices' records.
XENT_LM_V = 18328
XENT_LM_SHAPE = (40 * 35, XENT_LM_V)
XENT_PATH_ROWS = (105, 700, 910, 40 * 35)
XENT_VAL_ROWS = 1024 * 35
XENT_FULL_V = 33278  # wikitext-2's vocabulary once train.txt is present
CNN_KERNELS = ("groupnorm_fwd", "groupnorm_bwd", "xent_fwd", "xent_bwd")
LM_KERNELS = ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq", "xent_fwd", "xent_bwd")


def log(*a):
    print(*a, flush=True)


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


def dlogits_ratio(torch, dx, want, labels, g, rtol: float) -> float:
    """The largest ratio of |dx - want| to its limit, ``rtol * |want|``
    plus, on the gold column, where p - 1 cancels, ``2**-21 * g`` (four f32
    steps of a p near 1): above 1 fails. The limit follows each entry's own
    size: at V = 18,328 a typical entry is about g * 1e-6, far below any
    absolute tolerance that the gold column would need."""
    gold = torch.arange(want.shape[-1], device=want.device) == labels[:, None]
    lim = rtol * want.abs() + gold * (2.0**-21 * g[:, None])
    return ((dx.float() - want).abs() / lim.clamp_min(1e-38)).max().item()


def check_xent(torch, dev, records):
    """K2 forward and backward against their plain versions (the backward's
    with the kernel's own lse) on the same inputs: [128, 10] (one DenseNet
    worker's logits), [1400, 18328] (the language model's), [105, 33278]
    (the full wikitext-2 vocabulary, rows off 16-byte boundaries), each in
    f32 and bf16, with two labels out of range in the first; and logits[1:]
    of a [14, 10] tensor, a base off a 16-byte boundary. Tolerance: loss and
    lse atol 1e-5 (f32 sums in another order); each gradient entry within
    rtol 1e-5 of the plain version's in f32 (the same f32 expression; room
    for an exp a few steps apart), and for bf16 within rtol 2**-8 + 1e-5
    (the kernel rounds once to bf16's 8 significant bits), the gold column
    also within 2**-21 * g (see ``dlogits_ratio``)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
        xent_bwd,
        xent_bwd_ref,
        xent_fwd,
        xent_fwd_ref,
    )

    gen = torch.Generator().manual_seed(1)
    err = {"xent_fwd": 0.0, "xent_bwd": 0.0}
    cases = [(128, 10), XENT_LM_SHAPE, (105, XENT_FULL_V)]
    for dtype in (torch.float32, torch.bfloat16):
        rtol = 1e-5 if dtype == torch.float32 else 2.0**-8 + 1e-5
        for i, (r, v) in enumerate(cases + [(14, 10)]):
            logits = (3 * torch.randn(r, v, generator=gen)).to(dev, dtype)
            labels = torch.randint(0, v, (r,), generator=gen)
            labels[0], labels[-1] = 0, v - 1
            if i == 0:
                labels[1], labels[2] = -1, v  # out of range: gold 0, no onehot
            labels = labels.to(dev)
            g = (torch.rand(r, generator=gen) / 512).to(dev)
            what = f"[{r}, {v}]"
            if i == len(cases):  # a row slice: its base is off 16 bytes
                logits, labels, g = logits[1:], labels[1:], g[1:]
                assert logits.is_contiguous() and logits.data_ptr() % 16 != 0
                what = f"[{r}, {v}][1:]"
            loss, lse = xent_fwd(logits, labels)
            dx = xent_bwd(logits, labels, g, lse)
            loss_r, lse_r = xent_fwd_ref(logits, labels)
            dx_r = xent_bwd_ref(logits.float(), labels, g, lse)
            torch.cuda.synchronize()
            e_f = max((loss - loss_r).abs().max().item(), (lse - lse_r).abs().max().item())
            e_b = (dx.float() - dx_r).abs().max().item()
            ratio = dlogits_ratio(torch, dx, dx_r, labels, g, rtol)
            log(f"  xent {str(dtype)[6:]:8s} {what}: |loss, lse| {e_f:.2e}  |dlogits| {e_b:.2e} "
                f"(at most {ratio:.3f} of its limit, median |dlogits| "
                f"{dx_r.abs().median().item():.2e})")
            torch.testing.assert_close(loss, loss_r, atol=1e-5, rtol=0)
            torch.testing.assert_close(lse, lse_r, atol=1e-5, rtol=0)
            assert ratio <= 1.0, f"xent {dtype} {what}: dlogits off by {ratio:.3g} of its limit"
            assert dx.dtype == dtype
            if dtype == torch.float32:
                err["xent_fwd"] = max(err["xent_fwd"], e_f)
                err["xent_bwd"] = max(err["xent_bwd"], e_b)
            records.append({"kernel": "xent", "dtype": str(dtype), "shape": what,
                            "err_loss_lse": e_f, "err_dlogits": e_b, "dlogits_ratio": ratio})
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
    """K2 f32 at one DenseNet worker step's logits, [128, 10], and at every
    row count of the language model's path over its 18,328-word vocabulary
    (forward and backward; the validation chunk forward only): the kernels
    beside their plain versions, ``F.cross_entropy(reduction="none")`` (the
    yardstick; its backward through autograd) and their bounds."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import xent_bwd, xent_fwd

    out = {}
    shapes = [(128, 10)] + [(r, XENT_LM_V) for r in XENT_PATH_ROWS + (XENT_VAL_ROWS,)]
    for r, v in shapes:
        backward = r != XENT_VAL_ROWS  # validation runs no backward
        reps = 50 if backward else 5
        logits, labels, g, lse = xent_inputs(r, v, dev)
        row = xent_yardsticks(logits, labels, g, lse, reps, backward)
        row["xent_fwd"].update(timed(lambda: xent_fwd(logits, labels), reps))
        if backward:
            row["xent_bwd"].update(timed(lambda: xent_bwd(logits, labels, g, lse), reps))
        out[(r, v)] = row
        del logits, labels, g, lse
        torch.cuda.empty_cache()
    return out


def _attn_inputs(torch, dev, shape, seed):
    """q, k (0.5 randn), v, dO (randn) as [B*H, T, D] f32 on the card."""
    b, h, t, d = shape
    gen = torch.Generator().manual_seed(seed)
    q, k = (0.5 * torch.randn((b * h, t, d), generator=gen) for _ in range(2))
    v, do = (torch.randn((b * h, t, d), generator=gen) for _ in range(2))
    return [x.to(dev) for x in (q, k, v, do)]


def check_flash(torch, dev, records):
    """K3 forward, dK/dV and dQ against their plain versions (same inputs,
    the kernel's own lse and delta), f32: at the language model's shape,
    causal, to the JAX package's tolerances (forward 2e-5, gradients 5e-4),
    plus the autograd route against plain softmax attention; at the
    long-context shape, causal and not, forward atol 1e-4 and gradients 1e-3
    (each output sums 2,048 products, and the kernels sum them in 64-wide
    tiles in another order than cuBLAS does for the plain version)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attention_ref,
        attn_bwd_dkv,
        attn_bwd_dkv_ref,
        attn_bwd_dq,
        attn_bwd_dq_ref,
        attn_fwd,
        attn_fwd_ref,
        flash_attention,
    )

    err = {}
    cases = [(ATTN_PATH_SHAPE, True, 2e-5, 5e-4)] + [
        (ATTN_LONG_SHAPE, causal, 1e-4, 1e-3) for causal in (True, False)
    ]
    for shape, causal, tf, tg in cases:
        q, k, v, do = _attn_inputs(torch, dev, shape, 11)
        o, lse = attn_fwd(q, k, v, causal)
        delta = (do * o).sum(-1)
        dk, dv = attn_bwd_dkv(q, k, v, do, lse, delta, causal)
        dq = attn_bwd_dq(q, k, v, do, lse, delta, causal)
        o_r, lse_r = attn_fwd_ref(q, k, v, causal)
        dk_r, dv_r = attn_bwd_dkv_ref(q, k, v, do, lse, delta, causal)
        dq_r = attn_bwd_dq_ref(q, k, v, do, lse, delta, causal)
        torch.cuda.synchronize()
        e = {
            "attn_fwd": max((o - o_r).abs().max().item(), (lse - lse_r).abs().max().item()),
            "attn_bwd_dkv": max((dk - dk_r).abs().max().item(), (dv - dv_r).abs().max().item()),
            "attn_bwd_dq": (dq - dq_r).abs().max().item(),
        }
        log(f"  flash attention {shape} causal={causal}: |o, lse| {e['attn_fwd']:.2e}  "
            f"|dk, dv| {e['attn_bwd_dkv']:.2e}  |dq| {e['attn_bwd_dq']:.2e}")
        torch.testing.assert_close(o, o_r, atol=tf, rtol=0)
        torch.testing.assert_close(lse, lse_r, atol=tf, rtol=0)
        for got, want in ((dk, dk_r), (dv, dv_r), (dq, dq_r)):
            torch.testing.assert_close(got, want, atol=tg, rtol=0)
        records.append({"kernel": "flash_attention", "shape": shape, "causal": causal, **e})
        if shape == ATTN_PATH_SHAPE:
            err = e
            # the autograd route (what the model calls) against plain attention
            b, h, t, d = shape
            qs, ks, vs = (x.view(b, h, t, d).clone().requires_grad_() for x in (q, k, v))
            qp, kp, vp = (x.detach().clone().requires_grad_() for x in (qs, ks, vs))
            out = flash_attention(qs, ks, vs, causal=causal)
            ref = attention_ref(qp, kp, vp, causal=causal)
            g4 = do.view(b, h, t, d)
            torch.testing.assert_close(out, ref, atol=tf, rtol=0)
            for got, want in zip(torch.autograd.grad(out, (qs, ks, vs), g4),
                                 torch.autograd.grad(ref, (qp, kp, vp), g4)):
                torch.testing.assert_close(got, want, atol=tg, rtol=0)
        del q, k, v, do, o, lse, delta, dk, dv, dq, o_r, lse_r, dk_r, dv_r, dq_r
        torch.cuda.empty_cache()
    return err


def attn_work(shape, causal: bool):
    """{kernel: (bytes, flops)}: each input read once and each output
    written once; flops of the two (forward), four (dK/dV) or three (dQ)
    products over the (query, key) pairs the mask leaves visible, 2*D each
    (the exps and the softmax arithmetic are not counted)."""
    b, h, t, d = shape
    bh = b * h
    pairs = bh * (t * (t + 1) // 2 if causal else t * t)
    mat, rows = bh * t * d * 4, bh * t * 4
    return {
        "attn_fwd": (3 * mat + mat + rows, 2 * 2 * d * pairs),
        "attn_bwd_dkv": (4 * mat + 2 * rows + 2 * mat, 4 * 2 * d * pairs),
        "attn_bwd_dq": (4 * mat + 2 * rows + mat, 3 * 2 * d * pairs),
    }


def time_flash(torch, dev):
    """K3 at the language model's shape and the long-context shape, causal,
    f32: the kernels, their plain versions, and
    ``F.scaled_dot_product_attention(is_causal=True)`` with autograd as the
    yardstick (forward on inputs that require grad; its backward, which
    computes dq, dk and dv in one call, beside both backward kernels)."""
    from torch.nn import functional as F

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
        attn_bwd_dkv,
        attn_bwd_dkv_ref,
        attn_bwd_dq,
        attn_bwd_dq_ref,
        attn_fwd,
        attn_fwd_ref,
    )

    out = {}
    for shape in (ATTN_PATH_SHAPE, ATTN_LONG_SHAPE):
        b, h, t, d = shape
        q, k, v, do = _attn_inputs(torch, dev, shape, 12)
        o, lse = attn_fwd(q, k, v, True)
        delta = (do * o).sum(-1)
        args = (q, k, v, do, lse, delta, True)
        ql, kl, vl = (x.view(b, h, t, d).clone().requires_grad_() for x in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)
        lib_bwd = device_ms(lambda: torch.autograd.grad(
            lib_out, (ql, kl, vl), do.view(b, h, t, d), retain_graph=True))
        row = {
            "attn_fwd": dict(
                timed(lambda: attn_fwd(q, k, v, True)),
                plain_ms=device_ms(lambda: attn_fwd_ref(q, k, v, True)),
                library_ms=device_ms(
                    lambda: F.scaled_dot_product_attention(ql, kl, vl, is_causal=True)),
            ),
            "attn_bwd_dkv": dict(
                timed(lambda: attn_bwd_dkv(*args)),
                plain_ms=device_ms(lambda: attn_bwd_dkv_ref(*args)),
                library_ms=lib_bwd,
            ),
            "attn_bwd_dq": dict(
                timed(lambda: attn_bwd_dq(*args)),
                plain_ms=device_ms(lambda: attn_bwd_dq_ref(*args)),
                library_ms=lib_bwd,
            ),
        }
        for name, (nbytes, flops) in attn_work(shape, True).items():
            row[name]["bound_ms"], row[name]["bound_by"] = bound(nbytes, flops)
        out[shape] = row
        del q, k, v, do, o, lse, delta, args, ql, kl, vl, lib_out
        torch.cuda.empty_cache()
    return out


def run_path(torch, argv, tag):
    """The port's cli on one recipe, launch counts zeroed just before and
    read just after; returns (launch counts, series, cli wall)."""
    from dynamic_load_balance_distributeddnn_tpu_torch import cli
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    run_dir = os.path.join(OUT, tag)
    shutil.rmtree(run_dir, ignore_errors=True)  # a done-sentinel would skip the run
    full = argv + ["--log_dir", os.path.join(run_dir, "logs"),
                   "--stat_dir", os.path.join(run_dir, "statis")]
    log("  python -m dynamic_load_balance_distributeddnn_tpu_torch.cli " + " ".join(argv))
    runtime.reset_launches()
    t0 = time.perf_counter()
    assert cli.main(full) == 0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(runtime.LAUNCHES)
    cfg = config_from_args(full)
    with open(os.path.join(cfg.stat_dir, cfg.base_filename().format(0) + ".json")) as f:
        series = json.load(f)
    log(f"  cli.main wall {wall:.1f}s (data, model build and validation included)")
    return counts, series, wall


def check_series(series, rate: str):
    """The 9 series, finite losses, share moved off the straggler."""
    from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES

    for k in SERIES:
        assert len(series[k]) == EPOCHS, (k, series[k])
    loss = series["train_loss"]
    assert all(math.isfinite(v) for v in loss), loss
    assert all(math.isfinite(v) for v in series["val_loss"]), series["val_loss"]
    share0 = [p[0] for p in series["partition"]]
    assert share0[-1] < 0.25, f"worker 0 share did not drop: {share0}"
    walls = [series["wallclock_time"][0]] + [
        b - a for a, b in zip(series["wallclock_time"], series["wallclock_time"][1:])
    ]
    for e in range(EPOCHS):
        log(f"  epoch {e}: wall {walls[e]:.3f}s  {rate}/s {series['examples_per_s'][e]:.1f}  "
            f"train_loss {loss[e]:.4f}  val_loss {series['val_loss'][e]:.4f}  "
            f"accuracy {series['accuracy'][e]:.4f}  partition "
            f"{[round(p, 4) for p in series['partition'][e]]}  sync_time "
            f"{series['sync_time'][e]:.4f}s  probe_time {series['probe_time'][e]:.3f}s")


def check_main_path(counts, series):
    check_series(series, "examples")
    need = GN_PER_FORWARD * 2 * WORKERS * MIN_STEPS * EPOCHS
    gn = counts["groupnorm_fwd"] + counts["groupnorm_bwd"]
    assert gn >= need, f"GroupNorm launches {gn} < {need}"
    for k in CNN_KERNELS:
        assert counts[k] > 0, f"kernel {k} never launched on the vision path"
    log(f"  launches: {counts}")


def check_lm_path(counts, series):
    check_series(series, "tokens")
    assert series["accuracy"] == [1.0 - v for v in series["val_loss"]], "accuracy != 1 - val_loss"
    for k in LM_KERNELS:
        # attention runs once per layer of a worker step, the loss once
        need = (LM_LAYERS if k.startswith("attn") else 1) * WORKERS * LM_MIN_STEPS * EPOCHS
        assert counts[k] >= need, f"kernel {k}: {counts[k]} launches on the LM path < {need}"
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


def check_lm_against_cpu(torch, dev):
    """The Transformer LM at full width (18,328-word vocabulary, EMSIZE 200,
    2 heads, 2 layers, flash attention) through the kernels on the card vs
    the plain versions on the CPU, same seeded weights and 8 windows of 35
    tokens, eval mode (no dropout): logits and the embedding's loss gradient
    within atol 1e-4 (two layers and a 200 x 18,328 output product of f32
    sums in another order on the card; TF32 off)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
    from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import TransformerLM
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

    kw = dict(ntoken=XENT_LM_SHAPE[1], ninp=200, nhead=2, nhid=200, nlayers=LM_LAYERS,
              dropout=0.2, use_flash=True)
    cpu = TransformerLM(**kw).eval()
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    gpu = TransformerLM(**kw).eval()
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(dev)
    gen = torch.Generator().manual_seed(1)
    x = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
    y = torch.randint(0, kw["ntoken"], (8, 35), generator=gen)
    res = []
    for model, d in ((cpu, "cpu"), (gpu, dev)):
        logits = model(x.to(d))
        softmax_xent(logits, y.to(d)).mean().backward()
        res.append((logits.detach().cpu(), model.Embed_0.weight.grad.cpu()))
    e_l = (res[1][0] - res[0][0]).abs().max().item()
    e_g = (res[1][1] - res[0][1]).abs().max().item()
    log(f"  Transformer LM card vs CPU: |logits| {e_l:.2e} (max |logit| "
        f"{res[0][0].abs().max().item():.2f}), |dEmbed_0| {e_g:.2e} (max "
        f"{res[0][1].abs().max().item():.2e})")
    assert res[1][0].shape == (8, 35, kw["ntoken"]) and torch.isfinite(res[1][0]).all()
    torch.testing.assert_close(res[1][0], res[0][0], atol=1e-4, rtol=0)
    torch.testing.assert_close(res[1][1], res[0][1], atol=1e-4, rtol=0)


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
    smi = card()
    log(smi)
    log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"  torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")
    log(f"  torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}")

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
    err.update(check_flash(torch, dev, records))
    shapes = densenet121_gn_shapes(torch, dev)
    timing = time_groupnorm(torch, dev, shapes)
    xt = time_xent(torch, dev)
    at = time_flash(torch, dev)
    # the JSON line's K2 and K3 rows are at the language model's shapes
    timing.update(xt[XENT_LM_SHAPE])
    timing.update(at[ATTN_PATH_SHAPE])
    rows = [(f"[{r}, {v}]", k, t) for (r, v), row in xt.items() for k, t in row.items()]
    rows += [(f"{sh} causal", k, t) for sh, row in at.items() for k, t in row.items()]
    for where, k, t in rows:
        log(f"  {k} {where}: kernel {t['ms']:.4f} ms (event wall {t['wall_ms']:.4f}), "
            f"plain {t['plain_ms']:.4f} ms, library {t['library_ms']:.4f} ms, "
            f"bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    for k in ("groupnorm_fwd", "groupnorm_bwd"):
        t = timing[k]
        log(f"  {k} x{len(shapes)} (one DenseNet-121 worker pass, b=128): kernel {t['ms']:.3f} ms "
            f"(event wall {t['wall_ms']:.3f}), plain {t['plain_ms']:.3f} ms, "
            f"library {t['library_ms']:.3f} ms, "
            f"bound {t['bound_ms']:.3f} ms ({t['bound_by']})")
    torch.cuda.empty_cache()

    log("[4] vision path")
    counts_cnn, series_cnn, _ = run_path(torch, MAIN_ARGV, "run")
    check_main_path(counts_cnn, series_cnn)
    torch.cuda.empty_cache()

    log("[5] language-model path")
    counts_lm, series_lm, _ = run_path(torch, LM_ARGV, "run_lm")
    check_lm_path(counts_lm, series_lm)
    torch.cuda.empty_cache()

    log("[6] end-to-end numerics")
    check_against_cpu(torch, dev)
    check_lm_against_cpu(torch, dev)

    sources = {
        "groupnorm_fwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:32", "DenseNet-121 b=128, 120 calls"),
        "groupnorm_bwd": ("csrc/groupnorm.cu", "ops/pallas/groupnorm.py:110", "DenseNet-121 b=128, 120 calls"),
        "xent_fwd": ("csrc/xent.cu", "ops/pallas/xent.py:30", list(XENT_LM_SHAPE)),
        "xent_bwd": ("csrc/xent.cu", "ops/pallas/xent.py:40", list(XENT_LM_SHAPE)),
        "attn_fwd": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:58", list(ATTN_PATH_SHAPE)),
        "attn_bwd_dkv": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:106", list(ATTN_PATH_SHAPE)),
        "attn_bwd_dq": ("csrc/flash_attention.cu", "ops/pallas/flash_attention.py:153", list(ATTN_PATH_SHAPE)),
    }
    kernels = []
    for name, (src, tpu, shape) in sources.items():
        t = timing[name]
        kernels.append({
            "name": name,
            "route": "cuda",
            "source": "dynamic_load_balance_distributeddnn_tpu_torch/" + src,
            "replaces": "dynamic_load_balance_distributeddnn_tpu/" + tpu,
            # each path counted from zero; a kernel on both paths adds both
            "launches": counts_cnn[name] + counts_lm[name],
            "max_abs_err": err[name],
            "ms": t["ms"],
            "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"],
            "library_ms": t["library_ms"],
            "shape": shape,
        })
    with open(os.path.join(OUT, "kernels.json"), "w") as f:
        json.dump({"card": smi, "kernels": kernels, "checks": records,
                   "xent_timing": {str(k): v for k, v in xt.items()},
                   "attn_timing": {str(k): v for k, v in at.items()},
                   "launches": {"vision": counts_cnn, "lm": counts_lm},
                   "groupnorm_shapes": shapes, "series": series_cnn, "series_lm": series_lm,
                   "seconds": time.perf_counter() - t_start}, f, indent=1)
    log(f"  total {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
