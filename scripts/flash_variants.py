#!/usr/bin/env python3
"""What binds K3's tiled kernels on an NVIDIA card: variants of
``csrc/flash_attention.cu`` with one cost taken out, timed beside the kernels.

    python3 scripts/flash_variants.py [--rounds N] [--out DIR]

Each variant is the source with one textual change, built by ``nvcc`` (the
runtime's flags) into ``build/flash_variants/`` and loaded with ctypes:

- ``3xtf32``: the source as it is (the kernels the port launches);
- ``1xtf32``: only the hi * hi product, a third of the tensor-core work;
- ``no split``: each operand handed to the tensor cores as it is, with no
  split work, the same three products;
- ``1xtf32, no split``: both;
- ``2 slots``: the forward's ring of K/V tiles in 2 slots (one copy in
  flight) in place of 3, so 3 blocks (12 warps) share an SM at D = 128
  where 3 slots fit 2 (8 warps).

Only ``3xtf32`` and ``2 slots`` compute attention to f32 accuracy; the
others measure what the work they drop costs. The forward, dK/dV and dQ are
timed (device time, ``obs/kernel_timing.device_ms``), causal, at (4, 4,
2048, 128) and at the language model's largest ``--bptt 256`` step (26, 2,
256, 100), the variants alternating over ``--rounds`` rounds (default 3).
The table goes to ``<out>/flash_variants.json`` (default
``chiprun_out/flash_variants``). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SHAPES = [(4, 4, 2048, 128), (26, 2, 256, 100)]
SMALL_TERMS = "  mma_tf32(c, alo, bhi);\n  mma_tf32(c, ahi, blo);\n"
SMALL_ROWS = "      mma_tf32(small[n], alo, bhi);\n      mma_tf32(small[n], ahi, blo);\n"
SPLIT = ("  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
         "  lo = __float_as_uint(x - __uint_as_float(hi));")
NO_SPLIT = "  hi = __float_as_uint(x);\n  lo = hi;"
SLOTS = "constexpr int kFwdSlots = 3;"


def variants(src: str) -> dict:
    """{name: source} of the variants (see the module docstring)."""
    for part in (SMALL_TERMS, SMALL_ROWS, SPLIT, SLOTS):
        assert part in src, f"flash_variants: the source no longer holds {part!r}"
    one = src.replace(SMALL_TERMS, "").replace(SMALL_ROWS, "")
    return {"3xtf32": src, "1xtf32": one, "no split": src.replace(SPLIT, NO_SPLIT),
            "1xtf32, no split": one.replace(SPLIT, NO_SPLIT),
            "2 slots": src.replace(SLOTS, SLOTS.replace("3", "2"))}


def build(srcs: dict, out_dir: str, nvcc: str, flags) -> dict:
    """Compile every variant at once; {name: loaded library}."""
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for i, (name, src) in enumerate(srcs.items()):
        cu, so = (os.path.join(out_dir, f"v{i}{ext}") for ext in (".cu", ".so"))
        with open(cu, "w") as f:
            f.write(src)
        procs[name] = (so, subprocess.Popen([nvcc, *flags, "-o", so, cu], stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {name!r}:\n{out}")
        libs[name] = ctypes.CDLL(so)
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "flash_variants"))
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("flash_variants: no CUDA device", file=sys.stderr)
        return 1
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import attn_inputs, card, device_ms
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import flash_attention as fa
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    smi = card()
    print(smi, flush=True)
    src = (runtime.CSRC / "flash_attention.cu").read_text()
    libs = build(variants(src), os.path.join(ROOT, "build", "flash_variants"), runtime._nvcc(),
                 runtime.NVCC_FLAGS)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.attn_forward.argtypes = [p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dkv.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, f, p]
        lib.attn_backward_dq.argtypes = [p, p, p, p, p, p, p, i, i, i, i, f, p]
    dev = torch.device("cuda", 0)
    rows = []
    for shape in SHAPES:
        b, h, t, d = shape
        q, k, v, do = (x.reshape(b * h, t, d) for x in attn_inputs(shape, dev, 12, "contiguous"))
        o, lse = fa.attn_fwd(q, k, v, True)
        delta = (do * o).sum(-1)
        outs = [torch.empty_like(q) for _ in range(4)] + [torch.empty_like(lse)]
        ptr = [ctypes.c_void_p(x.data_ptr()) for x in (q, k, v, do, lse, delta, *outs)]
        stream = ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
        scale = 1.0 / math.sqrt(d)

        def calls(lib):
            return {
                "fwd": lambda: lib.attn_forward(*ptr[:3], ptr[6], ptr[10], b * h, t, d, 1, scale, stream),
                "dkv": lambda: lib.attn_backward_dkv(*ptr[:6], ptr[7], ptr[8], b * h, t, d, 1, scale, stream),
                "dq": lambda: lib.attn_backward_dq(*ptr[:6], ptr[9], b * h, t, d, 1, scale, stream),
            }

        assert calls(libs["2 slots"])["fwd"]() == 0, "2 slots fwd: launch failed"
        err = (outs[0] - o).abs().max().item()
        assert err <= 1e-4, f"2 slots fwd {shape}: |o - the port's o| {err:.3g} > 1e-4"
        times = {name: {c: [] for c in calls(lib)} for name, lib in libs.items()}
        for _ in range(args.rounds):
            for name, lib in libs.items():
                for c, fn in calls(lib).items():
                    assert fn() == 0, f"{name} {c}: launch failed"
                    times[name][c].append(device_ms(fn))
        print(f"{shape} causal, device ms (median of {args.rounds} rounds):", flush=True)
        for name, row in times.items():
            print(f"    {name:18s} " + "  ".join(f"{c} {statistics.median(ts):.4f}" for c, ts in row.items()),
                  flush=True)
        rows.append({"shape": list(shape), "ms": times})
        del q, k, v, do, o, lse, delta, outs, ptr
        torch.cuda.empty_cache()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "flash_variants.json"), "w") as f:
        json.dump({"card": smi, "rounds": args.rounds, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
