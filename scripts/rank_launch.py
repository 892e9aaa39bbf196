#!/usr/bin/env python3
"""Launch the port's cli as ranks on one host, one process a device, and check them.

    python3 scripts/rank_launch.py --ranks 4 [--one-card] [--device cpu] -- <cli flags>

Starts ``--ranks`` processes of ``python -m
dynamic_load_balance_distributeddnn_tpu_torch.cli <cli flags> --coordinator
127.0.0.1:<free port> --num_processes N --process_id i``. On a host with
several cards each rank sees only its own (``CUDA_VISIBLE_DEVICES=i``, so
its ``cuda:0``; pass ``-gpu 0,0,...`` in the flags), and ``parallel/mesh.py``
picks NCCL; ``--one-card`` puts every rank on the one visible card (gloo,
as ``chip_smoke.py`` [7]); ``--device cpu`` runs the ranks on the CPU
(gloo). The ranks are joined with ``--timeout`` seconds and all killed,
their logs printed, when one fails or the time runs out. Each rank writes
its report beside the run's statistics (``cli.rank_report_file``); the
script checks that every rank ran the same backend and ends with the same
parameters (their SHA-256), and prints each rank's backend, collective
walls, launches and peak memory, beside the card's name and power limit.
Reports and logs go to ``--out`` (default ``chiprun_out/rank_launch``).

The module is also the one launcher of the repo's other rank harnesses
(``chip_smoke.py`` [7], ``scripts/collective_bench.py``,
``tests/_torch_dist_helpers.py``): :func:`launch_ranks` starts any
commands as ranks and joins them, :func:`run_cli_ranks` runs the cli so
and returns the ranks' reports.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI = [sys.executable, "-m", "dynamic_load_balance_distributeddnn_tpu_torch.cli"]
CLI_CPU = [sys.executable, "-c", "import sys; from dynamic_load_balance_distributeddnn_tpu_torch "
           "import cli; sys.exit(cli.main(sys.argv[1:], device='cpu'))"]


class RanksFailed(RuntimeError):
    """A rank failed or the ranks outlived their time; the message holds
    the end of every rank's output."""


def free_port() -> int:
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def launch_ranks(cmds: Sequence[Sequence[str]], out_dir: str, timeout: float,
                 envs: Optional[Sequence[Dict[str, str]]] = None, cwd: str = ROOT) -> float:
    """Start one process a command (rank ``i`` runs ``cmds[i]`` with the
    environment ``envs[i]``, default this one's), its output in
    ``<out_dir>/rank<i>.out``; join them within ``timeout`` seconds. When a
    rank fails or the time runs out, kill every rank and raise
    :class:`RanksFailed` with the end of each one's output. Returns the
    wall from the first start to the last exit."""
    os.makedirs(out_dir, exist_ok=True)
    procs, logs = [], []
    t0 = time.monotonic()
    failed = None
    try:
        for i, cmd in enumerate(cmds):
            logs.append(open(os.path.join(out_dir, f"rank{i}.out"), "w"))
            procs.append(subprocess.Popen(list(cmd), cwd=cwd, env=None if envs is None else envs[i],
                                          stdout=logs[-1], stderr=subprocess.STDOUT))
        while any(p.poll() is None for p in procs):
            if time.monotonic() - t0 > timeout:
                failed = f"a rank outlived {timeout:.0f}s"
                break
            if any(p.poll() not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in logs:
            f.close()
    wall = time.monotonic() - t0
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        tails = []
        for i, p in enumerate(procs):
            with open(os.path.join(out_dir, f"rank{i}.out")) as f:
                tails.append(f"--- rank {i} (rc {p.returncode}) ---\n{f.read()[-6000:]}")
        raise RanksFailed(f"{len(cmds)} ranks: {failed}\n" + "\n".join(tails))
    return wall


def run_cli_ranks(flags: Sequence[str], n: int, out_dir: str, timeout: float,
                  device: str = "cuda", one_card: bool = True) -> Tuple[List[dict], float, List[str]]:
    """``n`` processes of the cli on ``flags`` (plus the rendezvous on a
    free localhost port and the log and stat directories under
    ``out_dir``), joined by :func:`launch_ranks`. Returns each rank's
    report, the wall, and the flags as rank 0 ran them."""
    from dynamic_load_balance_distributeddnn_tpu_torch.cli import rank_report_file
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args

    full = list(flags) + ["--coordinator", f"127.0.0.1:{free_port()}", "--num_processes", str(n),
                          "--log_dir", os.path.join(out_dir, "logs"),
                          "--stat_dir", os.path.join(out_dir, "statis")]
    argvs = [full + ["--process_id", str(i)] for i in range(n)]
    entry = CLI if device == "cuda" else CLI_CPU
    envs = [dict(os.environ, **({} if device != "cuda" or one_card
                                else {"CUDA_VISIBLE_DEVICES": str(i)})) for i in range(n)]
    wall = launch_ranks([entry + a for a in argvs], out_dir, timeout, envs)
    reports = []
    for i, a in enumerate(argvs):
        with open(rank_report_file(config_from_args(a), i)) as f:
            reports.append(json.load(f))
    return reports, wall, argvs[0]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--one-card", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "rank_launch"))
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    args = ap.parse_args()
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    shutil.rmtree(args.out, ignore_errors=True)
    if args.device == "cuda":
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=60).stdout
        print(out.strip(), flush=True)
    try:
        reports, wall, _ = run_cli_ranks(flags, args.ranks, args.out, args.timeout, args.device,
                                         args.one_card)
    except RanksFailed as e:
        print(e)
        print("rank_launch: the ranks failed", file=sys.stderr)
        return 1
    backends = {r["ranks"]["backend"] for r in reports}
    digests = {r["param_sha256"] for r in reports}
    print(f"{args.ranks} ranks in {wall:.1f}s (start-up included); backend "
          f"{sorted(backends)}; paths {reports[0]['paths']}")
    s = reports[0]["series"]
    wc = s["wallclock_time"]
    print(f"epoch walls {[round(b - a, 3) for a, b in zip([0.0] + wc, wc)]} s; train loss "
          f"{[round(x, 4) for x in s['train_loss']]}; partition {s['partition']}; sync_time "
          f"{s['sync_time']}; comm_bytes_ici {s['comm_bytes_ici']}")
    for r in reports:
        coll = [(c["epoch"], round(1e3 * c["mean_s"], 3), round(1e3 * c["max_s"], 3))
                for c in r["collective"] or []]
        peak = "" if r["peak_bytes"] is None else f"; peak {r['peak_bytes'] / 2**30:.2f} GiB"
        print(f"rank {r['rank']} on {r['device']}: collective wall a step (epoch, mean ms, max "
              f"ms) {coll}; K1 {r['launches']['groupnorm_fwd']}+{r['launches']['groupnorm_bwd']}, "
              f"K2 {r['launches']['xent_fwd']}+{r['launches']['xent_bwd']} launches{peak}")
    if len(backends) != 1 or len(digests) != 1:
        print(f"rank_launch: the ranks disagree: backends {backends}, digests {digests}",
              file=sys.stderr)
        return 1
    print(json.dumps({"ranks": args.ranks, "backend": backends.pop(), "equal_parameters": True}))
    return 0


if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    sys.exit(main())
