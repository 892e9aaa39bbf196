#!/usr/bin/env python3
"""Launch the port's cli as ranks on one host, one process a device, and check them.

    python3 scripts/rank_launch.py --ranks 4 [--one-card] [--device cpu] -- <cli flags>

Starts ``--ranks`` processes that join one process group (rendezvous on
``127.0.0.1:<free port>``) and run the port's cli on ``<cli flags>
--num_processes N --process_id i`` (``cli.main`` reuses the group). On a host with
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
(``chip_smoke.py`` [7]-[8], ``scripts/collective_bench.py``,
``tests/_torch_dist_helpers.py``): :func:`launch_ranks` starts any
commands as ranks and joins them; :func:`run_rank_jobs` starts ``n``
ranks once and runs several jobs in order in their one process group (each
a cli run, which reuses the group, or a call of a function), so the
processes' start-up, the rendezvous and the kernels' loading are paid once
for all of them; :func:`run_cli_ranks` runs one cli job so and returns the
ranks' reports.
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


JOBS_ENTRY = [sys.executable, "-c", "from scripts.rank_launch import rank_jobs_main; rank_jobs_main()"]


def cli_job_argv(job: dict, n: int, job_dir: str) -> List[str]:
    """A cli job's flags as its ranks run them (rank ``i`` adds
    ``--process_id i``): the job's, the process count, and its log and stat
    directories under ``job_dir``."""
    return list(job["argv"]) + ["--num_processes", str(n),
                                "--log_dir", os.path.join(job_dir, "logs"),
                                "--stat_dir", os.path.join(job_dir, "statis")]


def run_rank_jobs(jobs: Dict[str, dict], n: int, out_dir: str, timeout: float,
                  device: str = "cuda", one_card: bool = True):
    """``n`` ranks started once (one process group, rendezvous on a free
    localhost port), running ``jobs`` in order: ``{"argv": flags}`` runs
    the cli on the flags (:func:`cli_job_argv`; its directories under
    ``job["dir"]``, by default ``<out_dir>/<name>``), ``{"call":
    "module:function", "args": {...}}`` calls ``function(args, rank, n,
    device)``, which returns something JSON can hold; a job with
    ``"deterministic": true`` runs with cuDNN's deterministic algorithms
    (a run compared bit for bit with another, such as a resumed one).
    Every job starts behind a barrier with the kernels' launch counters at
    zero, the peak memory statistics reset and the card's cache emptied.
    Returns
    ``({name: [each rank's {"wall", "report" or "result"}]}, the launch's
    wall, each rank's start-up seconds)``."""
    os.makedirs(out_dir, exist_ok=True)
    spec = os.path.join(out_dir, "jobs.json")
    full = {name: (dict(job, argv=cli_job_argv(job, n, job.get("dir", os.path.join(out_dir, name))))
                   if "argv" in job else job)
            for name, job in jobs.items()}
    with open(spec, "w") as f:
        json.dump({"jobs": full, "device": device}, f)
    init = f"tcp://127.0.0.1:{free_port()}"
    outs = [os.path.join(out_dir, f"rank{i}.json") for i in range(n)]
    cmds = [JOBS_ENTRY + [spec, str(i), str(n), init, outs[i]] for i in range(n)]
    envs = [dict(os.environ, **({} if device != "cuda" or one_card
                                else {"CUDA_VISIBLE_DEVICES": str(i)})) for i in range(n)]
    wall = launch_ranks(cmds, out_dir, timeout, envs)
    ranks = []
    for path in outs:
        with open(path) as f:
            ranks.append(json.load(f))
    return ({name: [r["jobs"][name] for r in ranks] for name in jobs}, wall,
            [r["startup_s"] for r in ranks])


def rank_jobs_main() -> None:
    """One rank of :func:`run_rank_jobs`: ``argv`` is the spec, the rank,
    the process count, the rendezvous address and the output file."""
    t_enter = time.perf_counter()
    spec_path, rank, world, init, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    import gc
    import importlib

    import torch
    import torch.distributed as dist

    from dynamic_load_balance_distributeddnn_tpu_torch import cli
    from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import initialize_multihost

    with open(spec_path) as f:
        spec = json.load(f)
    device = spec["device"]
    initialize_multihost(init, world, rank)
    startup = time.perf_counter() - t_enter
    results = {}
    for name, job in spec["jobs"].items():
        gc.collect()
        if device == "cuda":
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        runtime.reset_launches()
        torch.backends.cudnn.deterministic = bool(job.get("deterministic"))
        dist.barrier()
        t0 = time.perf_counter()
        if "argv" in job:
            argv = job["argv"] + ["--process_id", str(rank)]
            cli.main(argv, device=device)
            with open(cli.rank_report_file(config_from_args(argv), rank)) as f:
                res = {"report": json.load(f)}
        else:
            module, fn = job["call"].split(":")
            res = {"result": getattr(importlib.import_module(module), fn)(
                job.get("args", {}), rank, world, device)}
        res["wall"] = time.perf_counter() - t0
        results[name] = res
    with open(out, "w") as f:
        json.dump({"jobs": results, "startup_s": startup}, f)
    dist.destroy_process_group()


def run_cli_ranks(flags: Sequence[str], n: int, out_dir: str, timeout: float,
                  device: str = "cuda", one_card: bool = True) -> Tuple[List[dict], float, List[str]]:
    """``n`` ranks of the cli on ``flags`` (:func:`run_rank_jobs`, one
    job). Returns each rank's report, the wall, and the flags as rank 0 ran
    them."""
    job = {"argv": list(flags), "dir": out_dir}
    got, wall, _ = run_rank_jobs({"run": job}, n, out_dir, timeout, device, one_card)
    return ([r["report"] for r in got["run"]], wall,
            cli_job_argv(job, n, out_dir) + ["--process_id", "0"])


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
