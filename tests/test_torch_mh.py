"""``--elastic on`` across processes on the CPU: real processes, real kills
(the JAX package's ``tests/test_multihost.py`` chaos cases, on the port).

Each run is MnistNet at ``-ws 4`` over 2 processes, 2 workers each (3
processes of one worker for the wedge), ``-b 128``, a deterministic 3:1
timing model, ``--ckpt_dir`` and 3 epochs, brought up through the port's
``rendezvous.elastic_initialize`` by ``tests/_torch_mh_worker.py`` (which
imports no JAX). The cases:

1. SIGKILL of process 1 inside epoch 1: the survivor has rc 0 and one
   loss event (2 workers, roster ``[0]``, ``lost == [2, 3]``,
   ``rdzv_gen == 1``, detection to resumed training and the kill to
   resumed training under 60 s), and its parameters' hashes, losses,
   partitions and shares at the reduced fleet equal, bit for bit, those of
   a fresh one-process 2-worker run restored from the same checkpoint with
   the survivor-restricted sidecar vectors. The run starts from the JAX
   trainer's initial weights, dropout off (``tests/test_torch_rendezvous.py``
   holds it to the JAX trajectory).
2. A wedged rendezvous over 3 processes (``DBS_MH_WEDGE``,
   ``DBS_RDZV_TIMEOUT_S=8``): the survivor exits nonzero within 200 s with
   "re-rendezvous FAILED in phase" in its log.
3. Shrink, then a respawned joiner, then regrow: both processes end with 4
   workers and the same parameters (case 1's run goes on to this: process
   1 respawns and is readmitted at epoch 3); and the same over 3 processes
   of one worker, the middle one killed (two survivors).
4. SIGSTOP: the survivor's watcher thread drops its detection marker while
   the main thread is blocked in a collective against the frozen peer.
5. ``--elastic on`` across processes through the cli's stock world
   (``initialize_multihost``): the loss is detected and the run aborts
   with the JAX package's message.
6. ``graftscope postmortem`` over case 1's spools: one merged trace with
   both processes and the survivor's ``rdzv_agree`` and
   ``rdzv_establish``.

The victim holds before its second gradient combine of epoch 1
(``DBS_MH_STEP_MARKER`` and ``DBS_MH_HOLD``) until it is killed or
stopped, so its peers are inside that step's collective when the loss
lands, however short a CPU epoch is (a loss inside the collective
checkpoint save that follows an epoch is not survived, as in the JAX
package). Every process is joined with a timeout and killed when it runs
out (``scripts/rank_launch.py``'s discipline), so a hang fails the test,
not the tier.
"""

import json
import os
import random
import shutil
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from scripts.rank_launch import free_port, launch_ranks
from tests._torch_dist_helpers import computed_once

REPO = Path(__file__).resolve().parents[1]
WORKER = REPO / "tests" / "_torch_mh_worker.py"
SEED = 7
# process 1 holds before its second combine of epoch 1 (the harness's
# DBS_MH_STEP_MARKER): its peers wait inside that step's gradient
# collective when it is killed or stopped
VICTIM_STEP = "1:1:1"
VICTIM_MARKER = "epoch1_step1_p1.marker"


def _env(tmp: Path, **extra) -> dict:
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(
        PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]),
        OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
        DBS_PEER_HB_DIR=str(tmp / "hb"), DBS_MH_CKPT=str(tmp / "ck"),
        DBS_MH_EPOCHS="3", DBS_MH_WS="4",
        DBS_PEER_HB_PERIOD_S="0.2", DBS_PEER_HB_STALE_S="3.0", DBS_RDZV_TIMEOUT_S="60",
    )
    env.update({k: str(v) for k, v in extra.items()})
    return env


def _spawn(tmp: Path, env: dict, proc: int, n: int, port: int, log: str):
    f = open(tmp / log, "w")
    p = subprocess.Popen([sys.executable, str(WORKER), str(proc), str(n), str(port)],
                         stdout=f, stderr=subprocess.STDOUT, env=env, cwd=str(REPO))
    f.close()
    return p


def _port() -> int:
    """A free port for process 0's store, below the kernel's ephemeral
    range (from 32768 by default): ``free_port``'s pick is an ephemeral
    port, which another test's connection can be handed before process 0
    listens on it."""
    rng = random.Random()
    for _ in range(100):
        port = rng.randrange(20000, 32000)
        with socket.socket() as sk:
            try:
                sk.bind(("127.0.0.1", port))
            except OSError:
                continue
        return port
    return free_port()


def _wait_for(path: Path, procs, deadline_s: float = 120.0) -> bool:
    """Whether ``path`` appears within ``deadline_s``, while every one of
    ``procs`` runs (one that ended means the run failed)."""
    deadline = time.time() + deadline_s
    while time.time() < deadline and not path.exists():
        if any(p.poll() is not None for p in procs):
            break
        time.sleep(0.05)
    return path.exists()


def _wait(p, timeout: float):
    try:
        return p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        return None  # the caller's finally kills it


def _kill_all(procs) -> None:
    for p in procs:
        if p.poll() is None:
            try:
                p.send_signal(signal.SIGCONT)
            except OSError:
                pass
            p.kill()
        p.wait()


def _result(log: Path) -> dict:
    out = log.read_text()
    lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
    assert lines, f"no RESULT line in {log}:\n{out[-4000:]}"
    return json.loads(lines[-1][len("RESULT "):])


def jax_init_weights(path: Path) -> None:
    """The JAX trainer's initial MnistNet weights at the harness's seed
    (``create_state`` at seed 7; dropout's absence changes no parameter),
    bridged to the port's names."""
    import jax.numpy as jnp
    import optax

    from dynamic_load_balance_distributeddnn_tpu.models.mnistnet import MnistNet
    from dynamic_load_balance_distributeddnn_tpu.train.state import create_state
    from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model

    state = create_state(MnistNet(num_classes=10), jnp.zeros((1, 28, 28, 1), jnp.float32),
                         optax.sgd(0.05), seed=SEED)
    torch.save(params_from_flax(state.params, build_model("mnistnet", num_classes=10,
                                                          in_channels=1)), path)


def _shrink_run(tmp: Path) -> dict:
    """Case 1's run (with its spools, for case 6), its parity leg, and case
    3's respawn and regrow over 2 processes: 4 epochs, process 1 killed
    inside epoch 1's collectives, respawned as a joiner and readmitted at
    epoch 3."""
    tmp.mkdir(parents=True, exist_ok=True)
    jax_init_weights(tmp / "init.pt")
    env = _env(tmp, DBS_MH_INIT=tmp / "init.pt", DBS_MH_EPOCHS=4, DBS_MH_JOIN_AT=3,
               DBS_MH_STEP_MARKER=VICTIM_STEP, DBS_MH_HOLD=1)
    port = _port()
    # the joiner (ident 1 too) keeps no spool: the victim's is case 6's
    procs = [_spawn(tmp, dict(env, DBS_MH_TRACE_SPOOL=tmp / "spool"), i, 2, port, f"p{i}.log")
             for i in range(2)]
    hb, ck, ckp = tmp / "hb", tmp / "ck", tmp / "ck_parity"
    try:
        assert _wait_for(hb / VICTIM_MARKER, procs), \
            "fleet never reached epoch 1:\n" + (tmp / "p0.log").read_text()[-3000:]
        procs[1].send_signal(signal.SIGKILL)
        t_kill = time.time()
        rc1 = _wait(procs[1], 30)
        resumed = _wait_for(hb / "epoch2_p0.marker", procs[:1])
        if resumed:
            # the parity leg's source, copied while the run still keeps it
            # (a checkpoint directory keeps the last 3 epochs)
            shutil.copytree(ck / "0", ckp / "0")
            shutil.copy(ck / "controller_0.json", ckp / "controller_0.json")
            procs.append(_spawn(tmp, dict(env, DBS_MH_RESPAWNED="1", DBS_MH_IDENT="1"), 1, 2,
                                port, "p1_respawn.log"))
        rc0 = _wait(procs[0], 150)
        rcj = _wait(procs[2], 30) if resumed else None
    finally:
        _kill_all(procs)
    out = {"rc0": rc0, "rc1": rc1, "rcj": rcj, "t_kill": t_kill, "dir": str(tmp),
           "log0": (tmp / "p0.log").read_text(),
           "logj": (tmp / "p1_respawn.log").read_text() if resumed else "",
           "markers": sorted(p.name for p in hb.glob("elastic_detected_*"))}
    if rc0 != 0 or rcj != 0:
        return out
    out["survivor"] = _result(tmp / "p0.log")
    out["joiner"] = _result(tmp / "p1_respawn.log")
    # the parity leg: checkpoint 0 and the survivor-restricted sidecar,
    # over the survivor's epochs 1-2 at the reduced fleet
    side = json.loads((ckp / "controller_0.json").read_text())
    out["sidecar0"] = side
    sh = [side["shares"][r] for r in (0, 1)]
    penv = _env(tmp, DBS_MH_PARITY=1, DBS_MH_CKPT=ckp, DBS_MH_INIT=tmp / "init.pt",
                DBS_MH_PARITY_UNTIL=3, DBS_MH_PARITY_VECS=json.dumps({
                    "shares": [s / sum(sh) for s in sh],
                    "node_times": [side["node_times"][r] for r in (0, 1)]}))
    launch_ranks([[sys.executable, str(WORKER), "0", "1", "0"]], str(tmp / "parity"), 120.0,
                 [penv], cwd=str(REPO))
    out["parity"] = _result(tmp / "parity" / "rank0.out")
    return out


@pytest.fixture(scope="module")
def shrink(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_mh_shrink", _shrink_run)


def test_sigkill_survivor_equals_the_fresh_reduced_run(shrink):
    assert shrink["rc1"] == -signal.SIGKILL  # the kill was real
    assert shrink["rc0"] == 0, shrink["log0"][-4000:]
    r = shrink["survivor"]
    ev, _grow = r["elastic_events"]
    assert "lost" in ev and "readmitted" not in ev
    assert ev["world_size"] == 2 and ev["roster"] == [0]
    assert ev["lost"] == [2, 3] and ev["rdzv_gen"] == 1
    assert ev["restored_from"] == "checkpoint[0]"
    assert 0.0 < ev["detect_to_resume_s"] < 60.0
    assert 0.0 < ev["resumed_unix"] - shrink["t_kill"] < 60.0  # the kill to resumed training
    assert set(ev["phase_s"]) == {"agree", "teardown", "establish", "restore"}
    assert len(r["losses"]) == 4  # epoch 1 re-ran after the recovery, recorded once
    assert r["retired_runtimes"] >= 1  # the gen-0 group was retired
    # the watcher thread's marker: diagnosis survives even when the
    # collective's own failure was the first signal
    assert shrink["markers"] == ["elastic_detected_proc1_by_proc0.json"]
    # bit for bit against the fresh reduced run from checkpoint 0, over the
    # epochs at the reduced fleet
    p = shrink["parity"]
    assert p["start_epoch"] == 1
    assert p["hashes"] == {k: r["hashes"][k] for k in ("1", "2")}
    assert p["losses"] == r["losses"][1:3]
    assert p["partitions"] == r["partitions"][1:3]
    assert p["shares"] == r["shares_after"]["2"]


def test_postmortem_merges_the_victim_and_the_survivor(shrink):
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.scope_cli import postmortem
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.spool import read_spool

    assert shrink["rc0"] == 0, shrink["log0"][-4000:]
    spool_dir = Path(shrink["dir"]) / "spool"
    spools = {p.name.split(".")[0]: p for p in spool_dir.glob("*.spool")}
    assert set(spools) == {"proc0", "proc1"}, sorted(spool_dir.iterdir())
    victim = read_spool(str(spools["proc1"]))
    assert victim["meta"]["ident"] == 1
    assert [e for _, seg in victim["segments"] for e in seg], "the victim's spool is empty"
    out = spool_dir.parent / "postmortem.trace.json"
    report = json.loads(postmortem(str(spool_dir), out=str(out), as_json=True))
    merged = json.loads(out.read_text())["traceEvents"]
    pids = {e.get("pid") for e in merged if e.get("ph") != "M"}
    assert len(pids) == 2, "the merged trace keeps both processes' tracks"
    names = {e["name"] for e in merged}
    assert {"rdzv_agree", "rdzv_establish", "recover_mh", "rdzv_agreed"} <= names
    assert "peer_lost" in names and "peer_stale" in names
    victim_pid = int(victim["meta"]["pid"])
    surv = next(info for pid, info in report["processes"].items() if int(pid) != victim_pid)
    assert {"rdzv_agree", "rdzv_establish"} <= {s["name"] for s in surv["recovery_spans"]}


def test_wedged_rendezvous_exits_nonzero_within_its_bound(tmp_path):
    env = _env(tmp_path, DBS_MH_WS=3, DBS_MH_WEDGE=1, DBS_RDZV_TIMEOUT_S=8,
               DBS_MH_STEP_MARKER="2:1:1", DBS_MH_HOLD=1)
    port = _port()
    procs = [_spawn(tmp_path, env, i, 3, port, f"p{i}.log") for i in range(3)]
    try:
        assert _wait_for(tmp_path / "hb" / "epoch1_step1_p2.marker", procs), \
            "fleet never reached epoch 1"
        procs[2].send_signal(signal.SIGKILL)
        t0 = time.time()
        rc0 = _wait(procs[0], 200)
        wall = time.time() - t0
    finally:
        _kill_all(procs)
    out0 = (tmp_path / "p0.log").read_text()
    assert rc0 not in (None, 0), f"rc={rc0}:\n{out0[-4000:]}"
    assert wall < 200.0
    assert "re-rendezvous FAILED in phase" in out0, out0[-4000:]
    assert "degrading to abort-and-resume" in out0


# (processes, workers, the ranks of the killed process 1, extra settings):
# two processes of 2 workers (the JAX harness's case, asserted on case 1's
# run), and three of one worker with the middle one killed, where two
# survivors vote the rebuild, train as a 2-process world and decide the
# grow together; a survivor blocked in a collective with the other survivor
# waits out the group's timeout (12 s here) before it reaches the rendezvous
REGROW = {"2procs": (2, 4, [2, 3], {}), "3procs": (3, 3, [1], {"DBS_RDZV_TIMEOUT_S": 12})}


def _regrow_run(tmp: Path, n: int, ws: int, extra: dict) -> list:
    """Shrink, respawn and regrow over ``n`` processes; every process's
    ``(log name, rc)``, the survivors first, the joiner last."""
    env = _env(tmp, DBS_MH_EPOCHS=4, DBS_MH_JOIN_AT=3, DBS_MH_WS=ws,
               DBS_MH_STEP_MARKER=VICTIM_STEP, DBS_MH_HOLD=1, **extra)
    port = _port()
    procs = [_spawn(tmp, env, i, n, port, f"p{i}.log") for i in range(n)]
    hb = tmp / "hb"
    try:
        assert _wait_for(hb / VICTIM_MARKER, procs), "fleet never reached epoch 1"
        procs[1].send_signal(signal.SIGKILL)
        assert _wait_for(hb / "epoch2_p0.marker", procs[:1]), "the survivor never resumed"
        procs.append(_spawn(tmp, dict(env, DBS_MH_RESPAWNED="1", DBS_MH_IDENT="1"), 1, n,
                            port, "p1_respawn.log"))
        rcs = [_wait(p, 150) for p in procs[:1] + procs[2:]]
    finally:
        _kill_all(procs)
    logs = ["p0.log"] + [f"p{i}.log" for i in range(2, n)] + ["p1_respawn.log"]
    return list(zip(logs, rcs))


@pytest.mark.parametrize("case", sorted(REGROW))
def test_shrink_then_a_respawned_joiner_regrows_the_fleet(request, tmp_path, case):
    n, ws, ranks1, extra = REGROW[case]
    if case == "2procs":
        shrink = request.getfixturevalue("shrink")
        assert shrink["rc0"] == 0, shrink["log0"][-4000:]
        assert shrink["rcj"] == 0, shrink["logj"][-4000:]
        res = [shrink["survivor"], shrink["joiner"]]
    else:
        got = _regrow_run(tmp_path, n, ws, extra)
        for log, rc in got:
            assert rc == 0, (log, (tmp_path / log).read_text()[-4000:])
        res = [_result(tmp_path / log) for log, _ in got]
    r0, rj = res[0], res[-1]
    for r in res:
        assert r["world_size"] == ws and r["n_proc"] == n and r["roster"] == list(range(n))
        assert r["params_hash"] == r0["params_hash"] and r["shares"] == r0["shares"]
    for r in res[:-1]:  # the survivors: the shrink, then the grow
        kinds = [("lost" in ev, "readmitted" in ev) for ev in r["elastic_events"]]
        assert kinds == [(True, False), (False, True)], r["elastic_events"]
        shrink_ev, grow = r["elastic_events"]
        assert shrink_ev["lost"] == ranks1 and shrink_ev["rdzv_gen"] == 1
        assert grow["readmitted"] == ranks1 and grow["rdzv_gen"] == 2 and grow["epoch"] == 3
        assert r["losses"] == r0["losses"]
    assert rj["losses"] == r0["losses"][-len(rj["losses"]):]


def test_sigstop_is_detected_while_the_survivor_is_blocked(tmp_path):
    env = _env(tmp_path, DBS_MH_EPOCHS=50, DBS_MH_STEP_MARKER=VICTIM_STEP, DBS_MH_HOLD=1)
    port = _port()
    procs = [_spawn(tmp_path, env, i, 2, port, f"p{i}.log") for i in range(2)]
    hb = tmp_path / "hb"
    marker = hb / "elastic_detected_proc1_by_proc0.json"
    try:
        assert _wait_for(hb / VICTIM_MARKER, procs), "fleet never reached epoch 1"
        procs[1].send_signal(signal.SIGSTOP)  # the preemption freeze
        t0 = time.time()
        assert _wait_for(marker, procs[:1], 60), "the survivor never detected the frozen peer"
        detected_s = time.time() - t0
        log0 = (tmp_path / "p0.log").read_text()
        blocked = procs[0].poll() is None and "dispatch failed" not in log0
        info = json.loads(marker.read_text())
    finally:
        _kill_all(procs)
    assert info["peer"] == "proc1" and "stale" in info["reason"]
    assert detected_s < 30.0
    # the main thread is still inside the collective against the frozen peer
    # (it fails only at the group's 60 s timeout); the watcher thread spoke
    assert blocked, log0[-3000:]


def test_cli_stock_world_detects_the_loss_and_aborts(tmp_path):
    """The cli's ``initialize_multihost`` world has no rendezvous channel:
    with the beacons armed (``DBS_PEER_HB_DIR``) the loss of process 1 is
    detected, and the run aborts with the JAX package's message."""
    port = _port()
    env = _env(tmp_path)
    argv = ["-m", "mnistnet", "-ds", "mnist", "-ws", "4", "-b", "64", "-gpu", "0,0,0,0",
            "-e", "50", "--n_train", "512", "-d", "true", "--elastic", "on",
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
            "--log_dir", str(tmp_path / "logs"), "--stat_dir", str(tmp_path / "statis")]
    code = ("import sys, torch; torch.set_num_threads(1); "
            "from dynamic_load_balance_distributeddnn_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:], device='cpu'))")
    procs = []
    for i in range(2):
        with open(tmp_path / f"c{i}.log", "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, *argv, "--process_id", str(i)], stdout=f,
                stderr=subprocess.STDOUT, env=env, cwd=str(REPO)))
    try:
        assert _wait_for(tmp_path / "hb" / "proc1.hb", procs) and \
            _wait_for(tmp_path / "hb" / "proc0.hb", procs), "the beacons never armed"
        time.sleep(1.0)
        procs[1].send_signal(signal.SIGKILL)
        rc0 = _wait(procs[0], 90)
    finally:
        _kill_all(procs)
    out0 = (tmp_path / "c0.log").read_text()
    assert rc0 not in (None, 0), out0[-4000:]
    assert "lost but no rendezvous channel is armed" in out0, out0[-4000:]
    assert "set DBS_PEER_HB_DIR and bring the world up through " \
           "rendezvous.elastic_initialize" in out0
