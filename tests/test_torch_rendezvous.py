"""The elastic tier across processes against the JAX package: the copied
host code gives the JAX copies' results on the same inputs, and the
port's shrink run follows the JAX trajectory.

- ``RendezvousStateMachine``: both copies run the same scripted directory
  sequences, threads standing in for processes, one temporary directory a
  package (agreement over the survivors, a proposal round that converges
  when a member drops out, claimed losses, join offers, the probe
  exchange, rebuild votes, the ack adoption, the reset of a reused
  directory, and timeouts). The agreements, the file names and every JSON
  payload are equal. The coordinator's port is pinned on both sides (it is
  the one random pick of the protocol).
- The stall watchdog: the JAX package's ``tests/test_watchdog.py`` cases
  on both copies (the child processes import each package's module).
- ``_adopt_controller_vectors``: both trainers' methods on equal sidecars
  and rosters, shrink and grow, give the same vectors bit for bit.
- The shrink run: the JAX package's own rendezvous cannot run here (its
  runtime half calls ``jax._src.lib.xla_extension`` and the coordination
  service's ``heartbeat_interval`` argument, both gone from the installed
  jax 0.9, so ``tests/_mh_worker.py``'s ``DBS_MH_RDZV`` mode exits 17 at
  bring-up). Its harness's shrink test holds the survivor to a fresh
  reduced run from checkpoint 0 bit for bit, so the JAX trajectory of that
  run is computed as that test defines it: the JAX trainer on 4 workers
  for epoch 0 and checkpoint 0, then a fresh 2-worker JAX trainer restored
  from it with the survivor-restricted sidecar vectors for epochs 1-2
  (the harness's config, MnistNet with its dropout left out, the same
  initial weights). The roster, generation and lost ranks come from the
  JAX state machine driven through the same shrink. The port's run
  (``tests/test_torch_mh.py`` case 1) matches: roster, ``world_size``,
  ``lost``, ``rdzv_gen``, the partitions and shares of epochs 0-2 exactly
  (that run then regrows), the losses within rtol 1e-5
  (``tests/test_torch_dist_engine.py``'s tolerance).
- Restoring across processes (``Trainer._own_rank_state``): the row of the
  process's ident, the residual rows loaded only at the saving fleet and
  held to their shapes, a joiner's own states kept with a warning, and any
  other process the save does not hold refused.
"""

import dataclasses
import json
import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

import dynamic_load_balance_distributeddnn_tpu.runtime.rendezvous as jax_rdzv
import dynamic_load_balance_distributeddnn_tpu.runtime.watchdog as jax_watchdog
import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
import dynamic_load_balance_distributeddnn_tpu_torch.runtime.rendezvous as rdzv
import dynamic_load_balance_distributeddnn_tpu_torch.runtime.watchdog as watchdog
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.combine import RankCombine
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_dist_helpers import computed_once
from tests.test_torch_mh import _shrink_run

REPO = Path(__file__).resolve().parents[1]
BOTH = [pytest.param(jax_rdzv, id="jax"), pytest.param(rdzv, id="port")]
LOSS_RTOL = 1e-5


# ---------------------------------------------------- the state machine


def _snapshot(d: Path) -> dict:
    """Every protocol file under ``d``: its name and its JSON payload (None
    for a marker)."""
    out = {}
    for p in sorted(d.iterdir()):
        if p.suffix == ".json":
            out[p.name] = json.loads(p.read_text())
        elif not p.name.endswith(".hb"):
            out[p.name] = None
    return out


def _threads(fns):
    """Run ``fns`` (one a process) on threads; each one's result or
    exception, in order."""
    out = [None] * len(fns)

    def run(i, fn):
        try:
            out[i] = ("ok", fn())
        except Exception as e:  # noqa: BLE001 — compared across packages
            out[i] = ("err", type(e).__name__, getattr(e, "phase", None))

    ts = [threading.Thread(target=run, args=(i, fn)) for i, fn in enumerate(fns)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(30)
    return out


def _script(mod, d: Path, monkeypatch) -> dict:
    """One scripted sequence of protocol moves over ``d``; returns what it
    observed. ``_pick_port`` is pinned to 40000 + the caller's ident."""
    d.mkdir()
    local = threading.local()
    monkeypatch.setattr(mod, "_pick_port", lambda: 40000 + local.ident)
    obs = {}
    sm = {p: mod.RendezvousStateMachine(str(d), p) for p in range(4)}
    # the gen-0 ack a world's coordinator publishes, then a reused
    # directory's stale files wiped by the reset
    mod._write_json(str(d / "ack_g0.json"), {"address": "localhost:1", "roster": [0, 1, 2],
                                             "epoch": 0, "payload": {}})
    obs["roster0"] = sm[1].current_roster()
    (d / "torn_g7_p0").write_text("")
    mod._write_json(str(d / "loss_g7_p0.json"), {"dead": [1], "epoch": 3})
    obs["reset_removed"] = mod.reset_rendezvous_dir(str(d))
    mod._write_json(str(d / "ack_g0.json"), {"address": "localhost:1", "roster": [0, 1, 2],
                                             "epoch": 0, "payload": {}})
    for p in range(3):
        sm[p].current_roster()
    # process 2 is lost: 0 claims it, 1 adopts the claim, both agree
    sm[0].claim_loss([2], epoch=1)
    obs["claimed_by_1"] = sorted(sm[1].claimed_losses())

    def agree(p, alive, timeout=5.0):
        def fn():
            local.ident = p
            return dataclasses.asdict(
                sm[p].agree(lambda: set(alive()), epoch=1 + p, timeout_s=timeout))
        return fn

    obs["shrink"] = _threads([agree(0, lambda: {0, 1}), agree(1, lambda: {0, 1})])
    # a round that converges: 3 starts from a stale view holding 1, whom
    # it then sees drop out
    for p in (0, 3):
        sm[p].gen = 1
    seen = {"n": 0}

    def alive3():
        seen["n"] += 1
        return {0, 1, 3} if seen["n"] == 1 else {0, 3}

    obs["converge"] = _threads([agree(0, lambda: {0, 3}), agree(3, alive3)])
    # a join offer, seen and cleared
    sm[2].offer_join()
    obs["joins"] = sorted(sm[0].pending_joins())
    obs["after_offer"] = sorted(_snapshot(d))
    sm[0].clear_join(2)
    obs["joins_after_clear"] = sorted(sm[0].pending_joins())
    # the grow's probe exchange over [0, 3]; 1 never publishes
    for p in (0, 3):
        sm[p].gen = 2
    sm[0].publish_probe({0: 0.25, 1: 0.5})
    sm[3].publish_probe({6: 1.0, 7: 2.0})
    obs["probes"] = sm[0].collect_probes([0, 3], timeout_s=1.0)
    obs["probes_missing"] = sm[0].collect_probes([0, 1, 3], timeout_s=0.2)
    # rebuild votes: a round stands only when every survivor's stood
    sm[0].rebuild_vote(0, ok=True)
    sm[3].rebuild_vote(0, ok=True)
    sm[0].rebuild_vote(1, ok=True)
    sm[3].rebuild_vote(1, ok=False)
    obs["settled0"] = sm[0].rebuild_settled([0, 3], 0, timeout_s=1.0)
    obs["settled1"] = sm[3].rebuild_settled([0, 3], 1, timeout_s=1.0)
    obs["vote_timeout"] = _threads([lambda: sm[0].rebuild_settled([0, 1], 0, timeout_s=0.2)])
    # a proposal whose peer never answers times out, naming the phase
    local.ident = 0
    obs["agree_timeout"] = _threads([agree(0, lambda: {0, 1}, timeout=0.3)])
    # the newest ack is adopted with its generation
    mod._write_json(str(d / "ack_g5.json"), {"address": "localhost:9", "roster": [0, 3],
                                             "epoch": 4, "payload": {"active": [0, 1]}})
    obs["roster5"] = sm[2].current_roster()
    obs["gen_after_adopt"] = sm[2].gen
    obs["files"] = _snapshot(d)
    return obs


def test_state_machine_gives_the_jax_results_on_the_same_script(tmp_path, monkeypatch):
    got = _script(rdzv, tmp_path / "port", monkeypatch)
    want = _script(jax_rdzv, tmp_path / "jax", monkeypatch)
    assert got == want
    # the script exercised what it claims to
    assert want["shrink"][0] == ("ok", {"gen": 1, "roster": (0, 1), "rank": 0,
                                        "address": "localhost:40000", "epoch": 2})
    assert want["shrink"][1][1]["rank"] == 1
    assert want["converge"][0][1]["roster"] == (0, 3) and want["converge"][0][1]["gen"] == 2
    assert want["agree_timeout"] == [("err", "RendezvousTimeout", "propose[r0] waiting for "
                                      "proc(s) [1]")]
    assert want["vote_timeout"] == [("err", "RendezvousTimeout", "rebuild-vote[0]")]
    assert want["probes"] == {0: 0.25, 1: 0.5, 6: 1.0, 7: 2.0} and want["probes_missing"] is None
    assert (want["settled0"], want["settled1"]) == (True, False)
    assert want["reset_removed"] == 3 and want["roster5"] == [0, 3]


@pytest.mark.parametrize("mod", BOTH)
def test_alive_procs_reads_the_beacons_as_the_jax_copy(tmp_path, mod):
    for name, age in (("proc0", 0), ("proc1", 0), ("proc2", 60), ("proc3", 0)):
        (tmp_path / f"{name}.hb").write_text("")
        os.utime(tmp_path / f"{name}.hb", (time.time() - age, time.time() - age))
    jax_watchdog.tag_exit_reason(str(tmp_path / "proc3.hb"), "rendezvous failed: propose")
    sm = mod.RendezvousStateMachine(str(tmp_path), 4)
    assert sm.alive_procs(stale_s=10.0) == {0, 1, 4}


def test_the_protocol_table_is_the_jax_one():
    assert rdzv.PROTOCOL == jax_rdzv.PROTOCOL
    assert rdzv.rendezvous_timeout_s() == jax_rdzv.rendezvous_timeout_s()


# ---------------------------------------------------------- the watchdog


WATCHDOGS = [pytest.param("dynamic_load_balance_distributeddnn_tpu.runtime.watchdog", id="jax"),
             pytest.param("dynamic_load_balance_distributeddnn_tpu_torch.runtime.watchdog",
                          id="port")]


def _watchdog(name):
    return jax_watchdog if name.startswith("dynamic_load_balance_distributeddnn_tpu.") \
        else watchdog


@pytest.mark.parametrize("name", WATCHDOGS)
def test_watchdog_heartbeat_noop_and_touch(tmp_path, monkeypatch, name):
    w = _watchdog(name)
    monkeypatch.delenv("DBS_HEARTBEAT_FILE", raising=False)
    w.heartbeat()  # must not raise or create anything
    hb = tmp_path / "hb"
    monkeypatch.setenv("DBS_HEARTBEAT_FILE", str(hb))
    w.heartbeat()
    assert hb.exists()


@pytest.mark.parametrize("name", WATCHDOGS)
def test_watchdog_arm_creates_missing_parent(tmp_path, monkeypatch, name):
    w = _watchdog(name)
    monkeypatch.delenv("DBS_HEARTBEAT_FILE", raising=False)
    hb = tmp_path / "not" / "yet" / "there" / "hb"
    t = w.arm_stall_watchdog(str(hb), stall_s=10_000, poll_s=10_000)
    assert t.daemon and hb.exists()
    assert os.environ["DBS_HEARTBEAT_FILE"] == str(hb)


@pytest.mark.parametrize("name", WATCHDOGS)
def test_watchdog_exit_tags_match(tmp_path, name):
    """The tag either copy writes, on its own file and every registered
    beacon, reads back through both copies."""
    w = _watchdog(name)
    hb, peer = tmp_path / "hb", tmp_path / "proc1.hb"
    hb.write_text("")
    peer.write_text("")
    w.register_exit_tag_path(str(peer))
    try:
        w.tag_exit_all(str(hb), "stall: no heartbeat for 1s; exit_code=19")
    finally:
        w.unregister_exit_tag_path(str(peer))
    for p in (hb, peer):
        assert watchdog.read_exit_reason(str(p)) == jax_watchdog.read_exit_reason(str(p)) == \
            "stall: no heartbeat for 1s; exit_code=19"
    assert watchdog.read_exit_reason(str(tmp_path / "absent")) is None


_CHILD = r"""
import importlib, sys, time
w = importlib.import_module(sys.argv[1])
mode, hb = sys.argv[2], sys.argv[3]
if mode == "grace":
    w.arm_stall_watchdog(hb, stall_s=0.6, poll_s=0.1, exit_code=19, first_grace_s=6.0)
    time.sleep(2.0)   # > stall_s, inside grace -> must survive
    w.heartbeat()     # the device answered once: grace over
    time.sleep(30)    # > stall_s with no heartbeat -> must fire now
    sys.exit(0)
w.arm_stall_watchdog(hb, stall_s=1.0, poll_s=0.2, exit_code=19, first_grace_s=1.0)
if mode == "alive":
    for _ in range(10):
        time.sleep(0.3)
        w.heartbeat()
    sys.exit(0)
time.sleep(30)  # "hang": no heartbeats -> the watchdog must fire
sys.exit(0)
"""


def _run_child(name: str, mode: str, hb: str):
    return subprocess.run([sys.executable, "-c", _CHILD, name, mode, hb], timeout=30,
                          env={**os.environ, "PYTHONPATH": str(REPO)}, capture_output=True)


@pytest.mark.parametrize("name", WATCHDOGS)
@pytest.mark.parametrize("mode,rc", [("hang", 19), ("alive", 0), ("uncreatable", 19)])
def test_watchdog_child_exits_as_the_jax_cases(tmp_path, name, mode, rc):
    hb = tmp_path / "hb"
    if mode == "uncreatable":  # the parent is a FILE: the watchdog fails closed
        (tmp_path / "f").write_text("x")
        hb = tmp_path / "f" / "hb"
    proc = _run_child(name, "alive" if mode == "alive" else "hang", str(hb))
    assert proc.returncode == rc, proc.stderr[-2000:]
    if rc == 19:
        assert b"[watchdog] stall: no heartbeat" in proc.stderr


@pytest.mark.parametrize("name", WATCHDOGS)
def test_watchdog_first_grace_then_tightens(tmp_path, name):
    t0 = time.time()
    proc = _run_child(name, "grace", str(tmp_path / "hb"))
    elapsed = time.time() - t0
    assert proc.returncode == 19
    assert 1.9 < elapsed < 8.0, f"fired at {elapsed:.1f}s"


# ---------------------------------------------- the controller's re-seeding


class _Fleet:
    def __init__(self, active):
        self.active_ranks = list(active)
        self.world_size = len(active)


ADOPT = {
    "shrink": ([0, 1, 2, 3], [0, 1], [0.1, 0.3, 0.3, 0.3], [3.0, 1.0, 1.0, 1.0], None),
    "grow": ([0, 1], [0, 1, 2, 3], [0.25, 0.75], [0.384, 0.384], [1e-3, 3e-3]),
    "grow_cost": ([0, 1], [0, 1, 2, 3], [0.4, 0.6], [2.0, 1.5], [1e-3, np.nan]),
    "reorder": ([2, 3], [0, 1, 2, 3], [0.5, 0.5], [1.0, 2.0], [0.5, 0.25]),
    "short": ([0, 1, 2], [0, 1, 2], [0.5, 0.5], [1.0, 1.0], None),
}


@pytest.mark.parametrize("case", sorted(ADOPT))
def test_adopt_controller_vectors_equals_the_jax_trainer(case):
    base, active, shares, times, cost = ADOPT[case]
    out = []
    for cls in (JaxTrainer, Trainer):
        f = _Fleet(active)
        cls._adopt_controller_vectors(f, base, shares, times, cost)
        out.append((f.shares, f.node_times, f.per_example_cost))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)
    assert abs(out[1][0].sum() - 1.0) < 1e-12


# ------------------------------------------------------------- the shrink


def _jax_shrink(tmp: Path) -> dict:
    """The JAX trajectory of the harness's shrink run (module docstring)."""
    import jax

    from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
    from dynamic_load_balance_distributeddnn_tpu.data.datasets import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
    from dynamic_load_balance_distributeddnn_tpu.train.checkpoint import flush_checkpoints
    from tests.test_torch_online_dbs import _MnistNetNoDropout

    tmp.mkdir(parents=True, exist_ok=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))

    def timing(holder, factors):
        def tm(plan):
            f = np.asarray(factors)[np.asarray(holder["tr"].active_ranks)]
            return f * np.array([w.batch_size * w.steps * 1e-3 for w in plan.workers])
        return tm

    kw = dict(debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=3,
              dataset="mnist", model="mnistnet", dynamic_batch_size=True, bucket=8,
              stream_chunk_steps=2, elastic="on", ckpt_dir=str(tmp / "jck"), seed=7,
              log_dir=str(tmp / "logs"), stat_dir=str(tmp / "statis"))
    try:
        holder = {}
        tr4 = JaxTrainer(JaxConfig(**kw), bundle=synthetic_dataset("mnist", n_train=512,
                                                                   n_test=128),
                         timing_model=timing(holder, [3.0, 1.0, 1.0, 1.0]), log_to_file=False)
        holder["tr"] = tr4
        init = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tr4.state.params)
        tr4._run_epoch_elastic_world(0)
        tr4._save_checkpoint(0)
        flush_checkpoints(kw["ckpt_dir"], close=True)
        side = json.loads((tmp / "jck" / "controller_0.json").read_text())
        sh = [side["shares"][r] for r in (0, 1)]
        h2 = {}
        tr2 = JaxTrainer(JaxConfig(**dict(kw, world_size=2, elastic="off")),
                         bundle=synthetic_dataset("mnist", n_train=512, n_test=128),
                         timing_model=timing(h2, [3.0, 1.0]), log_to_file=False)
        h2["tr"] = tr2
        start = tr2._maybe_restore()
        tr2.shares = np.asarray([s / sum(sh) for s in sh], dtype=np.float64)
        tr2.node_times = np.asarray([side["node_times"][r] for r in (0, 1)], dtype=np.float64)
        for e in range(start, 3):
            tr2.run_epoch(e)
        flush_checkpoints(close=True)
    finally:
        mp.undo()
    return {
        "init": init, "start": start,
        "losses": [float(v) for v in tr4.recorder.data["train_loss"]]
        + [float(v) for v in tr2.recorder.data["train_loss"]],
        "partitions": [list(map(float, p)) for p in tr4.recorder.data["partition"]]
        + [list(map(float, p)) for p in tr2.recorder.data["partition"]],
        "shares": [float(s) for s in tr2.shares],
    }


def _jax_protocol_shrink(tmp: Path) -> dict:
    """The JAX state machine through the shrink the harness drives: a
    2-process gen-0 world, process 1 claimed lost at epoch 1, the survivor
    agreeing alone."""
    tmp.mkdir(parents=True, exist_ok=True)
    jax_rdzv._write_json(str(tmp / "ack_g0.json"), {"address": "localhost:1", "roster": [0, 1],
                                                     "epoch": 0, "payload": {}})
    sm = jax_rdzv.RendezvousStateMachine(str(tmp), 0)
    roster0 = sm.current_roster()
    sm.claim_loss([1], epoch=1)
    ag = sm.agree(lambda: {0, 1} - sm.claimed_losses(), epoch=1, timeout_s=5.0)
    wsp = 4 // len(roster0)
    return {"roster": list(ag.roster), "rdzv_gen": ag.gen,
            "lost": [r for r in range(4) if r // wsp not in ag.roster],
            "world_size": sum(1 for r in range(4) if r // wsp in ag.roster)}


@pytest.fixture(scope="module")
def shrink(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_mh_shrink", _shrink_run)


@pytest.fixture(scope="module")
def jax_shrink(tmp_path_factory):
    return computed_once(tmp_path_factory, "torch_mh_jax_shrink", _jax_shrink)


def test_shrink_run_follows_the_jax_trajectory(shrink, jax_shrink, tmp_path):
    import torch

    from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model

    assert shrink["rc0"] == 0, shrink["log0"][-4000:]
    r = shrink["survivor"]
    # the same initial weights on both sides
    init = torch.load(Path(shrink["dir"]) / "init.pt", weights_only=True)
    want_init = params_from_flax(jax_shrink["init"], build_model("mnistnet", num_classes=10,
                                                                  in_channels=1))
    assert all(torch.equal(init[k], want_init[k]) for k in want_init)
    proto = _jax_protocol_shrink(tmp_path / "jax_rdzv")
    ev = r["elastic_events"][0]  # the shrink (the run regrows at epoch 3)
    assert ev["roster"] == proto["roster"] == [0]
    assert ev["world_size"] == proto["world_size"] == 2
    assert ev["lost"] == proto["lost"] == [2, 3]
    assert ev["rdzv_gen"] == proto["rdzv_gen"] == 1
    assert jax_shrink["start"] == 1
    assert r["partitions"][:3] == jax_shrink["partitions"]
    assert r["shares_after"]["2"] == jax_shrink["shares"]
    np.testing.assert_allclose(r["losses"][:3], jax_shrink["losses"], rtol=LOSS_RTOL)


# ------------------------------------------------ the port's runtime half


def test_a_teardown_that_hangs_times_out_bounded(monkeypatch):
    """``retire_runtime`` drops the data axis's groups, then waits for the
    default group's teardown at most its bound: a teardown that never
    returns raises ``RendezvousTimeout`` (phase ``teardown``), which the
    engine degrades to an abort."""
    import torch.distributed as dist

    retired = []

    class Mesh:
        def retire(self):
            retired.append(True)

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "destroy_process_group", lambda *a, **k: time.sleep(30))
    n = rdzv.retired_count()
    t0 = time.monotonic()
    with pytest.raises(rdzv.RendezvousTimeout) as e:
        rdzv.retire_runtime(Mesh(), timeout_s=0.3)
    assert e.value.phase == "teardown" and time.monotonic() - t0 < 5.0
    assert retired == [True] and rdzv.retired_count() == n + 1  # the group held, not freed
    del rdzv._RETIRED[n:]


def test_no_elastic_world_without_a_group_and_a_sound_cpu_canary():
    assert not rdzv.elastic_world()
    assert rdzv.drain_collective_chain("cpu", timeout_s=0.1)
    rdzv.local_canary_launch("cpu")
    rdzv.quarantine_runtime("cpu")


def test_collective_failure_is_re_raised_without_the_beacons():
    """No beacon armed (one process, or no ``DBS_PEER_HB_DIR``): a
    collective's failure is no fleet change; the caller re-raises it."""

    class Stub:
        cfg = type("C", (), {"elastic": "on"})()
        n_proc, _hb_beacon = 2, None

    assert Trainer._attribute_collective_failure(Stub(), RuntimeError("x"), 0) is None


# ------------------------------------------- restoring a process's own state


class _Rows:
    """``RankCombine``'s residual surface: ``n`` ranks, this one ``rank``,
    one residual a hop of the given widths."""

    load_residual_rows = RankCombine.load_residual_rows
    axes = ()

    def __init__(self, n, rank, widths):
        import torch

        self.n, self.mesh = n, type("M", (), {"rank": rank})()
        self.residuals = [torch.full((w,), -1.0) for w in widths]


def _own_state(ident, roster, joiner=False, rows=None):
    """``Trainer._own_rank_state`` on a stub process ``ident`` of the live
    ``roster``; returns (the generators it takes, its residuals, the
    warnings, whether it rebased the residuals at zero)."""
    log, zeroed = [], []

    class Stub:
        _orig_proc_id, _proc_roster = ident, list(roster)
        proc_id, n_proc = list(roster).index(ident), len(roster)
        _rank_combine = rows
        cfg = type("C", (), {"ckpt_dir": "ck"})()
        logger = type("L", (), {"warning": staticmethod(log.append)})()

        def _fix_comm_residual(self):
            zeroed.append(True)

    def run(state):
        gens = Trainer._own_rank_state(Stub(), state, state["generators"], joiner)
        return gens, [r.tolist() for r in rows.residuals] if rows else None, log, bool(zeroed)

    return run


def _save(idents=None, n=None, width=2):
    """A checkpoint's state from a world of ``idents`` (or of ``n`` ranks
    with no idents, or of one process when both are None)."""
    import torch

    k = len(idents) if idents is not None else n
    if k is None:
        return {"generators": {"g": "writer"}}
    ranks = {"generators": [{"g": f"row{i}"} for i in range(k)],
             "residuals": [torch.arange(k * width, dtype=torch.float32).view(k, width)]}
    if idents is not None:
        ranks["idents"] = list(idents)
    return {"generators": {"g": "writer"}, "ranks": ranks}


OWN_STATE = {
    # the saving fleet is the live one: the ident's row, residuals loaded
    "same_fleet": (dict(ident=2, roster=[0, 2]), _save([0, 2]),
                   ({"g": "row1"}, [[2.0, 3.0]], False, False)),
    # a survivor of another fleet: its ident's row, residuals rebased at zero
    "survivor": (dict(ident=2, roster=[0, 2]), _save([0, 1, 2]),
                 ({"g": "row2"}, [[-1.0, -1.0]], False, True)),
    # the ranks of a world that kept no idents, at the same size
    "by_rank": (dict(ident=1, roster=[0, 1]), _save(n=2), ({"g": "row1"}, [[2.0, 3.0]], False,
                                                          False)),
    # a world of one process saved it: rank 0 takes the writer's states
    "writer": (dict(ident=0, roster=[0, 1]), _save(), ({"g": "writer"}, [[-1.0, -1.0]], False,
                                                       True)),
    # a joiner the reduced fleet's save does not hold keeps its own states
    "joiner": (dict(ident=1, roster=[0, 1], joiner=True), _save(),
               ({}, [[-1.0, -1.0]], True, True)),
    "joiner_of_two": (dict(ident=1, roster=[0, 1, 2], joiner=True), _save([0, 2]),
                      ({}, [[-1.0, -1.0]], True, True)),
    # refused: a process the save does not hold that is no joiner, a save
    # of another rank count with no idents, residuals of another shape at
    # the saving fleet
    "not_a_joiner": (dict(ident=1, roster=[0, 1]), _save(), "resume with the ranks"),
    "other_count": (dict(ident=0, roster=[0, 1]), _save(n=3), "resume with the ranks"),
    "misfit_rows": (dict(ident=0, roster=[0, 1]), _save([0, 1], width=3), "do not fit"),
}


@pytest.mark.parametrize("case", sorted(OWN_STATE))
def test_own_rank_state_takes_the_idents_row_or_refuses(case):
    who, state, want = OWN_STATE[case]
    rows = _Rows(len(who["roster"]), who["roster"].index(who["ident"]), [2])
    run = _own_state(rows=rows, **who)
    if isinstance(want, str):
        with pytest.raises(ValueError, match=want):
            run(state)
        return
    gens, residuals, log, zeroed = run(state)
    assert (gens, residuals, bool(log), zeroed) == want, log
    if log:
        assert "keeps its own generator states" in log[0]
