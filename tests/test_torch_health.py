"""The port's copies of the JAX package's per-worker health
(``runtime/health.py``) and preemption injector (``faults.py``
``PreemptionInjector``), held to the originals.

Each case below is the JAX package's own (``tests/test_elastic.py``): the
verdict machine's two-strike confirmation, its reset on a signal, its
RECOVERING state, the latency verdict that liveness rounds do not clear,
the retry armor's backoff and re-raise, the heartbeat beacon, scan, exit
tag and watcher, the seeded random schedule, and real signal delivery
(SIGSTOP/SIGCONT, SIGKILL, a respawn). Each runs with the same inputs on
both packages' copies, which must give the same verdicts, snapshots and
schedules, and the verdicts the JAX test asserts. Beyond them: the
injector's virtual schedule (``down_workers``, ``rejoining``,
``epoch_faults`` over a straggler ``base``) over a grid of times, equal in
both packages. The JAX cases of its rendezvous (``reset_rendezvous_dir``,
the probe exchange) have no copy here: the port's elastic tier across
processes is not written yet.
"""

import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu import faults as jax_faults
from dynamic_load_balance_distributeddnn_tpu.runtime import health as jax_health
from dynamic_load_balance_distributeddnn_tpu.runtime import watchdog as jax_watchdog
from dynamic_load_balance_distributeddnn_tpu_torch import faults
from dynamic_load_balance_distributeddnn_tpu_torch.runtime import health

BOTH = [(jax_health, jax_faults), (health, faults)]


def _both(scenario):
    """``scenario(health module, faults module)`` on both packages: the
    two results, asserted equal; returns the port's."""
    got = [scenario(h, f) for h, f in BOTH]
    assert got[0] == got[1]
    return got[1]


# ------------------------------------------------------- WorkerHealth units


def test_health_two_strike_confirmation():
    def run(h, _):
        w = h.WorkerHealth(3, detect_misses=2)
        out = [w.report_miss(1), w.status(1), w.report_miss(1), w.status(1), w.lost(),
               w.alive_count()]
        return out

    assert _both(run) == [False, health.SUSPECT, True, health.LOST, [1], 2]


def test_health_alive_resets_misses():
    def run(h, _):
        w = h.WorkerHealth(2, detect_misses=2)
        w.report_miss(0)
        w.report_alive(0)
        return [w.report_miss(0), w.status(0), w.snapshot()]

    got = _both(run)
    assert got[:2] == [False, health.SUSPECT]


def test_health_lost_worker_signalling_is_recovering():
    def run(h, _):
        w = h.WorkerHealth(2, detect_misses=1)
        w.report_miss(0)
        out = [w.status(0)]
        w.report_alive(0)
        out += [w.status(0), w.recovering()]
        w.readmit(0)
        return out + [w.status(0), w.snapshot()]

    assert _both(run)[:4] == [health.LOST, health.RECOVERING, [0], "alive"]


def test_health_latency_outlier_is_suspect():
    def run(h, _):
        w = h.WorkerHealth(4, latency_factor=8.0)
        for r in range(3):
            w.observe_latency(r, 0.01)
        w.observe_latency(3, 1.0)
        return [w.status(3), w.snapshot()]

    status, snap = _both(run)
    assert status == health.SUSPECT and snap["alive"] == 4 and snap["status"][3] == health.SUSPECT


def test_latency_suspect_survives_liveness_rounds():
    def run(h, _):
        w = h.WorkerHealth(4, latency_factor=8.0)
        for r in range(3):
            w.observe_latency(r, 0.01)
        w.observe_latency(3, 1.0)
        out = [w.status(3)]
        w.report_alive(3)
        out.append(w.status(3))
        for _ in range(5):
            w.observe_latency(3, 0.01)
            out.append(w.status(3))
        return out + [w.snapshot()]

    got = _both(run)
    assert got[:2] == [health.SUSPECT, health.SUSPECT] and got[-2] == "alive"


def test_mark_down_and_readmit_match():
    def run(h, _):
        w = h.WorkerHealth(4, detect_misses=3, latency_factor=2.0)
        w.observe_latency(1, 0.5)
        w.mark_down(2)
        out = [w.snapshot(), w.report_miss(2), w.lost()]
        w.report_alive(2)
        out.append(w.recovering())
        w.readmit(2)
        return out + [w.snapshot()]

    _both(run)


def test_retry_transient_backs_off_then_succeeds():
    def run(h, _):
        calls, ticks = {"n": 0}, {"n": 0}

        def flaky():
            calls["n"] += 1
            if calls["n"] < 3:
                raise OSError("transient")
            return "ok"

        out = h.retry_transient(flaky, retries=3, base_s=0.001,
                                tick=lambda: ticks.__setitem__("n", ticks["n"] + 1))
        return [out, calls["n"], ticks["n"]]

    assert _both(run) == ["ok", 3, 2]


def test_retry_transient_reraises_after_budget():
    def run(h, _):
        calls = {"n": 0}

        def always():
            calls["n"] += 1
            raise ValueError("real")

        with pytest.raises(ValueError):
            h.retry_transient(always, retries=2, base_s=0.001)
        return calls["n"]

    assert _both(run) == 3


def test_worker_lost_carries_sorted_ranks():
    def run(h, _):
        e = h.WorkerLost([3, 1])
        return [e.ranks, str(e)]

    assert _both(run)[0] == [1, 3]


# --------------------------------------------------- ProcessHeartbeat units


def test_process_heartbeat_beacon_and_scan(tmp_path):
    for h, _ in BOTH:
        d = tmp_path / h.__name__.split(".")[0]
        hb = h.ProcessHeartbeat(period_s=0.05)
        try:
            hb.beacon(str(d), "proc0")
            time.sleep(0.2)
            scan = h.ProcessHeartbeat.scan(str(d))
            assert set(scan) == {"proc0"}
            assert scan["proc0"]["age_s"] < 5.0 and scan["proc0"]["exit_reason"] is None
        finally:
            hb.stop()


def test_process_heartbeat_reads_watchdog_exit_tag(tmp_path):
    """The port reads the tag the JAX package's stall watchdog writes (its
    abort path tags the peer beacons too), as the JAX scan does."""
    path = tmp_path / "proc1.hb"
    path.write_text("")
    jax_watchdog.tag_exit_reason(str(path), "stall: no heartbeat for 900s; exit_code=19")
    scans = [h.ProcessHeartbeat.scan(str(tmp_path)) for h, _ in BOTH]
    assert scans[0]["proc1"]["exit_reason"] == scans[1]["proc1"]["exit_reason"]
    assert scans[1]["proc1"]["exit_reason"].startswith("stall")
    assert health.read_exit_reason(str(path)) == jax_watchdog.read_exit_reason(str(path))
    for h, _ in BOTH:
        info = scans[1]["proc1"]
        assert h.ProcessHeartbeat.is_stale(info, stale_s=1e9)
        assert h.ProcessHeartbeat.stale_reason(info).startswith("stall")


def test_process_heartbeat_watch_fires_on_stale(tmp_path):
    (tmp_path / "peer.hb").write_text("")
    os.utime(tmp_path / "peer.hb", (time.time() - 60, time.time() - 60))
    for h, _ in BOTH:
        hb = h.ProcessHeartbeat(period_s=0.05)
        fired = []
        try:
            hb.watch(str(tmp_path), ["peer"], stale_s=5.0,
                     on_stale=lambda i, info: fired.append(i))
            deadline = time.time() + 3
            while not fired and time.time() < deadline:
                time.sleep(0.05)
        finally:
            hb.stop()
        assert fired == ["peer"]


# ------------------------------------------------------ PreemptionInjector


def _events(f, spec):
    return [f.PreemptionEvent(worker=w, down_at=d, rejoin_epoch=r, kind=k) for w, d, r, k in spec]


def test_seeded_random_preemption_schedule_is_reproducible():
    def run(_, f):
        scheds = []
        for seed in (11, 11, 12):
            inj = f.PreemptionInjector(4, chance=0.4, seed=seed)
            for e in range(6):
                inj._roll(e)
                inj._roll(e)  # idempotent: a re-run epoch does not re-roll
            scheds.append([(ev.worker, ev.down_at, ev.rejoin_epoch, ev.kind)
                           for ev in inj.schedule()])
        return scheds

    a, b, c = _both(run)
    assert a == b and a and c != a


@pytest.mark.parametrize("chance", [0.0, 0.3])
def test_virtual_schedule_and_faults_equal_the_jax_injector(chance):
    """``down_workers`` and ``rejoining`` on a grid of epoch-times, and
    ``epoch_faults`` over a virtual 3:1 straggler ``base``, with a downed
    worker's load zeroed, for an explicit schedule and a seeded random
    one."""
    spec = [(3, 1.4, 3, "kill"), (1, 0.5, None, "suspend"), (2, 2.25, 4, "kill")]

    def run(_, f):
        base = f.StaticStragglerInjector([3.0, 1.0, 1.0, 1.0], mode="compute")
        inj = f.PreemptionInjector(4, _events(f, spec), chance=chance, seed=5, base=base)
        ctx = f.FaultContext(batch_sizes=np.array([64.0, 128.0, 96.0, 32.0]), iter_cost_s=1e-5,
                             per_example_cost_s=np.array([1e-3, 2e-3, 1e-3, 5e-4]))
        out = []
        for e in range(6):
            fa = inj.epoch_faults(e, 10, ctx)
            out.append([fa.virtual_seconds.tolist(), fa.slow_iters_per_step.tolist(),
                        fa.time_multipliers.tolist(), sorted(inj.rejoining(e))])
            out.append([sorted(inj.down_workers(e + k / 8)) for k in range(8)])
        return out

    got = _both(run)
    assert 1 not in got[1][3] and 1 in got[1][4]  # worker 1 down from t = 0.5 on


def test_event_checks_raise_as_the_jax_ones():
    for f in (jax_faults, faults):
        with pytest.raises(ValueError, match="kind"):
            f.PreemptionEvent(worker=0, down_at=1.0, kind="pause")
        with pytest.raises(ValueError, match="rejoin_epoch"):
            f.PreemptionEvent(worker=0, down_at=2.0, rejoin_epoch=2)
        with pytest.raises(ValueError, match="out of range"):
            f.PreemptionInjector(2, [f.PreemptionEvent(worker=2, down_at=0.5)])


# --------------------------------------------- real-process delivery

_SLEEPER = "import time\nwhile True: time.sleep(0.2)\n"


def test_preemption_injector_real_suspend_rejoin_delivery():
    """SIGSTOP at the suspend edge, SIGCONT at the rejoin edge, against a
    live child process, by each package's injector in turn."""
    for f in (jax_faults, faults):
        proc = subprocess.Popen([sys.executable, "-c", _SLEEPER])
        try:
            inj = f.PreemptionInjector(2, _events(f, [(1, 1.0, 2, "suspend")]))
            inj.attach_process(1, proc.pid)
            assert inj.deliver(0.5) == []
            assert inj.deliver(1.5) == [(1, "SIGSTOP")]
            assert inj.deliver(1.6) == []  # delivered once
            assert inj.deliver(2.0) == [(1, "SIGCONT")]
            assert proc.poll() is None
        finally:
            proc.kill()
            proc.wait()


def test_preemption_injector_real_kill_delivery():
    for f in (jax_faults, faults):
        proc = subprocess.Popen([sys.executable, "-c", _SLEEPER])
        inj = f.PreemptionInjector(1, _events(f, [(0, 0.0, None, "kill")]))
        inj.attach_process(0, proc.pid)
        assert inj.deliver(0.5) == [(0, "SIGKILL")]
        assert proc.wait(timeout=10) == -signal.SIGKILL


def test_preemption_injector_kill_respawn_roundtrip():
    """A killed process's rejoin edge calls the attached respawn once, and
    the new pid is attached for later signals, in both packages."""
    for f in (jax_faults, faults):
        proc = subprocess.Popen([sys.executable, "-c", _SLEEPER])
        spawned = []
        try:
            inj = f.PreemptionInjector(2, _events(f, [(1, 1.0, 3, "kill")]))
            inj.attach_process(1, proc.pid)

            def spawn():
                spawned.append(subprocess.Popen([sys.executable, "-c", _SLEEPER]))
                return spawned[-1]

            inj.attach_respawn(1, spawn)
            assert inj.deliver(1.5) == [(1, "SIGKILL")]
            assert proc.wait(timeout=10) == -signal.SIGKILL
            assert inj.deliver(2.0) == [] and spawned == []
            assert inj.deliver(3.2) == [(1, "RESPAWN")] and len(spawned) == 1
            assert spawned[0].poll() is None
            assert inj.deliver(3.5) == [] and len(spawned) == 1
            assert inj._pids[1] == spawned[0].pid
        finally:
            for p in [proc] + spawned:
                try:
                    p.kill()
                    p.wait(timeout=10)
                except (OSError, ProcessLookupError):
                    pass


def test_os_kill_is_the_one_signal_seam(monkeypatch):
    """Delivery goes through ``os_kill`` (the tests' seam), as in the JAX
    package: patched, no real pid is signalled."""
    sent = []
    monkeypatch.setattr(faults, "os_kill", lambda pid, sig: sent.append((pid, sig)))
    inj = faults.PreemptionInjector(1, _events(faults, [(0, 0.0, 1, "suspend")]))
    inj.attach_process(0, 999999)
    assert inj.deliver(1.0) == [(0, "SIGSTOP"), (0, "SIGCONT")]
    assert sent == [(999999, signal.SIGSTOP), (999999, signal.SIGCONT)]
