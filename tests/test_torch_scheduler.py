"""The port's many-stream engine (``runtime/scheduler.py``) against the JAX
package's, on the CPU.

The pool allocator, the outer inverse-time solve, its modeled gain and its
decision journal are copies, so the port's outputs must EQUAL the JAX
module's on the same inputs (seeded sequences included). A sole tenant
through the engine is the port's own ``Trainer.run()`` bit for bit, and
follows the JAX engine's sole tenant (the partitions equal, the losses
within ``LOSS_RTOL``, the weights carried over by the bridge). The JAX
whole-scenario migration test aborts on this host (its compile-service
threads), so the port's heavy/light migration is held to the JAX
``_outer_counts`` at every window instead. Two tenants running at once in
threads equal their runs alone bit for bit: no process-wide state (the
tracer, the launch counters, the generators, the logger) leaks between
them. The shared state the tenants touch (the launch counters, a capture's
per-key counts, the kernel libraries' load) is exercised from several
threads.
"""

import sys
import threading
import time

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.faults import (
    StaticStragglerInjector as JaxStraggler,
)
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.runtime import scheduler as jsched
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.faults import StaticStragglerInjector
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.obs.scope_cli import main as scope_main
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import (
    attribution_by_job,
    configure as configure_tracer,
    get_tracer,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.runtime import scheduler as sched
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import CAPTURE_GATE, StepGraphs
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

LOSS_RTOL = 1e-5  # tests/test_torch_engine.py's trainers: f32 sums in another order


def linear_time(plan):
    return np.array([w.padded_batch * w.steps * 1e-3 for w in plan.workers])


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset("mnist", n_train=1024, n_test=256)


def _kw(**kw):
    base = dict(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=3,
        dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=1234, bucket=8,
    )
    base.update(kw)
    return base


def _cfg(tmp=None, tag="run", **kw):
    if tmp is not None:
        kw.setdefault("stat_dir", str(tmp / tag / "statis"))
        kw.setdefault("log_dir", str(tmp / tag / "logs"))
    return Config(**_kw(**kw))


def _engine(**kw):
    return sched.MultiStreamEngine(device="cpu", **kw)


def _params(tr):
    return [p.detach().clone() for p in tr.params]


# ------------------------------------------------------------- device pool


def _pool_ops(pool_cls, ops):
    """Run ``ops`` on a fresh pool: each op's result or (exception type
    name, message), with the allocation and the free ordinals after it."""
    out = []
    pool = None
    for op, *arg in ops:
        try:
            if op == "init":
                pool = pool_cls(*arg)
                got = pool.n_devices
            elif op == "reallocate":
                got = pool.reallocate(*arg)
            elif op == "release":
                got = pool.release(*arg)
            elif op == "begin":
                got = pool.begin_window()
            elif op == "end":
                got = pool.end_window()
            elif op == "devices_of":
                got = pool.devices_of(*arg)
        except (ValueError, RuntimeError) as e:
            got = (type(e).__name__, str(e))
        state = None if pool is None else (pool.allocation(), pool.free_devices())
        out.append((op, got, state))
    return out


def _random_pool_ops(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(1, 9))
    jobs = ["a", "b", "c", "d"]
    ops = [("init", n)]
    for _ in range(12):
        r = rng.random()
        if r < 0.6:
            k = int(rng.integers(1, 5))
            picked = rng.choice(jobs, size=k, replace=False)
            counts = {str(j): int(rng.integers(-1 if rng.random() < 0.1 else 0, n + 1))
                      for j in picked}
            ops.append(("reallocate", counts))
        elif r < 0.75:
            ops.append(("release", str(rng.choice(jobs))))
        elif r < 0.85:
            ops.append(("begin",))
        elif r < 0.95:
            ops.append(("end",))
        else:
            ops.append(("devices_of", str(rng.choice(jobs))))
    return ops


POOL_CASES = {
    # tests/test_scheduler.py's sequences
    "minimal_movement": [("init", 8), ("reallocate", {"a": 4, "b": 4}),
                         ("reallocate", {"a": 2, "b": 6})],
    "release_and_free": [("init", 4), ("reallocate", {"a": 2, "b": 2}), ("release", "a"),
                         ("devices_of", "a"), ("devices_of", "b")],
    "overcommit_and_negative": [("init", 4), ("reallocate", {"a": 3, "b": 2}),
                                ("reallocate", {"a": -1})],
    "window_quiesce": [("init", 4), ("reallocate", {"a": 4}), ("begin",),
                       ("reallocate", {"a": 2}), ("release", "a"), ("end",),
                       ("reallocate", {"a": 2})],
    "empty_pool": [("init", 0)],
    "eviction": [("init", 6), ("reallocate", {"a": 2, "b": 2, "c": 2}),
                 ("reallocate", {"c": 3, "a": 1})],
}
POOL_CASES.update({f"random_{s}": _random_pool_ops(s) for s in range(20)})


@pytest.mark.parametrize("case", sorted(POOL_CASES))
def test_pool_equals_the_jax_pool(case):
    ops = POOL_CASES[case]
    assert _pool_ops(sched.DevicePool, ops) == _pool_ops(jsched.DevicePool, ops)


# ------------------------------------------------------------- outer solve


def _jax_fake(job_id, wall=None, devices=(), **spec_kw):
    js = jsched.JobState(jsched.JobSpec(job_id, JaxConfig(**_kw()), **spec_kw))
    js.wall_ema = wall
    js.devices = tuple(devices)
    return js


def _port_fake(job_id, wall=None, devices=(), **spec_kw):
    """The port twin of tests/test_scheduler.py's ``_fake_job``."""
    js = sched.JobState(sched.JobSpec(job_id, Config(**_kw()), **spec_kw))
    js.wall_ema = wall
    js.devices = tuple(devices)
    return js


def _random_jobs(seed):
    rng = np.random.default_rng(100 + seed)
    P = int(rng.integers(2, 9))
    n = int(rng.integers(1, P + 1))
    free = list(rng.permutation(P))
    jobs = []
    for i in range(n):
        k = int(rng.integers(0, 3)) if free else 0
        devs, free = sorted(int(d) for d in free[:k]), free[k:]
        wall = None if rng.random() < 0.2 else float(rng.uniform(0.1, 20.0))
        cap = None if rng.random() < 0.6 else int(rng.integers(1, P + 1))
        jobs.append((f"j{i}", wall, tuple(devs), {"max_devices": cap}))
    return P, jobs


OUTER_CASES = {
    "inverse_time": (8, [("slow", 6.0, (0, 1, 2, 3), {}), ("fast", 2.0, (4, 5, 6, 7), {})]),
    "every_tenant_keeps_one": (4, [("whale", 1000.0, (0, 1, 2), {}),
                                   ("minnow", 0.001, (3,), {})]),
    "median_seed": (8, [("known", 2.0, (0, 1, 2, 3), {}), ("fresh", None, (), {})]),
    "max_devices_redistributes": (8, [("capped", 6.0, (0, 1, 2, 3), {"max_devices": 3}),
                                      ("other", 2.0, (4, 5, 6, 7), {})]),
    "max_devices_idles": (8, [("solo", 1.0, (0,), {"max_devices": 2})]),
    "too_many_jobs": (2, [("j0", None, (), {}), ("j1", None, (), {}), ("j2", None, (), {})]),
}
OUTER_CASES.update({f"random_{s}": _random_jobs(s) for s in range(12)})


def _outer(engine, fake, P, jobs):
    eng = engine(n_devices=P)
    live = [fake(j, w, d, **kw) for j, w, d, kw in jobs]
    try:
        counts = eng._outer_counts(live)
    except RuntimeError as e:
        return ("RuntimeError", str(e))
    return counts, eng._modeled_gain(live, counts)


@pytest.mark.parametrize("case", sorted(OUTER_CASES))
def test_outer_counts_and_gain_equal_the_jax_solve(case):
    P, jobs = OUTER_CASES[case]
    got = _outer(_engine, _port_fake, P, jobs)
    assert got == _outer(jsched.MultiStreamEngine, _jax_fake, P, jobs)
    if case == "inverse_time":
        assert got[0] == {"slow": 6, "fast": 2}  # the slower tenant gets more slots
    if case == "median_seed":
        assert got[0] == {"known": 4, "fresh": 4} and got[1] is None
    if case == "too_many_jobs":
        assert "exceed" in got[1]


def _three_verdicts(eng, fake):
    """tests/test_replaylab.py's three verdicts: migrate, same counts,
    budget exhausted."""
    slow = fake("slow", wall=6.0, devices=(0, 1, 2, 3))
    fast = fake("fast", wall=2.0, devices=(4, 5, 6, 7))
    eng._solve_and_actuate([slow, fast], membership_changed=False)
    slow.devices, fast.devices = (0, 1, 2, 3, 4, 5), (6, 7)
    slow.wall_ema, fast.wall_ema = 4.0, 4.0
    eng._solve_and_actuate([slow, fast], membership_changed=False)
    eng._migrations_spent = eng.migration_budget
    fast.wall_ema = 60.0
    eng._solve_and_actuate([slow, fast], membership_changed=False)


def _unmeasured_hold(eng, fake):
    """A fresh tenant beside a measured one: the median seed proposes 4:4
    against 3:5, and the gain model has no wall to stand on."""
    known = fake("known", wall=2.0, devices=(0, 1, 2))
    fresh = fake("fresh", devices=(3, 4, 5, 6, 7))
    eng._solve_and_actuate([known, fresh], membership_changed=False)


JOURNALS = {"three_verdicts": (_three_verdicts, ["migrate", "same-counts", "budget-exhausted"]),
            "unmeasured_hold": (_unmeasured_hold, ["unmeasured-hold"])}


def _journal(engine, fake, case):
    eng = engine(n_devices=8)
    eng._apply_allotment = lambda js, ords: None  # no live trainers
    JOURNALS[case][0](eng, fake)
    return eng


@pytest.mark.parametrize("case", sorted(JOURNALS))
def test_outer_journal_equals_the_jax_journal(tmp_path, case):
    """The journal field by field and ``snapshot()`` equal the JAX
    engine's; the verdicts are mirrored as ``pool_decision`` instants that
    ``scope_cli decisions`` renders, and the registry's ``scheduler``
    section counts the evaluations."""
    configure_tracer("on")
    try:
        eng = _journal(_engine, _port_fake, case)
        evs = [e for e in get_tracer().events() if e[1] == "decision" and e[0] == "pool_decision"]
        path = get_tracer().save(str(tmp_path / "pool.trace.json"))
    finally:
        configure_tracer("off")
    want = _journal(jsched.MultiStreamEngine, _jax_fake, case)
    got_j, want_j = eng.decision_journal(), want.decision_journal()
    reasons = JOURNALS[case][1]
    assert [e["reason"] for e in got_j] == reasons
    assert len(got_j) == len(want_j)
    for g, w in zip(got_j, want_j):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k] == w[k], (k, g, w)
    assert eng.snapshot(include_journal=True) == want.snapshot(include_journal=True)
    assert len(evs) == len(reasons)
    assert eng.obs.snapshot()["scheduler"]["evals"] == len(reasons)
    assert scope_main(["decisions", path]) == 0


# ------------------------------------------------------------- a sole tenant


class _MnistNetNoDropout(fnn.Module):
    """The JAX package's MnistNet with its two dropouts left out (the same
    parameters, so the weights bridge to the port's)."""

    num_classes: int = 10

    @fnn.compact
    def __call__(self, x, train: bool = False):
        x = fnn.relu(fnn.max_pool(fnn.Conv(10, (5, 5), padding="VALID")(x), (2, 2), strides=(2, 2)))
        x = fnn.relu(fnn.max_pool(fnn.Conv(20, (5, 5), padding="VALID")(x), (2, 2), strides=(2, 2)))
        x = fnn.relu(fnn.Dense(50)(x.reshape(x.shape[0], -1)))
        return fnn.Dense(self.num_classes)(x)


# the elastic path, whose losses the port's tests hold to the JAX trainer's
# within LOSS_RTOL; a packed step sums the workers in another order
# (tests/test_torch_packed.py holds a packed run's partitions only)
PACKED = "off"


def _solo_spec(cls, cfg, bundle, injector):
    return cls("solo", cfg, bundle=bundle, injector=injector, timing_model=linear_time)


@pytest.fixture(scope="module")
def jax_solo(tmp_path_factory):
    """The JAX engine's sole tenant (3:1 straggler, ``linear_time``, 3
    epochs, dropout off) and its initial weights."""
    tmp = tmp_path_factory.mktemp("jax_solo")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    init = {}

    class Engine(jsched.MultiStreamEngine):
        def _admit(self, js):
            super()._admit(js)
            init["params"] = jax.device_get(js.trainer.state.params)

    try:
        eng = Engine(n_devices=1)
        js = eng.submit(_solo_spec(
            jsched.JobSpec, JaxConfig(**_kw(device=0, packed=PACKED, stat_dir=str(tmp / "statis"))),
            jax_synthetic("mnist", n_train=1024, n_test=256),
            JaxStraggler([3.0, 1.0, 1.0, 1.0], mode="virtual")))
        eng.run()
    finally:
        mp.undo()
    assert js.status == "done"
    return js.recorder.data, init["params"]


def _no_dropout(tr, init):
    tr.model.load_state_dict(params_from_flax(init, tr.model))
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0


def test_sole_tenant_equals_the_trainer_run_bit_for_bit(bundle, tmp_path):
    inj = lambda: StaticStragglerInjector([3.0, 1.0, 1.0, 1.0], mode="virtual")  # noqa: E731
    legacy = Trainer(_cfg(tmp_path, "legacy", device=0), bundle=bundle, injector=inj(),
                     timing_model=linear_time, device="cpu", log_to_file=False)
    rec = legacy.run()
    eng = _engine(n_devices=1)
    js = eng.submit(_solo_spec(sched.JobSpec, _cfg(tmp_path, "ms", device=0), bundle, inj()))
    eng.run()
    assert js.status == "done" and js.migrations == 0 and js.epochs_done == 3
    assert rec.data["train_loss"] == js.recorder.data["train_loss"]
    assert rec.data["partition"] == js.recorder.data["partition"]
    assert rec.data["partition"][-1][0] < 0.25  # share moved off the straggler
    for a, b in zip(legacy.params, js.trainer.params):
        assert torch.equal(a, b)


def test_sole_tenant_follows_the_jax_engine(bundle, tmp_path, jax_solo):
    want, init = jax_solo

    class Engine(sched.MultiStreamEngine):
        def _admit(self, js):
            super()._admit(js)  # the worker is parked until the first window
            _no_dropout(js.trainer, init)

    eng = Engine(n_devices=1, device="cpu")
    js = eng.submit(_solo_spec(sched.JobSpec, _cfg(tmp_path, "ms", device=0, packed=PACKED),
                               bundle, StaticStragglerInjector([3.0, 1.0, 1.0, 1.0],
                                                               mode="virtual")))
    eng.run()
    got = js.recorder.data
    assert got["partition"] == want["partition"]
    np.testing.assert_allclose(got["train_loss"], want["train_loss"], rtol=LOSS_RTOL, atol=0)


# ------------------------------------------------------------------ admission


def test_admission_adds_no_step_key_in_the_steady_window(bundle, tmp_path):
    """tests/test_scheduler.py's admission test: B admitted at window 1
    beside A; window 2 prepares no new step key in either tenant (the
    port's form of zero foreground compiles), A's slots never move, and
    the shared trace attributes 3 and 2 epochs to the tenants after B's
    admission (a tenant trainer leaves the process tracer alone)."""
    configure_tracer("on")
    try:
        common = dict(world_size=2, dynamic_batch_size=False, batch_size=64, epoch_size=4)
        eng = _engine(n_devices=8)
        js_a = eng.submit(sched.JobSpec("a", _cfg(tmp_path, "a", **common), bundle=bundle,
                                        epochs=3, max_devices=2, slots=(0, 1)))
        js_b = eng.submit(sched.JobSpec("b", _cfg(tmp_path, "b", seed=77, **common),
                                        bundle=bundle, epochs=2, max_devices=2, slots=(2, 3)))
        eng._admit(js_a)
        eng._solve_and_actuate([js_a], membership_changed=True)
        eng._run_window([js_a])
        eng._window += 1
        eng._admit(js_b)
        eng._solve_and_actuate([js_a, js_b], membership_changed=True)
        dev_a = js_a.devices
        eng._run_window([js_a, js_b])
        eng._window += 1
        keys = [js.trainer.supersteps.superstep_cache_size() for js in (js_a, js_b)]
        eng._run_window([js_a, js_b])
        eng._window += 1
        assert [js.trainer.supersteps.superstep_cache_size() for js in (js_a, js_b)] == keys
        assert min(keys) > 0
        assert js_a.devices == dev_a == (0, 1) and js_b.devices == (2, 3)
        assert js_a.migrations == 0 and js_b.migrations == 0
        assert js_a.status == "finishing" and js_b.status == "finishing"
        eng._retire([js_a, js_b])
        assert js_a.status == "done" and js_b.status == "done"
        assert js_a.epochs_done == 3 and js_b.epochs_done == 2
        att = attribution_by_job(get_tracer().chrome_events())
    finally:
        configure_tracer("off")
    assert att["jobs"]["a"]["epochs"] == 3, att["jobs"]
    assert att["jobs"]["b"]["epochs"] == 2, att["jobs"]


# ------------------------------------------------------------------ migration


def test_heavy_tenant_takes_slots_and_each_window_solves_as_jax(bundle, tmp_path):
    """tests/test_scheduler.py's heavy/light scenario: 3:1 modeled demand
    over an 8-slot pool ends 6:2 after at least one migration of each
    tenant, and both finish; every outer solve proposes what the JAX
    ``_outer_counts`` returns for the same wall EMAs and footprints."""
    demand = {"heavy": 24.0, "light": 8.0}
    solves = []

    class Engine(sched.MultiStreamEngine):
        def _outer_counts(self, live):
            out = super()._outer_counts(live)
            solves.append(([(js.spec.job_id, js.wall_ema, js.devices) for js in live], out))
            return out

    eng = Engine(n_devices=8, device="cpu",
                 wall_model=lambda js: demand[js.spec.job_id] / max(len(js.devices), 1))
    common = dict(world_size=8, dynamic_batch_size=False, batch_size=64, epoch_size=3)
    js_h = eng.submit(sched.JobSpec("heavy", _cfg(tmp_path, "heavy", seed=11, **common),
                                    bundle=bundle, epochs=3))
    js_l = eng.submit(sched.JobSpec("light", _cfg(tmp_path, "light", seed=22, **common),
                                    bundle=bundle, epochs=3))
    jobs = eng.run()
    assert {j.status for j in jobs.values()} == {"done"}
    assert js_h.migrations >= 1 and js_l.migrations >= 1
    final = eng.windows[-1]["jobs"]
    assert (final["heavy"]["devices"], final["light"]["devices"]) == (6, 2)
    st = eng.stats()
    assert st["jobs"]["heavy"]["epochs"] == st["jobs"]["light"]["epochs"] == 3
    assert st["migrations"] >= 2
    for tr in (js_h.trainer, js_l.trainer):
        assert np.isfinite(tr.recorder.data["train_loss"]).all()
    assert len(solves) >= 2
    for live, got in solves:
        jax_eng = jsched.MultiStreamEngine(n_devices=8)
        assert got == jax_eng._outer_counts([_jax_fake(j, w, d) for j, w, d in live])


# ------------------------------------------------- two tenants at once


def test_two_concurrent_tenants_equal_their_runs_alone(bundle, tmp_path):
    specs = {
        "a": dict(cfg=dict(world_size=2, batch_size=64, epoch_size=3, seed=5),
                  injector=lambda: StaticStragglerInjector([3.0, 1.0], mode="virtual"),
                  timing_model=linear_time, slots=(0, 1)),
        "b": dict(cfg=dict(world_size=2, batch_size=64, epoch_size=3, seed=77,
                           dynamic_batch_size=False),
                  injector=lambda: None, timing_model=None, slots=(2, 3)),
    }
    alone = {}
    for name, s in specs.items():
        tr = Trainer(_cfg(tmp_path, "alone_" + name, **s["cfg"]), bundle=bundle,
                     injector=s["injector"](), timing_model=s["timing_model"], device="cpu",
                     log_to_file=False)
        rec = tr.run()
        alone[name] = (rec.data["train_loss"], rec.data["partition"], _params(tr))
    runtime.reset_launches()
    eng = _engine(n_devices=4)
    states = {name: eng.submit(sched.JobSpec(
        name, _cfg(tmp_path, "ms_" + name, **s["cfg"]), bundle=bundle, injector=s["injector"](),
        timing_model=s["timing_model"], max_devices=2, slots=s["slots"]))
        for name, s in specs.items()}
    eng.run()
    assert not any(runtime.LAUNCHES.values())  # CPU tensors: the plain versions
    for name, js in states.items():
        loss, part, params = alone[name]
        assert js.status == "done" and js.migrations == 0
        assert js.recorder.data["train_loss"] == loss, name
        assert js.recorder.data["partition"] == part, name
        for a, b in zip(params, js.trainer.params):
            assert torch.equal(a, b), name
    assert alone["a"][1][-1][0] < 0.4  # A's share moved off worker 0


# ------------------------------------------------------------------ the edges


def test_zero_epoch_job_retires_without_a_worker_thread(bundle, tmp_path):
    eng = _engine(n_devices=1)
    js = eng.submit(sched.JobSpec("noop", _cfg(tmp_path, device=0), bundle=bundle, epochs=0))
    eng.run()
    assert js.status == "done" and js.worker_thread is None and js.epochs_done == 0
    assert eng.pool.free_devices() == (0,)


def test_failing_tenant_reports_and_releases_its_slots(bundle, tmp_path):
    class Boom(RuntimeError):
        pass

    def exploding(plan):
        raise Boom("injected")

    eng = _engine(n_devices=1)
    js = eng.submit(sched.JobSpec("bad", _cfg(tmp_path, device=0), bundle=bundle,
                                  timing_model=exploding, epochs=2))
    with pytest.raises(RuntimeError, match="bad"):
        eng.run()
    assert js.status == "failed" and isinstance(js.error, Boom)
    assert eng.pool.free_devices() == (0,)
    assert eng.run(raise_on_failure=False)["bad"].status == "failed"


def test_submit_rejects_elastic_tenants_and_duplicates(bundle):
    eng = _engine(n_devices=2)
    with pytest.raises(ValueError, match="elastic"):
        eng.submit(sched.JobSpec("e", _cfg(elastic="on", fault_tolerance=True)))
    eng.submit(sched.JobSpec("a", _cfg(), bundle=bundle))
    with pytest.raises(ValueError, match="duplicate"):
        eng.submit(sched.JobSpec("a", _cfg(), bundle=bundle))


def test_slots_of_the_wrong_length_raise():
    with pytest.raises(ValueError, match="world_size 4"):
        sched.JobSpec("a", _cfg(), slots=(0, 1))
    assert sched.JobSpec("a", _cfg(), slots=(0, 0, 1, 1)).slots == (0, 0, 1, 1)


def test_the_engine_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the CUDA default resolves")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sched.MultiStreamEngine()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        sched.MultiStreamEngine(n_devices=4, device="cuda")
    assert _engine().pool.n_devices == 1  # the CPU: one slot by default


# --------------------------------------------- state the tenants share


def _with_fast_switches(fn):
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        return fn()
    finally:
        sys.setswitchinterval(old)


def test_launch_counts_lose_nothing_under_eight_threads():
    runtime.reset_launches()
    n, threads = 5000, 8

    def work():
        for _ in range(n):
            runtime.count("xent_fwd")
            runtime.count("groupnorm_fwd", 2)

    def run():
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)

    _with_fast_switches(run)
    got = dict(runtime.LAUNCHES)
    runtime.reset_launches()
    assert got["xent_fwd"] == n * threads and got["groupnorm_fwd"] == 2 * n * threads
    assert runtime.LAUNCHES["xent_fwd"] == 0


def test_a_capture_keeps_out_another_threads_launches():
    """A capture's per-key counts are its own context's (its thread on the
    CPU, its capture stream on a card): launches another thread makes while
    it captures are neither charged to the key (and so added again on every
    replay) nor taken back from the totals."""
    inside, other_done = threading.Event(), threading.Event()

    def other():
        inside.wait(timeout=30)
        for _ in range(7):
            runtime.count("xent_fwd")
        other_done.set()

    class Graph:
        def __init__(self, executor):
            pass

        def capture(self, fn):
            fn()
            inside.set()
            assert other_done.wait(timeout=30)

        def replay(self):
            pass

    def body(inputs, counts):
        runtime.count("xent_fwd", 2)
        runtime.count("groupnorm_fwd", 3)

    runtime.reset_launches()
    steps = StepGraphs("cpu", graph_factory=Graph)
    t = threading.Thread(target=other)
    t.start()
    x = torch.zeros(2)
    steps.run("k", [(x,)], [0], body, lambda i, c: None)
    t.join(timeout=30)
    assert not t.is_alive()
    assert steps._entries["k"].launches == {"xent_fwd": 2, "groupnorm_fwd": 3}
    assert runtime.LAUNCHES["xent_fwd"] == 7 + 2  # the other thread's, then one replay
    steps.run("k", [(x,)], [0], body, lambda i, c: None)
    assert runtime.LAUNCHES["xent_fwd"] == 7 + 4 and runtime.LAUNCHES["groupnorm_fwd"] == 6
    runtime.reset_launches()


class _SlowGraph:
    """A stub graph whose capture takes a while and records its interval."""

    spans: list = []

    def __init__(self, executor):
        pass

    def capture(self, fn):
        t0 = time.perf_counter()
        time.sleep(0.03)
        fn()
        _SlowGraph.spans.append((t0, time.perf_counter()))

    def replay(self):
        pass


def test_captures_exclude_each_other_and_the_other_tenants_work():
    """``CAPTURE_GATE``: three threads capture 3 keys each while a fourth
    works under a shared hold, as a tenant's epoch does; no two captures
    overlap, none overlaps the shared work, and a capture that waited for
    it counts the wait in ``capture_wait_s``, outside ``capture_s``."""
    _SlowGraph.spans = []
    work, started = [], threading.Event()

    def tenant_epoch():
        with CAPTURE_GATE.shared():
            started.set()
            t0 = time.perf_counter()
            time.sleep(0.2)
            work.append((t0, time.perf_counter()))

    executors = [StepGraphs("cpu", graph_factory=_SlowGraph) for _ in range(3)]

    def tenant(i):
        started.wait(timeout=30)
        for k in range(3):
            executors[i].run(k, [(torch.zeros(1),)], [0], lambda a, b: None, lambda a, b: None)

    ts = [threading.Thread(target=tenant_epoch)]
    ts += [threading.Thread(target=tenant, args=(i,)) for i in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in ts) and len(_SlowGraph.spans) == 9
    spans = sorted(_SlowGraph.spans)
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    (w0, w1), = work
    assert all(e <= w0 or s >= w1 for s, e in spans)
    waits = [ex.stats()["capture_wait_s"] for ex in executors]
    assert max(waits) >= 0.1 and all(ex.stats()["capture_s"] < 1.0 for ex in executors)


def test_kernel_libraries_build_once_under_many_threads(monkeypatch):
    builds = []

    class Lib:
        class error_string:
            pass

    class FakeCtypes:
        c_int, c_char_p = int, bytes

        @staticmethod
        def CDLL(path):
            return Lib()

    def build(names):
        builds.append(tuple(names))
        time.sleep(0.05)
        return {n: f"/nonexistent/{n}.so" for n in names}

    monkeypatch.setattr(runtime, "_LIBS", {})
    monkeypatch.setattr(runtime, "build", build)
    monkeypatch.setattr(runtime, "ctypes", FakeCtypes)
    got = []
    ts = [threading.Thread(target=lambda: got.append(runtime.load("xent"))) for _ in range(8)]
    _with_fast_switches(lambda: ([t.start() for t in ts], [t.join(timeout=30) for t in ts]))
    assert builds == [("xent",)] and len(got) == 8 and len({id(x) for x in got}) == 1
