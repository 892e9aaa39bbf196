"""Window-cadence rebalancing in the port (``--rebalance window``) against
the JAX package's.

Bit for bit with the JAX package on the same inputs (host-side numpy in
both, copied, not imported):

- ``ScheduledStragglerInjector``, all six schedules at two seeds on a grid
  of ``t``: ``gain``/``gain_vec``, ``factors_at``, ``epoch_faults`` and
  ``faults_at``, virtual and compute mode;
- ``build_remainder_plan`` on seeded random plans;
- ``OnlineRebalanceController`` fed one scripted run of rates, walls and
  horizons: every ``propose`` and ``commit``, the journal and ``snapshot``.

The engine against the JAX trainer: ``tests/test_online_dbs.py``'s ``_cfg``
(MnistNet, 4 workers, B 128, a ``sin`` 8:1 straggler of period 1, windows of
2 steps, ``--packed off``) under its ``linear_time`` timing model, both
packages from the same weights (``bridge.py``), dropout off on both sides
(the two packages draw dropout masks from different generators). Over 2
epochs the switch events (epoch, window, step, batches) and the
``plan_switches`` series are equal; the train losses agree within rtol 1e-5,
the tolerance ``tests/test_torch_faults.py`` holds f32 loss sums to (the
packages sum per-example losses and gradients in another order).

The port's own contracts, as the JAX package states them
(``tests/test_online_dbs.py``): a mid-epoch switch is bitwise a fresh run on
the remainder plan from the same state; window cadence with no switch is
bitwise epoch cadence; the switches stay bounded under the ``sin``
schedule. The first two run with augmentation on, whose draws are seeded per
window start (``Trainer._aug_seed``).
"""

import dataclasses
import json
import logging

import flax.linen as fnn
import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu.balance.controller import (
    OnlineRebalanceController as JaxController,
)
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.data.partitioner import (
    build_epoch_plan as jax_epoch_plan,
    build_remainder_plan as jax_remainder_plan,
)
from dynamic_load_balance_distributeddnn_tpu.faults import (
    FaultContext as JaxFaultContext,
    ScheduledStragglerInjector as JaxScheduled,
)
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.balance import HostOverheadMeter, replaylab
from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import (
    OnlineRebalanceController,
    step_time,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import integer_batch_split
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config, config_from_args
from dynamic_load_balance_distributeddnn_tpu_torch.data import (
    build_epoch_plan,
    build_remainder_plan,
    synthetic_dataset,
)
from dynamic_load_balance_distributeddnn_tpu_torch.faults import (
    FaultContext,
    ScheduledStragglerInjector,
)
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import gn_shapes
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import plan as gn_plan
from dynamic_load_balance_distributeddnn_tpu_torch.train import engine as port_engine
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SCHEDULES = ("sin", "ramp", "spike", "diurnal", "brownout", "killstorm")
# a grid of epoch-times across several periods, with the edges of the
# spike's duty and the sin's trough and peak on it
TS = sorted(set(np.round(np.linspace(-0.5, 4.75, 43), 6).tolist() + [0.0, 0.25, 0.55, 1.0, 2.0]))
LOSS_RTOL = 1e-5


def linear_time(plan):
    return np.array([float(w.batch_size * w.steps) for w in plan.workers])


def _kw(**kw):
    """``tests/test_online_dbs.py``'s ``_cfg`` for both packages."""
    base = dict(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=1,
        dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=1234, bucket=8,
        device=0, superstep="auto", superstep_window=2, packed="off",
        straggler="8,1,1,1", fault_schedule="sin", fault_period=1.0,
        rebalance="window", rebalance_every=1, aot_warm=False,
    )
    base.update(kw)
    return base


def _cfg(**kw):
    return Config(**_kw(**kw))


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset("mnist", n_train=1024, n_test=256)


class AugTrainer(Trainer):
    """The port's trainer with augmentation on for an image set that has
    none by default, so the augmentation stream is under test."""

    def _setup_model(self) -> None:
        super()._setup_model()
        self.augment = True


def _trainer(bundle, cfg, cls=Trainer, **kw):
    return cls(cfg, bundle=bundle, timing_model=linear_time, device="cpu",
               log_to_file=False, **kw)


# ------------------------------------------------------------- the injector


def _ctx(cls, ws):
    return cls(
        batch_sizes=np.arange(8.0, 8.0 * ws + 1, 8.0),
        iter_cost_s=2.5e-4,
        per_example_cost_s=np.linspace(1e-3, 2e-3, ws),
    )


def _same_faults(a, b):
    for k in ("virtual_seconds", "slow_iters_per_step", "time_multipliers"):
        x, y = getattr(a, k), getattr(b, k)
        assert x.dtype == y.dtype and np.array_equal(x, y), k


@pytest.mark.parametrize("seed", [0, 1234])
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_scheduled_injector_equals_jax(schedule, seed):
    factors = [8.0, 1.0, 3.0, 1.5, 4.0]
    kw = dict(schedule=schedule, period=1.5, phase=0.25, duty=0.3, seed=seed)
    for mode in ("virtual", "compute"):
        port = ScheduledStragglerInjector(factors, mode=mode, **kw)
        ref = JaxScheduled(factors, mode=mode, **kw)
        ctx, jctx = _ctx(FaultContext, 5), _ctx(JaxFaultContext, 5)
        for t in TS:
            if schedule in port.SCALAR_SCHEDULES:
                assert port.gain(t) == ref.gain(t), t
            assert np.array_equal(port.gain_vec(t), ref.gain_vec(t)), t
            assert np.array_equal(port.factors_at(t), ref.factors_at(t)), t
            _same_faults(port.faults_at(t, ctx), ref.faults_at(t, jctx))
        for epoch in range(4):
            _same_faults(port.epoch_faults(epoch, 8, ctx), ref.epoch_faults(epoch, 8, jctx))
    # the per-event streams are pure functions of (seed, t): any order
    for t in reversed(TS):
        assert np.array_equal(port.gain_vec(t), ref.gain_vec(t))


def test_scheduled_injector_refuses_what_jax_refuses():
    for bad in (dict(schedule="storm"), dict(period=0.0), dict(duty=0.0), dict(duty=1.5)):
        for cls in (ScheduledStragglerInjector, JaxScheduled):
            with pytest.raises(ValueError):
                cls([2.0, 1.0], **bad)


# ----------------------------------------------------------- remainder plans


@pytest.mark.parametrize("seed", range(6))
def test_remainder_plan_equals_jax(seed):
    rng = np.random.RandomState(seed)
    ws = int(rng.randint(2, 7))
    B = int(rng.choice([64, 128, 256]))
    bucket = int(rng.choice([1, 8, 16]))
    n = int(rng.randint(8 * B, 20 * B))
    shares = rng.dirichlet(np.ones(ws))
    batches = np.maximum(integer_batch_split(shares, B), 1)
    args = (n, shares, batches, B, int(rng.randint(0, 5)))
    port = build_epoch_plan(*args, seed=seed, bucket=bucket)
    ref = jax_epoch_plan(*args, seed=seed, bucket=bucket)
    for _ in range(4):
        s_done = int(rng.randint(1, port.num_steps))
        new = rng.randint(0, B // 2, ws).astype(np.int64)  # zeros included
        got = build_remainder_plan(port, s_done, new, bucket=bucket)
        want = jax_remainder_plan(ref, s_done, new, bucket=bucket)
        for k in ("epoch", "num_steps", "global_batch"):
            assert getattr(got, k) == getattr(want, k), k
        assert np.array_equal(got.shares, want.shares)
        assert np.array_equal(got.batch_sizes, want.batch_sizes)
        for a, b in zip(got.workers, want.workers):
            assert (a.rank, a.batch_size, a.padded_batch, a.steps) == (
                b.rank, b.batch_size, b.padded_batch, b.steps)
            assert a.indices.dtype == b.indices.dtype
            assert np.array_equal(a.indices, b.indices)
        for r in range(ws):
            for x, y in zip(got.epoch_indices(r), want.epoch_indices(r)):
                assert np.array_equal(x, y)
    with pytest.raises(ValueError):
        build_remainder_plan(port, 0, batches)
    with pytest.raises(ValueError):
        build_remainder_plan(port, 1, batches[:-1])


# ---------------------------------------------------------- the controller


def _scripted_run(cls, groups, knobs, seed):
    """Drive a controller through a seeded script: rate samples (with a
    re-anchoring jump and a rejected non-finite one), wall feedback,
    proposals over a shrinking horizon, commits at measured costs, and one
    deferral; every decision and event recorded."""
    rng = np.random.RandomState(seed)
    ctl = cls(4, 128, groups, bucket=8, max_share=0.5, **knobs)
    cur = np.full(4, 32, dtype=np.int64)
    out = []
    for k in range(24):
        phase = 0.5 * (1.0 - np.cos(2.0 * np.pi * k / 12.0))
        rates = 1e-3 * (1.0 + rng.uniform(0.0, 0.1, 4))
        rates[0] *= 1.0 + 7.0 * phase
        if k == 9:
            rates = rates * 10.0  # a re-anchoring scale jump
        if k == 11:
            rates[2] = np.nan  # a sample the EMA must skip
        ctl.observe_rates(rates)
        ctl.observe_wall(float(rng.uniform(0.5, 2.0)), 1.0)
        eff = ctl.rates if ctl.rates is not None else np.ones(4)
        ctl.eval_context = {"epoch": k // 6, "window": k % 6}
        remaining = int(12 - 2 * (k % 6))
        dec = ctl.propose(eff, cur, remaining)
        row = dataclasses.asdict(dec)
        row = {key: (v.tolist() if isinstance(v, np.ndarray) else v) for key, v in row.items()}
        if dec.switch and k == 14:
            ctl.note_deferred()
        elif dec.switch:
            row["event"] = ctl.commit(dec, float(rng.uniform(1e-3, 5e-2)),
                                      epoch=k // 6, window=k % 6, step=2 * (k % 6))
            cur = np.asarray(dec.candidate_batches, dtype=np.int64)
        out.append(row)
    out.append(ctl.propose(np.ones(4), cur, 0).reason)  # no horizon
    out.append(ctl.propose(np.full(4, -1.0), cur, 4).reason)  # no signal
    return out, ctl.decision_journal(), ctl.snapshot(include_journal=True), ctl.events


@pytest.mark.parametrize("groups", [[[0, 1, 2, 3]], [[0], [1], [2], [3]]], ids=["one-card", "four-cards"])
@pytest.mark.parametrize("knobs", [
    {},
    {"hysteresis": 0.05, "margin": 1.5, "budget_frac": 1.0, "rate_alpha": 0.3, "cost_init": 0.002},
], ids=["defaults", "tuned"])
def test_controller_scripted_run_equals_jax(groups, knobs):
    got = _scripted_run(OnlineRebalanceController, groups, knobs, 7)
    want = _scripted_run(JaxController, groups, knobs, 7)
    assert got == want
    switches = [r for r in got[0] if isinstance(r, dict) and r["switch"]]
    assert switches, "the script must reach a switch"
    assert json.loads(json.dumps(got[2])) == got[2]  # the snapshot is JSON-safe


def test_controller_journal_config_round_trip():
    ctl = OnlineRebalanceController(4, 128, [[0, 1, 2, 3]], bucket=8, max_share=0.5, margin=2.0)
    again = OnlineRebalanceController.from_journal_config(ctl.journal_config())
    assert again.journal_config() == ctl.journal_config()
    assert OnlineRebalanceController.from_journal_config(
        ctl.journal_config(), margin=5.0).margin == 5.0
    with pytest.raises(ValueError):
        OnlineRebalanceController.from_journal_config(ctl.journal_config(), speed=1.0)
    # workers sharing a card serialize, cards run in parallel
    b = np.full(4, 32)
    assert step_time(np.ones(4), b, [[0, 1, 2, 3]]) == 128.0
    assert step_time(np.ones(4), b, [[0], [1], [2], [3]], comm_s=0.5) == 32.5


def test_host_overhead_meter_marks_windows():
    meter = HostOverheadMeter()
    for _ in range(3):
        with meter.dispatch():
            pass
    d, p, n = meter.mark_window()
    assert n == 3 and d >= 0.0 and p == 0.0
    assert meter.mark_window() == (0.0, 0.0, 0)
    with meter.dispatch():
        pass
    assert meter.mark_window()[2] == 1 and meter.dispatches == 4
    assert meter.per_step(4) == pytest.approx(meter.dispatch_s / 4)
    meter.reset()
    assert (meter.dispatch_s, meter.put_s, meter.dispatches) == (0.0, 0.0, 0)


# ------------------------------------------------------ the engine vs JAX


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


@pytest.fixture(scope="module")
def engines():
    """The JAX trainer and the port's on ``_cfg`` for 2 epochs, from the
    JAX trainer's initial weights, dropout off on both sides."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    try:
        jtr = JaxTrainer(JaxConfig(**_kw(epoch_size=2)),
                         bundle=jax_synthetic("mnist", n_train=1024, n_test=256),
                         timing_model=linear_time, log_to_file=False)
        tr = _trainer(synthetic_dataset("mnist", n_train=1024, n_test=256), _cfg(epoch_size=2))
        tr.model.load_state_dict(params_from_flax(jtr.state.params, tr.model))
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
        for e in range(2):
            jtr.run_epoch(e)
            tr.run_epoch(e)
    finally:
        mp.undo()
    return jtr, tr


def test_switch_events_equal_the_jax_trainer(engines):
    jtr, tr = engines
    keys = ("epoch", "window", "step", "batches")
    want = [{k: ev[k] for k in keys} for ev in jtr.recorder.meta["rebalance_events"]]
    got = [{k: ev[k] for k in keys} for ev in tr.recorder.meta["rebalance_events"]]
    assert want, "the sin schedule must switch the JAX trainer"
    assert got == want
    assert tr.recorder.data["plan_switches"] == jtr.recorder.data["plan_switches"]
    assert tr.recorder.data["partition"] == jtr.recorder.data["partition"]
    assert tr._rebalance_ctl.evals == jtr._rebalance_ctl.evals


def test_train_losses_agree_with_the_jax_trainer(engines):
    jtr, tr = engines
    np.testing.assert_allclose(
        tr.recorder.data["train_loss"], jtr.recorder.data["train_loss"], rtol=LOSS_RTOL, atol=0)


@pytest.mark.parametrize("superstep", ["auto", "off"])
@pytest.mark.parametrize("window,chunk", [(2, 128), (3, 4), (16, 0), (1, 5)])
def test_windows_equal_the_jax_trainers(engines, superstep, window, chunk):
    jtr, tr = engines
    saved = jtr.cfg, tr.cfg
    knobs = dict(superstep=superstep, superstep_window=window, stream_chunk_steps=chunk)
    jtr.cfg, tr.cfg = dataclasses.replace(jtr.cfg, **knobs), dataclasses.replace(tr.cfg, **knobs)
    try:
        for n in (1, 7, 8, 13, 40):
            assert tr._elastic_ranges(n) == jtr._elastic_ranges(n), n
    finally:
        jtr.cfg, tr.cfg = saved


def test_the_scheduled_injector_is_picked_as_jax_picks_it(engines):
    jtr, tr = engines
    for inj in (tr.injector, jtr.injector):
        assert (inj.schedule, inj.period, inj.seed, inj.mode) == ("sin", 1.0, 1234, "virtual")
    assert type(tr.injector).__name__ == type(jtr.injector).__name__
    assert np.array_equal(tr.injector.factors, jtr.injector.factors)


# ------------------------------------------------- the port's own contracts


def test_mid_epoch_switch_parity_vs_fresh_remainder_run(bundle):
    """A mid-epoch switch is bitwise a fresh run on the remainder plan from
    the same state: run A switches inside the epoch; run B runs the same
    prefix, then each recorded segment from that state, the last through
    the engine's replay helper. Augmentation on (per-window seeds)."""
    cfg = _cfg()
    tr_a = _trainer(bundle, cfg, AugTrainer)
    tr_a.run_epoch(0)
    events = [e for e in tr_a.recorder.meta.get("rebalance_events", []) if e["epoch"] == 0]
    assert events, "the sin schedule must trigger at least one switch"

    tr_b = _trainer(bundle, dataclasses.replace(cfg, rebalance="epoch"), AugTrainer)
    plan_b, faults_b = tr_b._plan_epoch(0)
    assert plan_b.batch_sizes.tolist() == [32, 32, 32, 32]
    ranges = tr_b._elastic_ranges(plan_b.num_steps)
    acc = {"loss": torch.zeros(()), "count": 0}
    tr_b.model.train()
    s1 = events[0]["step"]
    tr_b._run_elastic_windows(plan_b, [(0, plan_b)], [w for w in ranges if w[1] <= s1],
                              faults_b, 0, acc)
    segs = [(0, plan_b)]
    for ev in events:
        start, pl = segs[-1]
        segs.append((ev["step"], build_remainder_plan(
            pl, ev["step"] - start, np.asarray(ev["batches"], dtype=np.int64), bucket=cfg.bucket)))
    for (start, rpl), nxt in zip(segs[1:], segs[2:] + [(plan_b.num_steps, None)]):
        if nxt[1] is None:
            tr_b._replay_window_segment(plan_b, rpl, start, 0, faults_b, acc=acc)
            continue
        sub = [w for w in ranges if start <= w[0] and w[1] <= nxt[0]]
        tr_b._run_elastic_windows(plan_b, [(start, rpl)], sub, faults_b, 0, acc)

    for a, b in zip(tr_a.model.parameters(), tr_b.model.parameters()):
        assert torch.equal(a, b)
    assert float(acc["loss"]) / max(acc["count"], 1) == tr_a.recorder.data["train_loss"][0]


def test_window_cadence_without_switch_matches_epoch_cadence(bundle):
    """With a schedule too weak to pass the hysteresis, window cadence is
    bitwise epoch cadence: the controller's evaluations change nothing."""
    quiet = dict(straggler="1.05,1,1,1", epoch_size=2)
    tr_w = _trainer(bundle, _cfg(**quiet), AugTrainer)
    tr_e = _trainer(bundle, _cfg(**quiet, rebalance="epoch"), AugTrainer)
    for e in range(2):
        tr_w.run_epoch(e)
        tr_e.run_epoch(e)
    assert tr_w._rebalance_ctl is not None and tr_w._rebalance_ctl.evals > 0
    assert tr_w._rebalance_ctl.switches == 0
    assert tr_w.recorder.data["train_loss"] == tr_e.recorder.data["train_loss"]
    for a, b in zip(tr_w.model.parameters(), tr_e.model.parameters()):
        assert torch.equal(a, b)


def test_no_thrash_under_sin_schedule(bundle):
    """The hysteresis and the budget keep the switches well below the
    evaluations under the time-varying schedule, and the ledger holds."""
    epochs = 3
    tr = _trainer(bundle, _cfg(epoch_size=epochs))
    for e in range(epochs):
        tr.run_epoch(e)
    ctl = tr._rebalance_ctl
    assert ctl is not None and ctl.evals >= epochs
    switches = float(np.sum(tr.recorder.data["plan_switches"]))
    assert 1 <= switches <= 2 * epochs
    assert switches < ctl.evals
    assert ctl.spent_s <= ctl.budget_frac * ctl.credit_s + ctl.cost_init
    for ev in tr.recorder.meta["rebalance_events"]:
        assert ev["remaining_steps"] > 0
    report = replaylab.replay(replaylab.harvest(ctl))
    assert report["parity"] and report["invariant_violations"] == []


def test_compute_mode_restages_the_load_at_each_window(bundle, monkeypatch):
    """Under compute-mode injection each window's synthetic-load
    iterations are the schedule's at the window's midpoint, at the
    current segment's split (the JAX window loop's re-staging)."""
    tr = _trainer(bundle, _cfg(fault_mode="compute", rebalance="epoch"))
    tr._iter_cost_s = 2e-4
    tr.per_example_cost = np.full(4, 1e-3)
    plan, faults = tr._plan_epoch(1)
    seen = []
    monkeypatch.setattr(port_engine, "elastic_step",
                        lambda model, opt, batches, clip, load, slow, compute_dtype:
                        seen.append(list(slow)))
    tr._run_elastic_windows(plan, [(0, plan)], tr._elastic_ranges(plan.num_steps), faults, 1,
                            {"loss": torch.zeros(()), "count": 0})
    ctx = FaultContext(batch_sizes=plan.batch_sizes.astype(np.float64), iter_cost_s=2e-4,
                       per_example_cost_s=np.full(4, 1e-3))
    want = []
    for w0, w1 in tr._elastic_ranges(plan.num_steps):
        t = 1.0 + (w0 + w1) / (2.0 * plan.num_steps)
        want += [tr.injector.faults_at(t, ctx).slow_iters_per_step.tolist()] * (w1 - w0)
    assert seen == want
    assert len({tuple(v) for v in seen}) > 1  # the load moves within the epoch


def test_dbs_widths_never_take_k1s_general_route():
    """Every per-worker width a plan or a switch can give DenseNet-121 at
    B = 512 (1 to 512 rows) sends each of its 120 GroupNorm calls to K1's
    tiled route, forward and backward."""
    for b in range(1, 513):
        for _, s, c in gn_shapes(b, (6, 12, 24, 16), 32):
            for backward in (False, True):
                assert gn_plan(b, s, c, 32, torch.float32, backward).route == "tiled", (b, s, c)


# --------------------------------------------------------------- the flags


BASE = dict(model="mnistnet", dataset="mnist")


def test_window_flags_are_accepted():
    cfg = config_from_args(
        "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 -e 3 --packed off "
        "--straggler 8,1,1,1 --fault_mode compute --fault_schedule sin --fault_period 1 "
        "--rebalance window --superstep_window 2 --n_train 8192".split())
    assert (cfg.rebalance, cfg.fault_schedule, cfg.fault_period) == ("window", "sin", 1.0)
    for schedule in SCHEDULES:
        assert Config(**BASE, straggler="2,1,1,1", fault_schedule=schedule).fault_schedule == schedule


@pytest.mark.parametrize("bad", [
    {"rebalance": "hourly"}, {"rebalance_every": 0}, {"rebalance_hysteresis": -0.1},
    {"rebalance_margin": -1.0}, {"rebalance_budget_frac": 0.0}, {"rebalance_rate_alpha": 0.0},
    {"rebalance_rate_alpha": 1.5}, {"fault_schedule": "storm", "straggler": "2,1,1,1"},
    {"fault_schedule": "sin"}, {"fault_period": 0.0},
    {"rebalance": "window", "dynamic_batch_size": False},
])
def test_window_flags_are_checked_as_jax_checks_them(bad):
    with pytest.raises(ValueError):
        JaxConfig(**BASE, **bad)
    with pytest.raises(ValueError):
        Config(**BASE, **bad)


def test_window_on_packed_epochs_warns_and_keeps_epoch_cadence(bundle, caplog):
    logger = logging.getLogger("test_torch_online_dbs")
    tr = _trainer(bundle, _cfg(packed="auto", epoch_size=2), logger=logger)
    with caplog.at_level(logging.WARNING, logger=logger.name):
        for e in range(2):
            tr.run_epoch(e)
    warned = [r for r in caplog.records if "rebalance=window" in r.getMessage()]
    assert len(warned) == 1 and "epoch cadence" in warned[0].getMessage()
    assert tr.recorder.meta["paths"] == ["packed", "packed"]
    assert tr._rebalance_ctl is None and "plan_switches" not in tr.recorder.data


def test_cli_window_run_replays_its_journal(tmp_path):
    """``--rebalance window`` through the cli on the CPU with wall-clock
    probes (the synchronize-and-measure feedback path): the series carry
    the switch count and the host walls, and the controller snapshot in
    ``_meta`` is a corpus that replays bit for bit."""
    argv = (f"-m mnistnet -ds mnist -ws 4 -b 128 -e 2 --n_train 1024 --packed off "
            f"--straggler 8,1,1,1 --fault_schedule sin --fault_period 1 --rebalance window "
            f"--superstep_window 2 --bucket 8 --log_dir {tmp_path}/logs "
            f"--stat_dir {tmp_path}/statis").split()
    assert cli.main(argv, device="cpu") == 0
    cfg = config_from_args(argv)
    with open(tmp_path / "statis" / (cfg.base_filename().format(0) + ".json")) as f:
        series = json.load(f)
    assert len(series["plan_switches"]) == 2 and len(series["host_dispatch_s"]) == 2
    assert all(v > 0 for v in series["host_dispatch_s"]) and series["host_put_s"] == [0.0, 0.0]
    meta = series["_meta"]
    evals = meta["rebalance_evals"]
    # 4 windows an epoch; the controller runs after windows 0 and 1 (a
    # switch acts two windows on, as in the JAX package)
    assert len(evals) == meta["rebalance_controller"]["evals"] == 2 * 2
    assert all(e["wall_s"] >= e["sync_s"] >= 0.0 for e in evals)
    path = tmp_path / "meta.json"
    path.write_text(json.dumps(meta))
    report = replaylab.replay(replaylab.load_corpus(str(path)))
    assert report["parity"] and report["invariant_violations"] == []
    assert report["replayed"]["switches"] == sum(series["plan_switches"])


def test_lm_refuses_the_window_flag_and_takes_the_schedule(tmp_path):
    """The language model keeps epoch cadence: ``--rebalance window``
    raises naming the flag (a remainder plan re-slices examples, not a
    folded token stream, and the JAX language model fails at its first
    switch), while a scheduled straggler runs at its epoch means."""
    base = (f"-m transformer -ds wikitext2 -ws 2 -b 16 -e 1 --n_train 4000 "
            f"--straggler 3,1 --fault_schedule sin --fault_period 1 "
            f"--log_dir {tmp_path}/logs --stat_dir {tmp_path}/statis").split()
    with pytest.raises(NotImplementedError, match="--rebalance"):
        config_from_args(base + ["--rebalance", "window"])
    assert cli.main(base, device="cpu") == 0
    cfg = config_from_args(base)
    with open(tmp_path / "statis" / (cfg.base_filename().format(0) + ".json")) as f:
        series = json.load(f)
    assert "rebalance_controller" not in series["_meta"]
    assert np.isfinite(series["train_loss"]).all()
