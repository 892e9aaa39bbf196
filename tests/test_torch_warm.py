"""The warm service in the port's trainer (``--aot_warm``, ``--warm_start``,
``--aot_speculate``, ``--speculate_scan``) on the CPU.

The trainers' step graphs are ``ReplayGraph``s (``tests/test_torch_compiler.py``):
a capture records the step and runs nothing, a replay runs it, as a CUDA
graph does, so the captures and their places can be counted here.

- ``--aot_warm on`` (with ``--warm_start``) against ``off``: bit for bit
  (train losses, partitions, parameters, momentum) on the elastic path,
  the packed path, the language model and a window-cadence run whose
  sin schedule switches plans mid-epoch.
- The JAX trainer, ``aot_warm`` on in both, from the same weights: equal
  partitions, train losses within rtol 1e-5 (the tolerance of
  ``tests/test_torch_online_dbs.py``).
- A converged DBS run takes no foreground capture, and after its first two
  epochs every capture lies in an ``aot_drain`` or ``speculate`` phase of
  the trace (and, as every capture, in the executor's ``warm`` span), never
  in ``train``; under ``off`` its first epochs capture inside ``train``.
- ``-ocp true``: the decay epochs replay keys the speculation captured
  with their learning rate; under ``off`` each captures in its wall. The
  step a speculated key records runs its update at the key's rate (a
  capture bakes the rate into the graph).
- A service capture leaves the parameters, ``.grad``, the momentum
  buffers, the registered generators' states and the loss accumulator
  bit for bit as they were, and fills its slots as the JAX
  ``_dummy_batch`` does.
- Two gloo ranks in window mode speculate each worker's ±bucket rungs.
"""

import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.faults import StaticStragglerInjector
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import configure, get_tracer
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from tests import _torch_dist_helpers as dh
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_compiler import ReplayGraph
from tests.test_torch_online_dbs import _MnistNetNoDropout

LOSS_RTOL = 1e-5  # tests/test_torch_online_dbs.py's: f32 sums in another order


def linear_time(plan):
    return np.array([3.0, 1.0, 1.0, 1.0]) * np.array(
        [w.batch_size * w.steps for w in plan.workers], dtype=np.float64)


def _kw(aot, **kw):
    base = dict(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=4,
        dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=1234, bucket=8,
        device=0, superstep="auto", superstep_window=2, packed="off", aot_warm=aot,
        warm_start=aot,
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset("mnist", n_train=1024, n_test=128)


def _graphed(tr):
    tr.supersteps._factory = ReplayGraph
    return tr


def _trainer(bundle, aot, timing_model=linear_time, straggler="virtual", **kw):
    injector = StaticStragglerInjector([3.0, 1.0, 1.0, 1.0], mode=straggler) if straggler else None
    tr = Trainer(Config(**_kw(aot, fault_mode=straggler or "virtual", **kw)), bundle=bundle,
                 injector=injector, timing_model=timing_model, device="cpu", log_to_file=False)
    if straggler == "compute":
        tr.per_example_cost = np.full(4, 1e-6)
        tr._iter_cost_s = 1e-5
    return _graphed(tr)


class SmallLM(LMTrainer):
    EMSIZE = 16
    NHID = 16


def _lm(tmp_path, aot):
    corpus = tmp_path / "corpus"
    if not corpus.exists():
        make_tiny_corpus(corpus)
    cfg = Config(debug=True, world_size=4, batch_size=40, learning_rate=0.05, epoch_size=3,
                 dataset="wikitext2", model="transformer", bucket=4, bptt=16, grad_clip=0.25,
                 straggler="3,1,1,1", fault_mode="virtual", superstep="auto",
                 superstep_window=2, device=0, aot_warm=aot, warm_start=aot)
    return _graphed(SmallLM(cfg, bundle=Corpus(str(corpus)), timing_model=linear_time,
                            device="cpu", log_to_file=False))


def _window(bundle, aot):
    """Window cadence under a sin schedule (``tests/test_torch_obs.py``'s
    run): the controller switches plans mid-epoch."""
    tr = Trainer(Config(**_kw(aot, straggler="8,1,1,1", fault_schedule="sin", fault_period=1.0,
                              rebalance="window", epoch_size=3)),
                 bundle=bundle, device="cpu", log_to_file=False,
                 timing_model=lambda plan: np.array([float(w.batch_size * w.steps)
                                                     for w in plan.workers]))
    return _graphed(tr)


def _assert_bitwise_equal(a, b):
    assert a.recorder.data["train_loss"] == b.recorder.data["train_loss"]
    assert a.recorder.data["partition"] == b.recorder.data["partition"]
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])


@pytest.mark.parametrize("case", ["elastic", "packed", "lm", "window", "compute"])
def test_on_equals_off_bit_for_bit(bundle, tmp_path, case):
    def make(aot):
        if case == "lm":
            return _lm(tmp_path, aot)
        if case == "window":
            return _window(bundle, aot)
        if case == "compute":  # the load's counts through the slots
            return _trainer(bundle, aot, straggler="compute")
        return _trainer(bundle, aot, packed="auto" if case == "packed" else "off")

    off, on = make(False), make(True)
    off.run()
    on.run()
    assert on.recorder.meta["paths"] == off.recorder.meta["paths"]
    _assert_bitwise_equal(off, on)
    assert off._aot is None and on._aot.stats()["captured"] >= 1
    assert on._aot.stats()["failed"] == 0 and on.supersteps.replays == off.supersteps.replays
    if case == "window":
        assert on._rebalance_ctl.switches >= 1
    if case == "compute":
        assert any(any(k[4]) for k in on._superstep_keys)  # keys with a load


def test_port_matches_the_jax_trainer_with_aot_on(bundle, monkeypatch):
    monkeypatch.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    from dynamic_load_balance_distributeddnn_tpu.faults import (
        StaticStragglerInjector as JaxStraggler,
    )

    jtr = JaxTrainer(JaxConfig(**_kw(True, epoch_size=3)),
                     bundle=jax_synthetic("mnist", n_train=1024, n_test=128),
                     injector=JaxStraggler([3.0, 1.0, 1.0, 1.0], mode="virtual"),
                     timing_model=linear_time, log_to_file=False)
    tr = _trainer(bundle, True, epoch_size=3)
    tr.model.load_state_dict(params_from_flax(jtr.state.params, tr.model))
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    jtr.run()
    tr.run()
    assert jtr._aot is not None and tr._aot.stats()["captured"] >= 1
    assert tr.recorder.data["partition"] == jtr.recorder.data["partition"]
    np.testing.assert_allclose(tr.recorder.data["train_loss"], jtr.recorder.data["train_loss"],
                               rtol=LOSS_RTOL, atol=0)


# ----------------------------------------------------- where captures happen


def _capture_places(events):
    """Each capture span's epoch and the phases among ``train``,
    ``aot_drain`` and ``speculate`` that contain it (every capture lies in
    the executor's own ``warm`` span, ``train/supersteps.py``)."""
    spans = [(n, ts, ts + dur, (args or {}).get("epoch"))
             for n, _, ph, ts, dur, _, args in events if ph == "X"]
    out = []
    for n, t0, t1, ep in spans:
        if n != "capture":
            continue
        around = {m for m, s0, s1, e in spans
                  if m in ("train", "aot_drain", "speculate") and e == ep
                  and s0 <= t0 and t1 <= s1}
        out.append((ep, around))
    return out


def _traced_run(bundle, aot, **kw):
    configure("on")
    try:
        tr = _trainer(bundle, aot, trace="on", **kw)
        tr.run()
        return tr, get_tracer().events()
    finally:
        configure("off")


def test_a_converged_run_captures_only_outside_its_walls(bundle):
    tr, events = _traced_run(bundle, True, epoch_size=5)
    parts = tr.recorder.data["partition"]
    assert parts[1] != parts[0] and parts[-1] == parts[1]  # rebalanced, then converged
    assert tr.recorder.data["graph_captures"] == [0.0] * 5
    places = _capture_places(events)
    assert places and all(p[1] for p in places)
    late = [p for p in places if p[0] >= 2]
    for ep, around in places:
        if ep >= 2:
            assert "train" not in around and around & {"aot_drain", "speculate"}
    assert [r["captures"] for r in tr.recorder.meta["supersteps"][2:]] == [0, 0, 0]
    assert any("aot_drain" in a for e, a in places if e == 0)  # the warm, before the wall
    assert all("train" not in a for e, a in late)
    # under off the first epochs capture inside their walls, in the foreground
    off, events = _traced_run(bundle, False, epoch_size=5)
    assert off.recorder.data["partition"] == parts
    assert off.recorder.data["graph_captures"][:2] == [1.0, 1.0]
    assert all(a == {"train"} for _, a in _capture_places(events))


def test_decay_epochs_replay_speculated_keys(bundle):
    def run(aot):
        tr = _trainer(bundle, aot, timing_model=lambda plan: np.ones(4), straggler=None,
                      one_cycle_policy=True, epoch_size=10)
        tr.run()
        return tr

    on, off = run(True), run(False)
    _assert_bitwise_equal(off, on)
    lrs = sorted({k[5] for k in on._superstep_keys})
    assert len(lrs) == 3  # the base rate, then epochs 8 and 9 decay (epoch 7 is at the base)
    recs = on.recorder.meta["supersteps"]
    for e in (8, 9):
        assert recs[e]["captures"] == 0 and recs[e]["speculative_hits"] == 1, recs[e]
        assert off.recorder.meta["supersteps"][e]["foreground_captures"] == 1
    assert on.recorder.data["graph_captures"] == [0.0] * 10


@pytest.mark.parametrize("path", ["elastic", "packed"])
def test_a_speculated_key_is_captured_at_its_learning_rate(bundle, path):
    """A capture bakes the learning rate its update reads into the graph's
    launches (``train/supersteps.py``): the step a speculated key records
    must run its update at the key's rate, the next epoch's, and leave the
    optimizer at the current one."""
    tr = _trainer(bundle, True, packed="auto" if path == "packed" else "off", straggler=None)
    tr.run_epoch(0)
    base = tr.optimizer.param_groups[0]["lr"]
    tr._epoch_path = path
    rows = (128,) if path == "packed" else (32, 32, 32, 32)
    (key,) = tr._aot_submit(path, [(rows, (0,) * len(rows))], lr=0.25 * base, speculative=True)
    tr._aot.wait()
    assert key[5] == 0.25 * base and tr.optimizer.param_groups[0]["lr"] == base
    seen = []
    step = tr.optimizer.step
    tr.optimizer.step = lambda *a, **k: seen.append(tr.optimizer.param_groups[0]["lr"])
    try:
        tr.supersteps._entries[key].graph.fn()  # what a capture records
    finally:
        tr.optimizer.step = step
    assert seen == [0.25 * base] and tr.optimizer.param_groups[0]["lr"] == base


@pytest.mark.parametrize("path", ["elastic", "packed"])
def test_a_service_capture_leaves_the_training_state_untouched(bundle, path):
    tr = _trainer(bundle, True, packed="auto" if path == "packed" else "off",
                  straggler="compute")
    tr.run_epoch(0)
    params = [p.detach().clone() for p in tr.params]
    grads = [p.grad.clone() for p in tr.params]
    moms = [tr.optimizer.state[p]["momentum_buffer"].clone() for p in tr.params]
    gens = [g.get_state() for g in tr.supersteps.generators]
    loss = tr.supersteps.loss.clone()
    tr._epoch_path = path
    rows = (48,) if path == "packed" else (16, 40, 40, 32)
    keys = tr._aot_submit(path, [(rows, (3,) + (0,) * (len(rows) - 1))])
    assert tr._aot.pending() == 1 and tr._aot.wait() == keys
    for p, q in zip(tr.params, params):
        assert torch.equal(p, q)
    for p, g, m in zip(tr.params, grads, moms):
        assert torch.equal(p.grad, g) and torch.equal(tr.optimizer.state[p]["momentum_buffer"], m)
    assert all(torch.equal(g.get_state(), s) for g, s in zip(tr.supersteps.generators, gens))
    assert torch.equal(tr.supersteps.loss, loss)
    (key,) = keys
    entry = tr.supersteps._entries[key]
    assert entry.origin == "service" and entry.graph is not None and not entry.used
    for (x, y, w), n in zip(entry.inputs, rows):
        assert x.shape[0] == n and not x.any() and not y.any()
        assert torch.equal(w, torch.full_like(w, 1.0 / (n * tr.world_size)))
    assert entry.slots[0] is not None and all(s is None for s in entry.slots[1:])


# ------------------------------------------------------------------ ranks


def test_two_ranks_in_window_mode_speculate_their_rungs(tmp_path):
    cfg = dict(debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=3,
               dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=512,
               packed="off", device=[0, 0])
    outs = dh.launch(2, {"win": {"kind": "warm_train", "cfg": cfg, "timing": "3,1",
                                 "no_dropout": True}}, tmp_path)
    for rank, out in enumerate(o["win"] for o in outs):
        assert out["mode"] == "window" and out["meta"]["paths"] == ["elastic"] * 3
        batches = [rec["batch_sizes"][rank] for rec in out["meta"]["supersteps"]]
        rungs = {(b + d,) for b in batches[:2] for d in (-8, 8) if 8 <= b + d <= 64}
        assert rungs and rungs <= set(map(tuple, out["known"]))
        assert set(map(tuple, out["speculated"])) <= rungs and out["aot"]["speculative"] >= 1
        assert out["graph_captures"] == [0.0, 0.0, 0.0] and out["aot"]["failed"] == 0
    assert outs[0]["win"]["data"]["partition"] == outs[1]["win"]["data"]["partition"]
