"""The port's supersteps (``--superstep``, ``train/supersteps.py``) on the CPU.

After ``tests/test_superstep.py``, the JAX package's contract: supersteps
remove host dispatch and change no math.

- ``Trainer._elastic_mode()`` equals the JAX trainer's for ``auto``, ``on``
  and ``off`` on one device.
- ``auto`` against ``off`` is bit-identical (train-loss series,
  ``partition``, every parameter): MnistNet on the elastic path (4 workers,
  ``--packed off``, a 3:1 timing model), the tiny language model (clip
  0.25, dropout on), the packed path, ``--precision bfloat16``, a
  compute-mode straggler (its load's counts through the slots), and
  augmentation on (one window an epoch, as ``off`` has: the crops are
  seeded per window start). On the CPU the executor runs each step eagerly
  from its static slots.
- The port's ``auto`` against the JAX package's ``auto`` (scan mode), both
  from the same weights (``bridge.py``), dropout off on both sides: equal
  partitions, train losses within rtol 1e-5, the tolerance
  ``tests/test_torch_online_dbs.py`` holds the two trainers' losses to.
- ``dispatches`` counts windows (the packed epoch: one) under ``auto`` and
  steps under ``off``; an epoch on a repeated plan adds no key.
- The load's device-count form equals its int form.
- The executor's bookkeeping against a stub graph: a capture's launch
  counts move to its replays, warm-up launches count, the warm-up leaves
  the generators as it found them, a failed capture raises with its key.
- ``prepare_step_state``'s zero momentum buffers give torch's
  clone-on-first-step bit for bit.

No test here reads a clock.
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
from dynamic_load_balance_distributeddnn_tpu_torch.models.mnistnet import MnistNet
from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad, synthetic_load
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer, set_learning_rate
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import elastic_step, weighted_loss
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import StepGraphs
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_online_dbs import _MnistNetNoDropout

LOSS_RTOL = 1e-5  # tests/test_torch_online_dbs.py's: f32 sums in another order


def linear_time(plan):
    return np.array([3.0, 1.0, 1.0, 1.0]) * np.array(
        [w.batch_size * w.steps for w in plan.workers], dtype=np.float64)


def _kw(superstep, **kw):
    """``tests/test_superstep.py``'s ``_run`` configuration."""
    base = dict(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=1234, bucket=8,
        device=0, superstep=superstep, superstep_window=2, packed="off",
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def bundle():
    return synthetic_dataset("mnist", n_train=1024, n_test=256)


def _trainer(bundle, superstep, timing_model=linear_time, straggler="virtual", **kw):
    """The port's trainer on ``_kw``; ``straggler``: the 3:1 profile's
    mode, or None. In compute mode the clean cost an example and the cost
    an iteration are pinned (the probes that would measure them do not run
    under a timing model), so the straggler's steps run about 6 load
    iterations each, through the load's slots in scan mode."""
    injector = StaticStragglerInjector([3.0, 1.0, 1.0, 1.0], mode=straggler) if straggler else None
    tr = Trainer(Config(**_kw(superstep, fault_mode=straggler or "virtual", **kw)), bundle=bundle,
                 injector=injector, timing_model=timing_model, device="cpu", log_to_file=False)
    if straggler == "compute":
        tr.per_example_cost = np.full(4, 1e-6)
        tr._iter_cost_s = 1e-5
    return tr


class SmallLM(LMTrainer):
    EMSIZE = 16
    NHID = 16


def _lm(tmp_path, superstep):
    corpus = tmp_path / "corpus"
    if not corpus.exists():
        make_tiny_corpus(corpus)
    cfg = Config(debug=True, world_size=4, batch_size=40, learning_rate=0.05, epoch_size=2,
                 dataset="wikitext2", model="transformer", bucket=4, bptt=16, grad_clip=0.25,
                 straggler="3,1,1,1", fault_mode="virtual", superstep=superstep,
                 superstep_window=2, device=0)
    return SmallLM(cfg, bundle=Corpus(str(corpus)), timing_model=linear_time, device="cpu",
                   log_to_file=False)


def _assert_bitwise_equal(a, b):
    assert a.recorder.data["train_loss"] == b.recorder.data["train_loss"]
    assert a.recorder.data["partition"] == b.recorder.data["partition"]
    for (name, p), q in zip(a.model.named_parameters(), b.model.parameters()):
        assert torch.equal(p, q), name
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])


# ----------------------------------------------------------------- the mode


@pytest.mark.parametrize("superstep,mode", [("auto", "scan"), ("on", "scan"), ("off", "step")])
def test_elastic_mode_equals_the_jax_trainers(bundle, superstep, mode):
    jtr = JaxTrainer(JaxConfig(**_kw(superstep)),
                     bundle=jax_synthetic("mnist", n_train=256, n_test=64), log_to_file=False)
    tr = _trainer(bundle, superstep)
    assert tr._elastic_mode() == jtr._elastic_mode() == mode


# ---------------------------------------------------------- auto against off


@pytest.mark.parametrize("case", ["elastic", "lm", "packed", "bf16", "compute", "augment"])
def test_auto_equals_off_bit_for_bit(bundle, tmp_path, case):
    def make(superstep):
        if case == "lm":
            return _lm(tmp_path, superstep)
        kw = {"packed": dict(packed="auto"), "bf16": dict(precision="bfloat16"),
              "compute": dict(straggler="compute"),
              # augmentation is seeded per window start, and off runs the
              # epoch in one stream chunk: one window an epoch under auto
              "augment": dict(superstep_window=16)}.get(case, {})
        tr = _trainer(bundle, superstep, **kw)
        tr.augment = case == "augment"
        return tr

    off, auto = make("off"), make("auto")
    off.run()
    auto.run()
    if case == "compute":
        assert any(any(key[4]) for key in auto._superstep_keys)  # a key with a load
    path = "packed" if case == "packed" else "elastic"
    assert auto.recorder.meta["paths"] == off.recorder.meta["paths"] == [path] * 2
    _assert_bitwise_equal(off, auto)
    ran = auto.recorder.meta["supersteps"]
    assert [r["mode"] for r in ran] == ["scan"] * 2
    assert sum(r["eager_runs"] for r in ran) > 0 and auto.supersteps.superstep_cache_size() >= 1
    assert off.supersteps.superstep_cache_size() == 0
    assert [r["eager_runs"] for r in off.recorder.meta["supersteps"]] == [0, 0]


def test_port_auto_is_within_tolerance_of_jax_auto(bundle, monkeypatch):
    monkeypatch.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    from dynamic_load_balance_distributeddnn_tpu.faults import (
        StaticStragglerInjector as JaxStraggler,
    )

    jtr = JaxTrainer(JaxConfig(**_kw("auto")), bundle=jax_synthetic("mnist", n_train=1024, n_test=256),
                     injector=JaxStraggler([3.0, 1.0, 1.0, 1.0], mode="virtual"),
                     timing_model=linear_time, log_to_file=False)
    tr = _trainer(bundle, "auto")
    tr.model.load_state_dict(params_from_flax(jtr.state.params, tr.model))
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    jtr.run()
    tr.run()
    assert jtr._elastic_mode() == tr._elastic_mode() == "scan"
    assert tr.recorder.data["partition"] == jtr.recorder.data["partition"]
    np.testing.assert_allclose(tr.recorder.data["train_loss"], jtr.recorder.data["train_loss"],
                               rtol=LOSS_RTOL, atol=0)


# ------------------------------------------------------ dispatches and keys


@pytest.mark.parametrize("superstep", ["auto", "off"])
@pytest.mark.parametrize("packed", ["off", "auto"])
def test_dispatches_count_windows_in_scan_mode_and_steps_off_it(bundle, superstep, packed):
    tr = _trainer(bundle, superstep, packed=packed)
    plan, faults = tr._plan_epoch(0)
    tr._dispatch_epoch(plan, faults, 0)
    rec = tr.recorder.meta["supersteps"][0]
    if packed == "auto":
        want = 1 if superstep == "auto" else plan.num_steps  # the JAX fused epoch: one scan
    else:
        want = len(tr._elastic_ranges(plan.num_steps)) if superstep == "auto" else plan.num_steps
    assert plan.num_steps == 8 and want in (1, 4, 8)
    assert rec["dispatches"] == tr._host_meter.dispatches == want
    assert rec["host_dispatch_s"] == tr._host_meter.dispatch_s
    assert rec["eager_runs"] == (plan.num_steps if superstep == "auto" else 0)


def test_a_repeated_plan_adds_no_key(bundle):
    """Equal times keep the plan; the second epoch dispatches only keys
    the first prepared. A new learning rate is a new key."""
    tr = _trainer(bundle, "auto", timing_model=lambda plan: np.ones(4), straggler=None)
    tr.run_epoch(0)
    keys, n = set(tr._superstep_keys), tr.supersteps.superstep_cache_size()
    assert n == len(keys) >= 1
    tr.run_epoch(1)
    assert tr._superstep_keys == keys and tr.supersteps.superstep_cache_size() == n
    assert [r["keys"] for r in tr.recorder.meta["supersteps"]] == [n, n]
    (key,) = keys
    batches = [(torch.zeros(32, 28, 28, 1),)] * 4
    assert tr._step_key("elastic", batches, [0] * 4) == key
    set_learning_rate(tr.optimizer, 0.01)  # the update's alpha is baked into a graph
    assert tr._step_key("elastic", batches, [0] * 4) != key


# ------------------------------------------------------------------ the load


@pytest.mark.parametrize("n", [0, 1, 3])
def test_load_device_count_equals_int_form(n):
    seed = torch.tensor(0.37)
    count = torch.tensor(n, dtype=torch.int32)
    want = synthetic_load(n, seed)
    assert torch.equal(synthetic_load(count, seed), want)
    assert torch.equal(SyntheticLoad()(count, seed), want)


# -------------------------------------------------------- the executor, stubbed


class StubGraph:
    """A graph that records its capture's body and replays nothing."""

    def __init__(self, executor):
        self.captured = 0
        self.replayed = 0

    def capture(self, fn):
        self.captured += 1
        fn()

    def replay(self):
        self.replayed += 1


def _stub_steps(**kw):
    graphs = []

    def factory(executor):
        graphs.append(StubGraph(executor))
        return graphs[-1]

    return StepGraphs("cpu", graph_factory=factory, **kw), graphs


def test_replays_carry_their_capture_launch_counts():
    steps, graphs = _stub_steps()
    calls = {"body": 0, "warm": 0}

    def body(inputs, counts):
        calls["body"] += 1
        runtime.LAUNCHES["xent_fwd"] += 2
        runtime.LAUNCHES["groupnorm_fwd"] += 3

    def warm(inputs, counts):
        calls["warm"] += 1
        runtime.LAUNCHES["xent_fwd"] += 1

    x = torch.arange(6.0).reshape(3, 2)
    runtime.reset_launches()
    for _ in range(3):
        steps.run("a", [(x,)], [0], body, warm)
    steps.run("b", [(x[:1],)], [0], body, warm)
    counts = dict(runtime.LAUNCHES)
    runtime.reset_launches()
    assert calls == {"body": 2, "warm": 2}  # a capture a key, never a Python step after it
    assert [(g.captured, g.replayed) for g in graphs] == [(1, 3), (1, 1)]
    assert counts["xent_fwd"] == 2 * 1 + 4 * 2  # the warm-ups, then 4 replays of 2
    assert counts["groupnorm_fwd"] == 4 * 3
    assert steps.stats()["captures"] == 2 and steps.stats()["replays"] == 4
    assert steps.superstep_cache_size() == 2


def test_slots_take_each_steps_inputs_and_counts():
    steps, _ = _stub_steps()
    seen = []

    def body(inputs, counts):
        seen.append((inputs[0][0], counts[0], counts[1]))

    steps.run("k", [(torch.zeros(2),), None], [5, 0], body, lambda i, c: None)
    slot, count, zero = seen[0]
    assert zero == 0 and count.dtype == torch.int32 and int(count) == 5
    steps.run("k", [(torch.ones(2),), None], [7, 0], body, lambda i, c: None)
    assert len(seen) == 1  # replayed, not run again
    assert torch.equal(slot, torch.ones(2)) and int(count) == 7


def test_warm_up_leaves_the_generators_as_it_found_them():
    gen = torch.Generator().manual_seed(5)
    steps, _ = _stub_steps(generators=[gen])
    want = gen.get_state()
    steps.run("k", [(torch.zeros(1),)], [0], lambda i, c: None,
              lambda i, c: torch.rand(4, generator=gen))
    assert torch.equal(gen.get_state(), want)


def test_a_failed_capture_raises_with_its_key():
    steps, _ = _stub_steps()

    def body(inputs, counts):
        raise RuntimeError("operation not permitted when stream is capturing")

    with pytest.raises(RuntimeError, match=r"\('elastic', 3\)"):
        steps.run(("elastic", 3), [(torch.zeros(1),)], [0], body, lambda i, c: None)
    assert steps.stats()["replays"] == 0 and steps.stats()["eager_runs"] == 0


# --------------------------------------------------------- the step's state


def test_zero_momentum_buffers_equal_clone_on_first_step():
    """``prepare_step_state`` (zero ``.grad`` and buffers before the first
    step) against torch's own first steps (``.grad`` set to None, the
    buffer cloned from the first gradient): the same bits."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 28, 28, 1, generator=gen)
    y = torch.randint(0, 10, (6,), generator=gen)
    w = torch.full((6,), 1.0 / 6)
    models = [MnistNet().eval(), MnistNet().eval()]
    models[1].load_state_dict(models[0].state_dict())
    opts = [make_optimizer(m.parameters(), 0.05) for m in models]
    for _ in range(2):
        elastic_step(models[0], opts[0], [(x[:4], y[:4], w[:4]), (x[4:], y[4:], w[4:])])
        opts[1].zero_grad(set_to_none=True)
        for sl in (slice(0, 4), slice(4, 6)):
            weighted_loss(models[1], x[sl], y[sl], w[sl])[0].backward()
        opts[1].step()
    for p, q in zip(models[0].parameters(), models[1].parameters()):
        assert torch.equal(p, q)
        assert torch.equal(opts[0].state[p]["momentum_buffer"], opts[1].state[q]["momentum_buffer"])
