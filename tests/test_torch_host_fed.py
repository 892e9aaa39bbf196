"""The host-fed path (``--device_cache off``) against the resident one and
against the JAX trainer's host-fed run, on the CPU.

Under ``--device_cache off`` the training set stays on the host: the packed
and elastic epochs of one process gather each window's rows with the C++
``take_rows`` into a staging slot and stage it through the transfer
pipeline (``train/pipeline.py``). The rows, their order, the weights and
the augmentation's draws are the resident path's, so the run equals its
``on`` twin bit for bit: parameters, momentum, train and validation
losses, partitions. Each case runs MnistNet, 4 workers, B = 128, windows
of 2 steps (``--stream_chunk_steps 2``), with augmentation on (a trainer
that turns it on for this image set, as ``tests/test_torch_online_dbs.py``
does), under a deterministic timing model:

- packed, under ``--superstep auto`` and ``off``;
- elastic (``--packed off``), scan and eager, DBS with a 3:1 straggler;
- ``--rebalance window`` with a ``sin`` straggler that switches mid-epoch:
  the same switch events on the same steps;
- ``--elastic on`` with worker 3 lost mid-epoch 1 and readmitted at epoch 3;
- the probes, which take the first window's rows (their batches recorded);
- validation, streamed by chunks from host memory.

Against the JAX ``Trainer`` at ``device_cache="off"`` (MnistNet ``-ws 4``,
``tests/test_device_cache.py``'s recipe, one device, both packages from the
JAX trainer's weights, dropout off on both sides): packed and elastic, the
``partition`` and ``node_time`` series equal, as ``tests/test_torch_engine.py``
holds them; train and validation losses within rtol 1e-5
(``tests/test_torch_online_dbs.py``'s tolerance: the packages sum
per-example losses in another order) of the JAX elastic run's, the one of
the JAX package's two paths that the port's packed and elastic epochs both
follow. ``_decide_device_cache`` gives the JAX package's answers.
"""

import logging

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
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch import faults
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from tests._torch_dist_helpers import computed_once
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_online_dbs import _MnistNetNoDropout

LOSS_RTOL = 1e-5
FACTORS = [3.0, 1.0, 1.0, 1.0]


class AugTrainer(Trainer):
    """Augmentation on for an image set that has none by default, so that
    the augmentation stream is under test; the probes' batches recorded
    (cloned) before they run."""

    def _setup_model(self) -> None:
        super()._setup_model()
        self.augment = True
        self.probed = []

    def _probe_workers(self, plan, batches, faults, epoch, reps=3):
        self.probed.append([None if b is None else tuple(t.clone() for t in b)
                            for b in batches])
        return super()._probe_workers(plan, batches, faults, epoch, reps=1)


def _linear(factors):
    return lambda plan: np.asarray(factors) * np.array(
        [w.batch_size * w.steps * 1e-3 for w in plan.workers])


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=2,
              dataset="mnist", model="mnistnet", seed=1234, bucket=8, stream_chunk_steps=2,
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _bundle():
    return synthetic_dataset("mnist", n_train=1024, n_test=300)


def _run(tmp, tag, cache, injector=None, timing="linear", epochs=None, **over):
    cfg = Config(**_kw(tmp, f"{tag}-{cache}", device_cache=cache, **over))
    holder = {}
    if timing == "linear":
        tm = _linear(FACTORS)
    elif timing == "fleet":  # per original worker, following the live fleet
        def tm(plan):
            f = np.asarray(FACTORS)[np.asarray(holder["tr"].active_ranks)]
            return f * np.array([w.batch_size * w.steps * 1e-3 for w in plan.workers])
    else:
        tm = None
    inj = injector() if injector else faults.StaticStragglerInjector(FACTORS, mode="virtual")
    tr = AugTrainer(cfg, bundle=_bundle(), injector=inj, timing_model=tm, device="cpu",
                    log_to_file=False)
    holder["tr"] = tr
    rec = tr.run(epochs)
    return tr, rec


def _assert_twins(on, off):
    (a, ra), (b, rb) = on, off
    assert a._use_device_cache and not b._use_device_cache
    for key in ("train_loss", "val_loss", "accuracy", "partition", "node_time"):
        assert ra.data[key] == rb.data[key], key
    assert ra.meta["paths"] == rb.meta["paths"]
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)
        assert torch.equal(a.optimizer.state[p]["momentum_buffer"],
                           b.optimizer.state[q]["momentum_buffer"])
    assert b._train_dev is None  # nothing of the training set uploaded whole
    assert all(v > 0 for v in rb.data["host_put_s"]) and ra.data["host_put_s"] == [0.0] * len(
        ra.data["host_put_s"])


def _twins(tmp, tag, **kw):
    return _run(tmp, tag, "on", **kw), _run(tmp, tag, "off", **kw)


@pytest.mark.parametrize("superstep", ["auto", "off"])
def test_packed_off_equals_on(tmp_path, superstep):
    on, off = _twins(tmp_path, "packed", superstep=superstep)
    assert off[1].meta["paths"] == ["packed", "packed"]
    _assert_twins(on, off)
    ran = off[1].meta["supersteps"]
    assert [r["windows"] for r in ran] == [len(off[0]._chunk_ranges(r["steps"])) for r in ran]
    assert all(r["windows"] > 1 for r in ran)


@pytest.mark.parametrize("superstep", ["auto", "off"])
def test_elastic_off_equals_on(tmp_path, superstep):
    on, off = _twins(tmp_path, "elastic", superstep=superstep, packed="off",
                     dynamic_batch_size=True)
    assert off[1].meta["paths"] == ["elastic", "elastic"]
    assert off[1].data["partition"][-1][0] < 0.25  # the straggler's share fell
    _assert_twins(on, off)


def test_window_switches_land_on_the_same_steps(tmp_path):
    kw = dict(epoch_size=2, packed="off", superstep_window=2, straggler="8,1,1,1",
              fault_schedule="sin", fault_period=1.0, rebalance="window", rebalance_every=1,
              dynamic_batch_size=True)
    make = (lambda: faults.ScheduledStragglerInjector([8.0, 1, 1, 1], mode="virtual",
                                                       schedule="sin", period=1.0, seed=1234))
    on, off = _twins(tmp_path, "window", injector=make, **kw)
    events = [{k: e[k] for k in ("epoch", "window", "step", "batches")}
              for e in off[1].meta["rebalance_events"]]
    assert events, "the sin schedule must switch mid-epoch"
    assert events == [{k: e[k] for k in ("epoch", "window", "step", "batches")}
                      for e in on[1].meta["rebalance_events"]]
    assert on[1].data["plan_switches"] == off[1].data["plan_switches"]
    _assert_twins(on, off)


def test_elastic_recovery_from_a_lost_worker(tmp_path):
    def make():
        return faults.PreemptionInjector(4, [faults.PreemptionEvent(
            worker=3, down_at=1.4, rejoin_epoch=3)])

    on, off = _twins(tmp_path, "lost", injector=make, timing="fleet", epoch_size=4,
                     packed="off", elastic="on", stream_chunk_steps=1, batch_size=64,
                     dynamic_batch_size=True)
    assert off[1].data["workers_alive"] == [4, 3, 3, 4]
    assert [e.get("lost") for e in off[1].meta["elastic_events"]][:1] == [[3]]
    assert len(on[1].meta["elastic_events"]) == len(off[1].meta["elastic_events"])
    for a, b in zip(on[1].meta["elastic_events"], off[1].meta["elastic_events"]):
        assert {k: a[k] for k in ("epoch", "lost", "world_size") if k in a} == {
            k: b[k] for k in ("epoch", "lost", "world_size") if k in b}
    _assert_twins(on, off)
    assert off[0]._live_pipeline is None


@pytest.mark.parametrize("packed", ["auto", "off"])
def test_probes_take_the_first_windows_rows(tmp_path, packed):
    """Real probes (no timing model) after the first epoch, which both runs
    start from the same shares: the probed batches are the resident run's,
    bit for bit, on each path (the next epoch's shares follow the walls,
    which differ between runs)."""
    on, off = _twins(tmp_path, f"probe-{packed}", timing=None, epoch_size=1, packed=packed,
                     dynamic_batch_size=True)
    (a, _), (b, _) = on, off
    assert len(a.probed) == len(b.probed) == 1
    for x, y in zip(a.probed[0], b.probed[0]):
        assert (x is None) == (y is None)
        if x is not None:
            assert all(torch.equal(u, v) for u, v in zip(x, y))
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)


def test_validation_streams_from_the_host(tmp_path):
    (a, _), (b, _) = _twins(tmp_path, "val", epoch_size=1)
    assert b.test_x.device.type == "cpu" and not b._use_device_cache
    assert a.validate() == b.validate()


# ------------------------------------------------------ the device-cache decision


@pytest.mark.parametrize("cache,mb,want", [
    ("auto", 512, True), ("auto", 1, False), ("on", 1, True), ("off", 512, False),
    ("on", 512, True), ("off", 1, False),
])
def test_decide_device_cache_gives_the_jax_answers(tmp_path, cache, mb, want):
    bundle = synthetic_dataset("mnist", n_train=2048, n_test=64)  # 1.6 MB of rows
    kw = dict(debug=True, world_size=2, batch_size=64, dataset="mnist", model="mnistnet",
              device_cache=cache, device_cache_mb=mb, log_dir=str(tmp_path / "l"),
              stat_dir=str(tmp_path / "s"))
    tr = Trainer(Config(**kw), bundle=bundle, device="cpu", log_to_file=False)
    jtr = JaxTrainer.__new__(JaxTrainer)
    jtr.cfg, jtr.bundle = JaxConfig(**kw), jax_synthetic("mnist", n_train=2048, n_test=64)
    jtr.logger = logging.getLogger("jax-decide")
    assert tr._use_device_cache == JaxTrainer._decide_device_cache(jtr) == want


@pytest.mark.parametrize("cache", ["on", "auto", "off"])
def test_the_language_model_has_nothing_to_cache(tmp_path, cache, caplog):
    make_tiny_corpus(tmp_path / "corpus")
    kw = dict(debug=True, world_size=2, batch_size=16, dataset="wikitext2",
              model="transformer", bptt=16, device_cache=cache,
              lm_data_dir=str(tmp_path / "corpus"), log_dir=str(tmp_path / "l"),
              stat_dir=str(tmp_path / "s"))
    logger = logging.getLogger("test_torch_host_fed.lm")
    with caplog.at_level(logging.INFO, logger=logger.name):
        tr = LMTrainer(Config(**kw), bundle=Corpus(str(tmp_path / "corpus")), device="cpu",
                       logger=logger)
        assert not tr._feeds_from_host("elastic")
    assert not tr._use_device_cache and not tr._host_feed
    jtr = JaxTrainer.__new__(JaxTrainer)
    jtr.cfg, jtr.bundle, jtr.logger = JaxConfig(**kw), None, logging.getLogger("jax-lm")
    assert JaxTrainer._decide_device_cache(jtr) is False
    warned = "device_cache=on ignored: no cacheable train arrays" in caplog.text
    assert warned == (cache == "on")
    assert ("keeps its training data on the device" in caplog.text) == (cache == "off")


# ------------------------------------------------------------- the JAX trainer


def _jax_kw(tmp, tag, packed):
    return dict(debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=2,
                dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=1234,
                bucket=8, device_cache="off", device=0, packed=packed, stream_chunk_steps=2,
                superstep="auto", superstep_window=2, aot_warm=False,
                log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))


def _jax_time(plan):
    return np.array([2.0, 1.0, 1.0, 1.0]) * np.array(
        [w.batch_size * w.steps for w in plan.workers])


def _compute_jax(tmp):
    tmp.mkdir(parents=True, exist_ok=True)
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    out = {}
    try:
        for packed in ("auto", "off"):
            tr = JaxTrainer(JaxConfig(**_jax_kw(tmp, packed, packed)),
                            bundle=jax_synthetic("mnist", n_train=1024, n_test=256),
                            injector=JaxStraggler([2.0, 1.0, 1.0, 1.0], mode="virtual"),
                            timing_model=_jax_time, log_to_file=False)
            init = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tr.state.params)
            assert not tr._use_device_cache
            rec = tr.run()
            out[packed] = {"init": init, "data": {k: list(v) for k, v in rec.data.items()},
                           "paths": list(rec.meta.get("paths", []))}
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "host_fed_jax", _compute_jax)


@pytest.mark.parametrize("packed", ["auto", "off"])
def test_host_fed_run_follows_the_jax_trainer(tmp_path, jax_runs, packed):
    want = jax_runs[packed]
    cfg = Config(**{k: v for k, v in _jax_kw(tmp_path, "port", packed).items()
                    if k not in ("device", "aot_warm")})
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=1024, n_test=256),
                 injector=faults.StaticStragglerInjector([2.0, 1.0, 1.0, 1.0], mode="virtual"),
                 timing_model=_jax_time, device="cpu", log_to_file=False)
    tr.model.load_state_dict(params_from_flax(want["init"], tr.model))
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    rec = tr.run()
    assert not tr._use_device_cache and tr._train_dev is None
    assert rec.meta["paths"] == ["packed" if packed == "auto" else "elastic"] * 2
    for key in ("partition", "node_time"):
        assert rec.data[key] == want["data"][key], key
    # the losses against the JAX elastic run: the JAX packed epoch (its
    # fused scan) trains its second epoch 6e-5 (relative) off its own
    # elastic epoch, with or without the cache, where the port's packed and
    # elastic epochs agree to 3e-8
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose(rec.data[key], jax_runs["off"]["data"][key], rtol=LOSS_RTOL,
                                   atol=0)


def test_off_reaches_no_other_path_yet(tmp_path, caplog):
    """The fused path (one worker a device) keeps its rows on the device
    under cache off, uploaded once at its first use, and says so once."""
    kw = _kw(tmp_path, "fused", device_cache="off", world_size=1, dynamic_batch_size=False,
             epoch_size=2, batch_size=64)
    logger = logging.getLogger("test_torch_host_fed.fused")
    with caplog.at_level(logging.INFO, logger=logger.name):
        tr = Trainer(Config(**kw), bundle=_bundle(), device="cpu", logger=logger)
        rec = tr.run()
    assert rec.meta["paths"] == ["fused", "fused"]
    assert caplog.text.count("keeps its training data on the device") == 1
