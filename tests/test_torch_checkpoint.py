"""Checkpoint and resume (``--ckpt_dir``, ``train/checkpoint.py``) on the CPU.

- **Round trip**: a fresh trainer restores the epoch, every parameter and
  momentum buffer, the step counter, the generators' states and the
  sidecar's controller state exactly; the sidecar has the JAX package's
  keys and, under the same timing model, its shares and node times.
- **Against the JAX package**: MnistNet (2 workers, packed, the default
  path) and a 2-layer, 16-wide language model (elastic, clip 0.25), each
  stopped after epoch 0 and resumed for epoch 1 from the JAX trainer's
  initial weights (``bridge.py``), dropout off on both sides: the JAX
  package's resumed run first equals its uninterrupted one bit for bit;
  then the port's resumed run ends within the engine parity tolerances of
  the JAX package's resumed run (parameters atol 1e-5 as
  ``tests/test_torch_steps.py``, losses rtol 1e-5 as
  ``tests/test_torch_supersteps.py``; partitions equal).
- **Bit for bit against the port itself**: a run stopped and resumed equals
  the uninterrupted run exactly (parameters, momentum, losses, partitions),
  dropout on, under ``--superstep auto`` (on the CPU its eager executor)
  and ``off``, in f32 and bf16, for both models: the dropout generator's
  state travels with the checkpoint.
- **Addresses**: a restore writes into the live parameters and momentum
  buffers (``data_ptr()`` unchanged) and drops captured step graphs.
- An absent or empty ``ckpt_dir`` restores nothing; a half-written
  checkpoint is never the latest; a checkpoint of another model raises; the
  last 3 epochs are kept; the ``cli`` resumes.

No test here waits on a clock.
"""

import json
import os

import jax
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
from dynamic_load_balance_distributeddnn_tpu.train.lm_engine import LMTrainer as JaxLMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.train.checkpoint import (
    restore_checkpoint,
    save_checkpoint,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_online_dbs import _MnistNetNoDropout

PARAM_ATOL = 1e-5  # tests/test_torch_steps.py's parameters after SGD steps
LOSS_RTOL = 1e-5  # tests/test_torch_supersteps.py's train losses
SIDECAR_KEYS = {"shares", "node_times", "total_wallclock", "total_probe_s", "active_ranks"}


def linear_time(plan):
    f = [3.0, 1.0, 1.0, 1.0][: len(plan.workers)]
    return np.array(f) * np.array([w.batch_size * w.steps for w in plan.workers]) * 1e-3


def _vision_kw(tmp, tag, **kw):
    base = dict(
        debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=256, device=0,
        stat_dir=str(tmp / tag / "statis"), log_dir=str(tmp / tag / "logs"),
    )
    base.update(kw)
    return base


def _lm_kw(tmp, tag, **kw):
    base = dict(
        debug=True, world_size=2, batch_size=20, learning_rate=0.05, epoch_size=2,
        dataset="wikitext2", model="transformer", bucket=4, bptt=16, straggler="3,1",
        fault_mode="virtual", device=0, superstep_window=2,
        stat_dir=str(tmp / tag / "statis"), log_dir=str(tmp / tag / "logs"),
    )
    base.update(kw)
    return base


class SmallJaxLM(JaxLMTrainer):
    EMSIZE = 16
    NHID = 16
    DROPOUT = 0.0


class SmallLM(LMTrainer):
    EMSIZE = 16
    NHID = 16


class SmallLMNoDropout(SmallLM):
    DROPOUT = 0.0


def _port(kind, tmp, tag, cls=None, **kw):
    if kind == "vision":
        cfg = Config(**_vision_kw(tmp, tag, **kw))
        return (cls or Trainer)(cfg, bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                                timing_model=linear_time, device="cpu", log_to_file=False)
    cfg = Config(**_lm_kw(tmp, tag, **kw))
    if not (tmp / "corpus").exists():
        make_tiny_corpus(tmp / "corpus")
    return (cls or SmallLM)(cfg, bundle=Corpus(str(tmp / "corpus")), timing_model=linear_time,
                            device="cpu", log_to_file=False)


def _state(tr):
    params = {n: p.detach().clone() for n, p in tr.model.named_parameters()}
    mom = {n: tr.optimizer.state[p]["momentum_buffer"].clone()
           for n, p in tr.model.named_parameters()}
    return params, mom


def _assert_bitwise(a, b):
    (pa, ma), (pb, mb) = _state(a), _state(b)
    for n in pa:
        assert torch.equal(pa[n], pb[n]), n
        assert torch.equal(ma[n], mb[n]), n


# ------------------------------------------------------------- round trip


def test_round_trip_restores_the_state_and_the_sidecar(tmp_path):
    ck = str(tmp_path / "ck")
    tr = _port("vision", tmp_path, "a", ckpt_dir=ck, straggler="3,1")
    tr.run()
    fresh = _port("vision", tmp_path, "b", ckpt_dir=ck, straggler="3,1")
    assert fresh._maybe_restore() == 2
    _assert_bitwise(tr, fresh)
    assert fresh.steps_done == tr.steps_done > 0
    for name, g in tr._generators().items():
        assert torch.equal(g.get_state(), fresh._generators()[name].get_state()), name
    assert fresh.shares.tolist() == tr.shares.tolist() and tr.shares[0] < 0.5
    assert fresh.node_times.tolist() == tr.node_times.tolist()
    assert (fresh.total_wallclock, fresh.total_probe_s) == (tr.total_wallclock, tr.total_probe_s)
    with open(os.path.join(ck, "controller_1.json")) as f:
        side = json.load(f)
    assert set(side) == SIDECAR_KEYS and side["active_ranks"] == [0, 1]
    assert sorted(os.listdir(ck)) == ["0", "1", "controller_0.json", "controller_1.json"]


def test_absent_or_empty_ckpt_dir_restores_nothing(tmp_path):
    (tmp_path / "empty").mkdir()
    for ck in (tmp_path / "absent", tmp_path / "empty"):
        tr = _port("vision", tmp_path, "x", ckpt_dir=str(ck))
        before, _ = _state_after_prepare(tr)
        assert tr._maybe_restore() == 0
        assert "checkpoint" not in tr.recorder.meta and tr.steps_done == 0
        for n, p in tr.model.named_parameters():
            assert torch.equal(p, before[n])


def _state_after_prepare(tr):
    from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import prepare_step_state

    prepare_step_state(tr.optimizer)
    return _state(tr)


def test_restore_writes_in_place_and_drops_captured_graphs(tmp_path):
    ck = str(tmp_path / "ck")
    tr = _port("vision", tmp_path, "a", ckpt_dir=ck, epoch_size=1)
    tr.run()
    saved, saved_mom = _state(tr)
    ptrs = [(p.data_ptr(), tr.optimizer.state[p]["momentum_buffer"].data_ptr())
            for p in tr.model.parameters()]
    assert tr.supersteps.superstep_cache_size() > 0
    with torch.no_grad():
        for p in tr.model.parameters():
            p.add_(1.0)
            tr.optimizer.state[p]["momentum_buffer"].mul_(2.0)
    assert tr._maybe_restore() == 1
    assert ptrs == [(p.data_ptr(), tr.optimizer.state[p]["momentum_buffer"].data_ptr())
                    for p in tr.model.parameters()]
    params, mom = _state(tr)
    for n in saved:
        assert torch.equal(params[n], saved[n]) and torch.equal(mom[n], saved_mom[n]), n
    assert tr.supersteps.superstep_cache_size() == 0


def test_half_written_checkpoint_is_never_the_latest(tmp_path):
    ck = tmp_path / "ck"
    tr = _port("vision", tmp_path, "a", ckpt_dir=str(ck), epoch_size=1)
    tr.run()
    (ck / ".tmp-5-1").mkdir()
    (ck / ".tmp-5-1" / "state.pt").write_bytes(b"torn")
    (ck / "7").mkdir()  # a directory with no state file
    fresh = _port("vision", tmp_path, "b", ckpt_dir=str(ck))
    assert fresh._maybe_restore() == 1


def test_a_checkpoint_of_another_model_raises(tmp_path):
    ck = str(tmp_path / "ck")
    tr = _port("vision", tmp_path, "a")
    _state_after_prepare(tr)
    save_checkpoint(ck, 0, tr.model, tr.optimizer, {"shares": [0.5, 0.5]})
    lm = _port("lm", tmp_path, "b")
    _state_after_prepare(lm)
    with pytest.raises(ValueError, match="do not match"):
        restore_checkpoint(ck, lm.model, lm.optimizer)


def test_the_last_three_epochs_are_kept(tmp_path):
    ck = tmp_path / "ck"
    _port("vision", tmp_path, "a", ckpt_dir=str(ck), epoch_size=5, n_train=128).run()
    dirs = sorted(n for n in os.listdir(ck) if n.isdigit())
    assert dirs == ["2", "3", "4"]
    assert all((ck / f"controller_{e}.json").exists() for e in range(5))  # as the JAX package


def test_cli_resumes_from_the_checkpoint(tmp_path):
    base = (f"-m mnistnet -ds mnist -ws 2 -b 64 --n_train 256 --ckpt_dir {tmp_path}/ck "
            f"--log_dir {tmp_path}/logs --stat_dir {tmp_path}/statis").split()
    assert cli.main(base + ["-e", "1"], device="cpu") == 0
    assert cli.main(base + ["-e", "2"], device="cpu") == 0
    stem = Config(model="mnistnet", dataset="mnist", world_size=2, batch_size=64,
                  epoch_size=2).base_filename().format(0)
    with open(tmp_path / "statis" / (stem + ".json")) as f:
        series = json.load(f)
    assert series["epoch"] == [1] and series["_meta"]["checkpoint"]["restored_epoch"] == 0


# --------------------------------------------------------- against the JAX package


def _jax_leaves_equal(a, b):
    la, lb = jax.tree_util.tree_leaves(a), jax.tree_util.tree_leaves(b)
    return len(la) == len(lb) and all(np.array_equal(np.asarray(x), np.asarray(y))
                                      for x, y in zip(la, lb))


def _jax_trainer(kind, tmp, tag, **kw):
    if kind == "vision":
        return JaxTrainer(JaxConfig(**_vision_kw(tmp, tag, **kw)),
                          bundle=jax_synthetic("mnist", n_train=256, n_test=64),
                          timing_model=linear_time, log_to_file=False)
    if not (tmp / "corpus").exists():
        make_tiny_corpus(tmp / "corpus")
    from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus

    return SmallJaxLM(JaxConfig(**_lm_kw(tmp, tag, **kw)), bundle=JaxCorpus(str(tmp / "corpus")),
                      timing_model=linear_time, log_to_file=False)


@pytest.fixture(scope="module", params=["vision", "lm"])
def jax_resume(request, tmp_path_factory):
    """The JAX package's runs of one model, dropout off: uninterrupted,
    stopped after epoch 0, resumed for epoch 1; and the port's stopped and
    resumed runs from the same initial weights."""
    kind, tmp = request.param, tmp_path_factory.mktemp(f"jax_{request.param}")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    try:
        full = _jax_trainer(kind, tmp, "full")
        # a host copy: the run donates the state's buffers
        init = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), full.state.params)
        full.run()
        ck = str(tmp / "jck")
        _jax_trainer(kind, tmp, "stop", ckpt_dir=ck).run(epochs=1)
        resumed = _jax_trainer(kind, tmp, "resumed", ckpt_dir=ck)
        resumed.run()
    finally:
        mp.undo()
    cls = SmallLMNoDropout if kind == "lm" else None
    pck = str(tmp / "pck")
    stop = _port(kind, tmp, "pstop", cls=cls, ckpt_dir=pck)
    stop.model.load_state_dict(params_from_flax(init, stop.model))
    for m in stop.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    stop.run(epochs=1)
    port = _port(kind, tmp, "presumed", cls=cls, ckpt_dir=pck)
    for m in port.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    port.run()
    return kind, full, resumed, port, ck


def test_the_jax_resumed_run_equals_its_uninterrupted_run(jax_resume):
    _, full, resumed, _, _ = jax_resume
    assert _jax_leaves_equal(full.state.params, resumed.state.params)
    assert _jax_leaves_equal(full.state.opt_state, resumed.state.opt_state)


def test_the_port_resumes_as_the_jax_package_resumes(jax_resume):
    kind, _, jres, port, _ = jax_resume
    assert port.recorder.data["epoch"] == jres.recorder.data["epoch"] == [1]
    assert port.recorder.data["partition"] == jres.recorder.data["partition"]
    np.testing.assert_allclose(port.recorder.data["train_loss"], jres.recorder.data["train_loss"],
                               rtol=LOSS_RTOL, atol=0)
    want = params_from_flax(jres.state.params, port.model)
    for name, p in port.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=PARAM_ATOL,
                                   rtol=0, err_msg=name)


def test_the_sidecar_holds_the_jax_keys_and_vectors(jax_resume, tmp_path):
    kind, _, _, port, ck = jax_resume
    with open(os.path.join(ck, "controller_0.json")) as f:
        want = json.load(f)
    with open(os.path.join(port.cfg.ckpt_dir, "controller_0.json")) as f:
        got = json.load(f)
    assert set(got) == set(want) == SIDECAR_KEYS
    assert got["shares"] == want["shares"] and got["node_times"] == want["node_times"]
    assert got["active_ranks"] == want["active_ranks"]


# ------------------------------------------------------ bit for bit, the port


@pytest.mark.parametrize("precision", ["float32", "bfloat16"])
@pytest.mark.parametrize("superstep", ["auto", "off"])
@pytest.mark.parametrize("kind", ["vision", "lm"])
def test_resumed_run_equals_the_uninterrupted_run_bit_for_bit(tmp_path, kind, superstep,
                                                              precision):
    kw = dict(superstep=superstep, precision=precision)
    full = _port(kind, tmp_path, "full", **kw)
    full.run()
    ck = str(tmp_path / "ck")
    _port(kind, tmp_path, "stop", ckpt_dir=ck, **kw).run(epochs=1)
    resumed = _port(kind, tmp_path, "resumed", ckpt_dir=ck, **kw)
    assert any(isinstance(m, Dropout) and m.p > 0 for m in resumed.model.modules())
    resumed.run()
    _assert_bitwise(full, resumed)
    assert resumed.recorder.data["train_loss"] == full.recorder.data["train_loss"][1:]
    assert resumed.recorder.data["partition"] == full.recorder.data["partition"][1:]
    assert resumed.steps_done == full.steps_done
    assert torch.equal(resumed.dropout_gen.get_state(), full.dropout_gen.get_state())


@pytest.mark.parametrize("over,timing", [
    ({"world_size": 1, "dynamic_batch_size": False, "shard_update": True}, None),
    ({"shard_update": True, "compress_grads": "int8", "fused_dbs": True}, linear_time),
], ids=["fused", "window"])
def test_shard_update_resumes_bit_for_bit(tmp_path, over, timing):
    """``--shard_update`` in one process keeps the momentum in its ZeRO-1
    chunk (``train/combine.py``), not in the optimizer: the checkpoint saves
    it by parameter name, and the resumed run equals the uninterrupted one
    (parameters, the chunk, losses), on the fused path (``-ws 1 -dbs
    false``) and in window mode (two workers on one device, the int8 wire)."""

    def port(tag, **kw):
        cfg = Config(**_vision_kw(tmp_path, tag, **over, **kw))
        return Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                       timing_model=timing, device="cpu", log_to_file=False)

    full = port("full")
    full.run()
    ck = str(tmp_path / "ck")
    port("stop", ckpt_dir=ck).run(epochs=1)
    resumed = port("resumed", ckpt_dir=ck)
    resumed.run()
    rc = full._rank_combine
    assert rc is not None and rc.shard_update and float(rc.mom.abs().max()) > 0
    for (n, p), q in zip(full.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), n
    assert torch.equal(rc.mom, resumed._rank_combine.mom)
    assert resumed.recorder.data["train_loss"] == full.recorder.data["train_loss"][1:]
