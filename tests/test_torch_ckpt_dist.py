"""Checkpoints across ranks (``--ckpt_dir`` with ``--num_processes``) and
``--rebalance window`` across ranks, on gloo worlds of CPU processes.

- **Stopped and resumed, bit for bit.** A run stopped after epoch 0 and
  resumed from its checkpoint equals the uninterrupted run exactly
  (parameters, momentum or ZeRO-1 chunk, error-feedback residuals, the step
  counter, every rank's generators, losses and partitions), dropout on: on
  two ranks on the flat combine (window-mode DBS), under ZeRO-1 in window
  mode and on the fused path with ``--grad_accum 2`` and the int8 wire
  (``chip_smoke.py`` [7]'s arm (c)); on four ranks under ``--grad_comm
  hier`` (the tree (2, 2), the int8 outer hop, and int4 with ZeRO-1 on the
  tree, both with residuals); and the language model at [7c]'s
  configuration cut to a 2-layer model on the tiny corpus.
- **Against one process and the JAX package.** Each epoch's checkpoint of
  a 2-rank run (dropout off) holds the parameters and momentum of the
  one-process run's checkpoint of that epoch (``--packed off``: the ranks'
  elastic path), bit for bit (the ranks are bit for bit with one process);
  its sidecar has the JAX package's keys, and
  its shares, node times and fleet equal the JAX trainer's one-process
  sidecar's under the same timing model.
- **Window cadence across ranks.** The JAX trainer, across processes,
  takes the elastic path under ``--rebalance window`` (its config allows
  no ``--fused_dbs`` beside it and needs the balancer, so its fused paths
  do not run, and packed epochs need one process) and its
  ``_window_controller`` warns "rebalance=window is single-process only —
  falling back to epoch cadence" and returns None. The port's 2-rank run
  takes the same path, logs that warning once, on each rank, and equals
  the ``--rebalance epoch`` run bit for bit. Sequence parallelism (ring)
  reads no ``rebalance`` in either package: window equals epoch, with no
  warning.
"""

import json
import os

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.checkpoint import STATE_FILE
from tests._torch_dist_helpers import (
    FACTORS,
    computed_once,
    launch,
    straggler_time,
    trainer,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus

WARNING = "rebalance=window is single-process only — falling back to epoch cadence"
SIDECAR_KEYS = {"shares", "node_times", "total_wallclock", "total_probe_s", "active_ranks"}


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
              dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=256,
              device=[0, 0], log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _lm_kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=2, batch_size=16, learning_rate=0.1, epoch_size=2,
              dataset="wikitext2", model="transformer", seed=1234, bucket=4, bptt=16,
              n_train=2400, grad_clip=0.25, use_flash_attention=True, device=[0, 0],
              lm_data_dir=str(tmp / "corpus"),
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _resume_jobs(name, cfg, tmp, **job):
    """The three jobs of a resume case: the whole run, the run stopped
    after epoch 0 (``--ckpt_dir``), and the resumed run."""
    ck = str(tmp / f"ck_{name}")
    return {f"{name}_full": dict(job, cfg=cfg),
            f"{name}_stop": dict(job, cfg=dict(cfg, ckpt_dir=ck), epochs=1),
            f"{name}_resume": dict(job, cfg=dict(cfg, ckpt_dir=ck))}


# 2 ranks: name -> (config, timing model); 4 ranks likewise
RESUME2 = {
    "flat": ({}, "3,1"),
    "zero1": ({"shard_update": True}, "3,1"),
    "zero1c": ({"dynamic_batch_size": False, "grad_accum": 2, "compress_grads": "int8",
                "shard_update": True}, None),
}
RESUME4 = {
    "hier": ({"grad_comm": "hier", "hier_hosts": 2}, "3,1,1,1"),
    "hierz": ({"grad_comm": "hier", "hier_hosts": 2, "grad_comm_wires": "int4,fp32",
               "shard_update": True}, "3,1,1,1"),
}


def _compute(tmp) -> dict:
    """The 2-rank and 4-rank launches, the one-process run and the JAX
    trainer's one-process run with checkpoints."""
    tmp.mkdir(parents=True, exist_ok=True)
    make_tiny_corpus(tmp / "corpus")
    jobs2 = {}
    for name, (over, timing) in RESUME2.items():
        jobs2.update(_resume_jobs(name, _kw(tmp, name, **over), tmp, kind="train", timing=timing))
    jobs2.update(_resume_jobs("lm", _lm_kw(tmp, "lm"), tmp, kind="lm_train", timing="3,1",
                              dropout=0.2, corpus=str(tmp / "corpus")))
    nodrop = _kw(tmp, "nodrop", ckpt_dir=str(tmp / "ck_nodrop"))
    jobs2["nodrop"] = {"kind": "train", "cfg": nodrop, "timing": "3,1", "no_dropout": True}
    jobs2["window"] = {"kind": "train", "cfg": _kw(tmp, "window", rebalance="window"),
                       "timing": "3,1"}
    sp = dict(debug=True, world_size=2, batch_size=4, learning_rate=0.5, epoch_size=2,
              dataset="wikitext2", model="transformer", seed=1234, bptt=16, n_train=1600,
              lm_data_dir=str(tmp / "corpus"), seq_parallel="ring")
    for cadence in ("window", "epoch"):
        jobs2[f"sp_{cadence}"] = {
            "kind": "sp_train", "corpus": str(tmp / "corpus"), "dropout": 0.0,
            "cfg": dict(sp, rebalance=cadence, log_dir=str(tmp / f"sp_{cadence}" / "logs"),
                        stat_dir=str(tmp / f"sp_{cadence}" / "statis"))}
    world2 = launch(2, jobs2, tmp / "world2", timeout=600)
    jobs4 = {}
    for name, (over, timing) in RESUME4.items():
        cfg = _kw(tmp, name, world_size=4, device=[0, 0, 0, 0], **over)
        jobs4.update(_resume_jobs(name, cfg, tmp, kind="train", timing=timing))
    world4 = launch(4, jobs4, tmp / "world4", timeout=600)
    # one process, the same run (the elastic path, as the ranks') and
    # checkpoints, dropout off
    one = trainer({"cfg": _kw(tmp, "one", ckpt_dir=str(tmp / "ck_one"), packed="off"),
                   "timing": "3,1", "no_dropout": True})
    one.run()
    # the JAX trainer in one process, its sidecars
    jtr = JaxTrainer(JaxConfig(**_kw(tmp, "jax", ckpt_dir=str(tmp / "ck_jax"))),
                     bundle=jax_synthetic("mnist", n_train=256, n_test=256),
                     timing_model=straggler_time(FACTORS["3,1"]), log_to_file=False)
    jtr.run()
    return {"world2": world2, "world4": world4, "dir": str(tmp)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "ckpt_dist", _compute)


def _equal_runs(full, resumed):
    """Rank by rank: the resumed run ends as the whole run, bit for bit,
    and recorded the whole run's last epoch."""
    assert len(full) == len(resumed)
    for a, b in zip(full, resumed):
        for k in a["params"]:
            assert torch.equal(a["params"][k], b["params"][k]), k
        assert set(a["momentum"]) == set(b["momentum"])
        for k in a["momentum"]:
            assert torch.equal(a["momentum"][k], b["momentum"][k]), k
        assert (a["chunk"] is None) == (b["chunk"] is None)
        if a["chunk"] is not None:
            assert float(a["chunk"].abs().max()) > 0 and torch.equal(a["chunk"], b["chunk"])
        assert (a["residuals"] is None) == (b["residuals"] is None)
        for x, y in zip(a["residuals"] or [], b["residuals"] or []):
            assert torch.equal(x, y)
        assert a["steps"] == b["steps"] > 0
        for name, g in a["generators"].items():
            assert torch.equal(g, b["generators"][name]), name
        assert b["data"]["epoch"] == [1]
        for key in ("train_loss", "val_loss", "partition", "accuracy"):
            assert b["data"][key] == a["data"][key][1:], key


@pytest.mark.parametrize("name", list(RESUME2) + ["lm"])
def test_two_ranks_resume_bit_for_bit(runs, name):
    w = runs["world2"]
    full = [r[f"{name}_full"] for r in w]
    _equal_runs(full, [r[f"{name}_resume"] for r in w])
    if name.startswith("zero1"):
        assert all(r["chunk"] is not None for r in full)


@pytest.mark.parametrize("name", list(RESUME4))
def test_four_ranks_hier_resume_bit_for_bit_with_residuals(runs, name):
    w = runs["world4"]
    full = [r[f"{name}_full"] for r in w]
    assert all(r["meta"]["grad_comm"] == "hier" for r in full)
    assert any(float(x.abs().max()) > 0 for r in full for x in r["residuals"])
    _equal_runs(full, [r[f"{name}_resume"] for r in w])


def test_a_checkpoint_holds_the_one_process_state(runs):
    """Each epoch's ``state.pt`` of the 2-rank run (rank 0 wrote it) holds
    the one-process run's parameters and momentum, bit for bit, and the
    state of both ranks' generators."""
    d = runs["dir"]
    for epoch in (0, 1):
        ranks = torch.load(os.path.join(d, "ck_nodrop", str(epoch), STATE_FILE),
                           weights_only=True)
        one = torch.load(os.path.join(d, "ck_one", str(epoch), STATE_FILE), weights_only=True)
        assert ranks["steps"] == one["steps"] > 0
        for part in ("params", "momentum"):
            assert set(ranks[part]) == set(one[part])
            for k in one[part]:
                assert torch.equal(ranks[part][k], one[part][k]), (epoch, part, k)
        assert len(ranks["ranks"]["generators"]) == 2 and "ranks" not in one
    assert sorted(os.listdir(os.path.join(d, "ck_nodrop"))) == [
        "0", "1", "controller_0.json", "controller_1.json"]


def test_the_sidecar_holds_the_jax_keys_and_vectors(runs):
    d = runs["dir"]
    for epoch in (0, 1):
        with open(os.path.join(d, "ck_nodrop", f"controller_{epoch}.json")) as f:
            got = json.load(f)
        with open(os.path.join(d, "ck_jax", f"controller_{epoch}.json")) as f:
            want = json.load(f)
        assert set(got) == set(want) == SIDECAR_KEYS
        for key in ("shares", "node_times", "active_ranks"):
            assert got[key] == want[key], (epoch, key)
    assert got["shares"][0] < 0.5  # the 3:1 straggler's share moved


def test_window_cadence_across_ranks_falls_back_as_the_jax_trainer(runs):
    w = runs["world2"]
    for r in w:
        win, epoch = r["window"], r["flat_full"]
        assert win["warnings"].count(WARNING) == 1 and WARNING not in epoch["warnings"]
        assert win["meta"]["paths"] == epoch["meta"]["paths"] == ["elastic", "elastic"]
        assert "plan_switches" not in win["data"]
        for k in epoch["params"]:
            assert torch.equal(win["params"][k], epoch["params"][k]), k
        for key in ("train_loss", "val_loss", "partition", "node_time"):
            assert win["data"][key] == epoch["data"][key], key
    assert w[0]["window"]["data"]["partition"][-1][0] < 0.5


def test_sequence_parallel_runs_the_window_flag_at_epoch_cadence(runs):
    for r in runs["world2"]:
        win, epoch = r["sp_window"], r["sp_epoch"]
        assert WARNING not in win["warnings"]
        for k in epoch["params"]:
            assert torch.equal(win["params"][k], epoch["params"][k]), k
        assert win["data"]["train_loss"] == epoch["data"]["train_loss"]
        assert np.isfinite(win["data"]["train_loss"]).all()
