"""The port's Trainer against the JAX package's, end to end on the CPU.

Both trainers run MnistNet on the same synthetic FashionMNIST stand-in with
2 workers, 512 training examples and 3 epochs, under the same deterministic
``timing_model`` (a 3:1 straggler profile). The solver and partitioner are
copies, not approximations, so the ``partition`` and ``node_time`` series
must be *equal*. The port writes the reference's 9 series under the same
config-encoded file name, its loss falls, and the cli skips a finished run.
"""

import json
import os

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

FACTORS = (3.0, 1.0)


def straggler_time(plan):
    """Deterministic compute model: time ∝ examples, worker 0 three times
    slower per example."""
    return np.array(
        [f * w.batch_size * w.steps * 1e-3 for f, w in zip(FACTORS, plan.workers)]
    )


def _kw(tmp_path, tag):
    return dict(
        debug=True, world_size=2, batch_size=64, learning_rate=0.05,
        epoch_size=3, dataset="mnist", model="mnistnet", seed=1234, bucket=8,
        n_train=512, log_dir=str(tmp_path / tag / "logs"),
        stat_dir=str(tmp_path / tag / "statis"),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("engine")
    jcfg = JaxConfig(**_kw(tmp, "jax"))
    jrec = JaxTrainer(
        jcfg, bundle=jax_synthetic("mnist", n_train=512, n_test=256),
        timing_model=straggler_time, log_to_file=False,
    ).run()
    cfg = Config(**_kw(tmp, "torch"))
    rec = Trainer(
        cfg, bundle=synthetic_dataset("mnist", n_train=512, n_test=256),
        timing_model=straggler_time, device="cpu", log_to_file=False,
    ).run()
    return jcfg, jrec, cfg, rec


def test_partition_and_node_time_series_equal_the_jax_trainer(runs):
    _, jrec, _, rec = runs
    assert rec.data["partition"] == jrec.data["partition"]
    assert rec.data["node_time"] == jrec.data["node_time"]
    assert rec.data["partition"][-1][0] < 0.5  # share moved off the straggler


def test_nine_series_under_the_jax_file_name(runs):
    jcfg, _, cfg, rec = runs
    assert cfg.base_filename() == jcfg.base_filename()
    stem = cfg.base_filename().format(0)
    with open(os.path.join(cfg.stat_dir, stem + ".json")) as f:
        saved = json.load(f)
    saved_npy = np.load(os.path.join(cfg.stat_dir, stem + ".npy"), allow_pickle=True).item()
    for k in SERIES:
        assert len(saved[k]) == 3 and len(saved_npy[k]) == 3, k


def test_train_loss_falls(runs):
    losses = runs[3].data["train_loss"]
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]


def test_cli_skips_a_finished_run(tmp_path, capsys):
    argv = [
        "-m", "mnistnet", "-ds", "mnist", "-ws", "2", "-b", "64", "-e", "1",
        "--n_train", "256", "--log_dir", str(tmp_path / "logs"),
        "--stat_dir", str(tmp_path / "statis"),
    ]
    assert cli.main(argv, device="cpu") == 0
    assert len(os.listdir(tmp_path / "statis")) == 2  # .npy + .json
    capsys.readouterr()
    assert cli.main(argv, device="cpu") == 0
    assert "Had finished this experiment, skipping" in capsys.readouterr().out


def test_wall_clock_probes_feed_the_solver(tmp_path):
    """Without a timing model the probes time each worker on the device; a
    3:1 virtual straggler must pull worker 0's share below uniform."""
    cfg = Config(**dict(_kw(tmp_path, "probe"), straggler="3,1", epoch_size=2))
    rec = Trainer(
        cfg, bundle=synthetic_dataset("mnist", n_train=512, n_test=128),
        device="cpu", log_to_file=False,
    ).run()
    assert rec.data["partition"][-1][0] < 0.5
    assert all(t > 0 for t in rec.data["node_time"][-1])
    assert rec.data["sync_time"][-1] > 0
