"""The rank launcher (``scripts/rank_launch.py``) and the cli across ranks, on the CPU.

- ``run_cli_ranks`` starts two processes that join one process group on a
  free localhost port and run the cli (``--num_processes 2``,
  ``--process_id i``, gloo on the CPU) on MnistNet; each rank's report lies beside the run's statistics
  (``cli.rank_report_file``), and the ranks end with equal parameters.
- ``launch_ranks`` fails a launch when a rank fails (the others killed at
  once, each rank's output in the error) and when the ranks outlive the
  timeout.
"""

import os
import sys
import time

import pytest

from dynamic_load_balance_distributeddnn_tpu_torch.cli import rank_report_file
from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
from scripts.rank_launch import RanksFailed, launch_ranks, run_cli_ranks

FLAGS = ["-d", "true", "-m", "mnistnet", "-ds", "mnist", "-ws", "2", "-b", "64", "-e", "1",
         "--n_train", "256", "-gpu", "0,0"]


def test_cli_ranks_write_their_reports_beside_the_statistics(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    reports, wall, argv0 = run_cli_ranks(FLAGS, 2, str(tmp_path), timeout=240, device="cpu")
    assert wall > 0
    cfg = config_from_args(argv0)
    assert os.path.dirname(rank_report_file(cfg, 1)) == str(tmp_path / "statis")
    for i, r in enumerate(reports):
        assert os.path.isfile(rank_report_file(cfg, i))
        assert r["rank"] == i and r["ranks"]["backend"] == "gloo" and r["ranks"]["size"] == 2
    assert reports[0]["param_sha256"] == reports[1]["param_sha256"]
    assert len(reports[0]["series"]["train_loss"]) == 1


def test_a_failed_rank_fails_the_launch_and_stops_the_others(tmp_path):
    cmds = [[sys.executable, "-c", "import sys; print('rank zero gives up'); sys.exit(3)"],
            [sys.executable, "-c", "import time; time.sleep(120)"]]
    t0 = time.monotonic()
    with pytest.raises(RanksFailed, match="a rank failed") as err:
        launch_ranks(cmds, str(tmp_path), timeout=100)
    assert time.monotonic() - t0 < 60
    assert "rank zero gives up" in str(err.value) and "rc 3" in str(err.value)


def test_ranks_that_outlive_the_timeout_fail_the_launch(tmp_path):
    cmds = [[sys.executable, "-c", "import time; time.sleep(120)"]] * 2
    t0 = time.monotonic()
    with pytest.raises(RanksFailed, match="outlived 1s"):
        launch_ranks(cmds, str(tmp_path), timeout=1)
    assert time.monotonic() - t0 < 60
