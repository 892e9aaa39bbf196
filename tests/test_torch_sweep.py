"""The port's sweep harness (``sweep.py``) beside the JAX package's.

- The counterpart of ``tests/test_cli_smoke.py``'s sweep test: one leg a
  dbs arm (MnistNet on the synthetic FashionMNIST stand-in, debug mode, on
  the CPU), two ``.npy`` series, and a second call skips every leg through
  the sentinels.
- The grid: the legs and each leg's flags equal the JAX sweep's, in its
  order (both packages' ``cli.main`` recorded, not run); ``-dev`` defaults
  to ``0``, every worker on device 0.
- Fail fast: the first leg that raises or returns nonzero stops the sweep.
"""

import os

import pytest

from dynamic_load_balance_distributeddnn_tpu import sweep as jax_sweep
from dynamic_load_balance_distributeddnn_tpu_torch import sweep
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

ARGV = ["-ws", "2", "-b", "64", "-e", "1", "-d", "true", "--models", "mnistnet",
        "--datasets", "mnist"]


def test_sweep_runs_grid_and_is_idempotent(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)  # the legs use the default ./logs, ./statis, ./data
    assert sweep.main(ARGV, device="cpu") == 0
    stats = sorted(os.listdir(tmp_path / "statis"))
    npys = [f for f in stats if f.endswith(".npy")]
    assert len(npys) == 2 and any("-dbs1-" in f for f in npys) and any("-dbs0-" in f for f in npys)
    capsys.readouterr()
    assert sweep.main(ARGV, device="cpu") == 0  # every leg skipped, still rc 0
    assert capsys.readouterr().out.count("skipping") == 2
    assert sorted(os.listdir(tmp_path / "statis")) == stats


@pytest.mark.parametrize("argv", [
    [], ["--models", "densenet,regnet", "--datasets", "cifar100", "-dev", "0,0,0,1"],
    ["-ws", "2", "-b", "128", "-e", "3", "-lr", "0.1", "-de", "true", "-d", "true"],
])
def test_sweep_legs_equal_the_jax_sweep(argv, monkeypatch):
    legs = {"jax": [], "port": []}
    monkeypatch.setattr(jax_sweep.cli, "main", lambda args: legs["jax"].append(args) or 0)
    monkeypatch.setattr(sweep.cli, "main",
                        lambda args, device: legs["port"].append((args, device)) or 0)
    assert jax_sweep.main(argv) == 0 and sweep.main(argv, device="cpu") == 0
    assert [a for a, _ in legs["port"]] == legs["jax"] and len(legs["jax"]) >= 2
    assert {d for _, d in legs["port"]} == {"cpu"}
    if "-dev" not in argv:
        assert all(a[a.index("-gpu") + 1] == "0" for a in legs["jax"])


@pytest.mark.parametrize("failure", ["raise", "rc"])
def test_sweep_stops_at_the_first_failing_leg(failure, monkeypatch):
    calls = []

    def leg(args, device):
        calls.append(args)
        if failure == "raise":
            raise RuntimeError("leg broke")
        return 3

    monkeypatch.setattr(sweep.cli, "main", leg)
    assert sweep.main([], device="cpu") == (1 if failure == "raise" else 3)
    assert len(calls) == 1
