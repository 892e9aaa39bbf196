"""The port stands alone: it imports nothing of JAX or of the JAX package,
and its entry points run on the card unless the caller asks for the CPU.

``tests/conftest.py`` imports jax into every test process, so the import
check runs in a fresh subprocess.
"""

import ast
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu_torch as port
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

PORT_DIR = Path(port.__file__).parent
REPO = PORT_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "dynamic_load_balance_distributeddnn_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages([str(PORT_DIR)], prefix=port.__name__ + ".")
    )


def test_importing_the_whole_port_loads_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}: importlib.import_module(m)\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r})\n"
        "print('BAD', bad)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, env=env,
        cwd=str(REPO), timeout=300,
    )
    assert r.returncode == 0, r.stderr[-3000:]
    assert "BAD []" in r.stdout, r.stdout


def test_no_port_module_imports_jax_or_the_jax_package():
    offenders = []
    for path in sorted(PORT_DIR.rglob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            offenders += [
                f"{path.relative_to(REPO)}: {n}" for n in names if n.split(".")[0] in FORBIDDEN
            ]
    assert offenders == []


def _cfg(tmp_path, **kw):
    base = dict(model="mnistnet", dataset="mnist", world_size=2, batch_size=32,
                epoch_size=1, n_train=64, log_dir=str(tmp_path / "logs"),
                stat_dir=str(tmp_path / "statis"))
    base.update(kw)
    return Config(**base)


@pytest.fixture
def no_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without a card")


def test_trainer_defaults_to_cuda(tmp_path, no_cuda):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_cfg(tmp_path), log_to_file=False)
    Trainer(_cfg(tmp_path), device="cpu", log_to_file=False)  # the CPU on request


def test_cli_defaults_to_cuda(tmp_path, no_cuda):
    argv = ["-m", "mnistnet", "-ds", "mnist", "-ws", "2", "-e", "1",
            "--n_train", "64", "--log_dir", str(tmp_path / "logs"),
            "--stat_dir", str(tmp_path / "statis")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert not (tmp_path / "logs").exists()  # refused before touching disk


def test_unknown_device_is_refused(tmp_path):
    with pytest.raises(ValueError, match="unsupported device"):
        Trainer(_cfg(tmp_path), device="meta", log_to_file=False)
