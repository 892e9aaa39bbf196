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
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer

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


def test_the_import_checks_cover_the_multi_rank_modules():
    """The two checks above walk every module; the data-parallel ones
    (``parallel/``, ``train/combine.py``) and the elastic tier across
    processes (``runtime/watchdog.py``, ``runtime/rendezvous.py``) are
    among them."""
    mods = set(_modules())
    for name in ("parallel.mesh", "parallel.topology", "parallel.wire", "parallel.prng",
                 "train.combine", "runtime.watchdog", "runtime.rendezvous"):
        assert f"{port.__name__}.{name}" in mods, name


def test_the_import_checks_cover_the_runtime():
    """``runtime/`` (the health verdicts of ``--elastic``) is walked too: its
    JAX original looks free of jax, but importing it runs the JAX package's
    ``__init__`` chain, so the port keeps a copy and imports none of it."""
    mods = set(_modules())
    for name in ("runtime", "runtime.health", "faults"):
        assert f"{port.__name__}.{name}" in mods, name
    text = (PORT_DIR / "runtime" / "health.py").read_text()
    assert "dynamic_load_balance_distributeddnn_tpu." not in text


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


def test_lm_trainer_defaults_to_cuda(tmp_path, no_cuda):
    cfg = _cfg(tmp_path, model="transformer", dataset="wikitext2", n_train=400, bptt=8,
               use_flash_attention=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LMTrainer(cfg, log_to_file=False)
    tr = LMTrainer(cfg, device="cpu", log_to_file=False)  # the CPU on request
    assert tr.grad_clip == 0.25  # the reference's clip when the flag is 0


def test_lm_cli_defaults_to_cuda(tmp_path, no_cuda):
    argv = ["-m", "transformer", "-ds", "wikitext2", "-ws", "2", "-e", "1",
            "--n_train", "400", "--bptt", "8", "--use_flash_attention", "true",
            "--log_dir", str(tmp_path / "logs"), "--stat_dir", str(tmp_path / "statis")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert not (tmp_path / "logs").exists()  # refused before touching disk


def test_the_import_checks_cover_the_sweep_and_the_tree():
    """The walk above covers the sweep harness and the modules of the
    topology tree and the remat tape as well."""
    mods = set(_modules())
    for name in ("sweep", "parallel.topology", "parallel.wire", "models.common", "train.steps"):
        assert f"{port.__name__}.{name}" in mods, name


def test_sp_trainer_defaults_to_cuda(tmp_path, no_cuda):
    from dynamic_load_balance_distributeddnn_tpu_torch.train.sp_engine import SeqParallelLMTrainer

    cfg = _cfg(tmp_path, model="transformer", dataset="wikitext2", n_train=400, bptt=8,
               seq_parallel="ring")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SeqParallelLMTrainer(cfg, log_to_file=False)
    assert not (tmp_path / "logs").exists()  # refused before touching disk
    tr = SeqParallelLMTrainer(cfg, device="cpu", log_to_file=False)  # the CPU on request
    assert tr.n_dev == 1 and tr.grad_clip == 0.25


def test_sp_cli_defaults_to_cuda(tmp_path, no_cuda):
    argv = ["-m", "transformer", "-ds", "wikitext2", "-ws", "2", "-e", "1",
            "--n_train", "400", "--bptt", "8", "--seq_parallel", "ulysses",
            "--log_dir", str(tmp_path / "logs"), "--stat_dir", str(tmp_path / "statis")]
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(argv)
    assert not (tmp_path / "logs").exists()  # refused before touching disk


def test_the_import_checks_cover_sequence_parallelism():
    mods = set(_modules())
    for name in ("parallel.ring", "parallel.ulysses", "parallel.seq_parallel", "train.sp_engine"):
        assert f"{port.__name__}.{name}" in mods, name


def test_the_import_checks_cover_the_host_fed_path():
    """The host-fed path's modules are walked too: the C++ host runtime's
    bridge keeps its own copy of the JAX package's (it builds the
    repo-level ``native/src/dbs_native.cpp`` into ``build/native/`` and
    imports nothing of that package), and the transfer pipeline."""
    mods = set(_modules())
    for name in ("runtime.native", "train.pipeline"):
        assert f"{port.__name__}.{name}" in mods, name
    text = (PORT_DIR / "runtime" / "native.py").read_text()
    assert "dynamic_load_balance_distributeddnn_tpu." not in text
    assert '"build" / "native"' in text
