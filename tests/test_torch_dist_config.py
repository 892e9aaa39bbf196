"""The flags this slice lifts, the refusals that stay, and the JAX
package's checks of them, on the port's ``Config`` beside the JAX one.

- Each lifted flag (``fused_dbs``, ``shard_update``, ``compress_grads``,
  ``grad_accum``, ``coordinator``, ``num_processes``, ``process_id``;
  ``--rebalance window`` and ``--ckpt_dir`` across processes; ``--elastic``
  in one process) is accepted where the JAX ``Config`` accepts it.
- The JAX package's checks (``compress_grads`` and ``grad_accum`` ride a
  fused path) raise the JAX exception type and message.
- The language model across processes and on its fused paths
  (``--fused_dbs``, ``--shard_update``, ``--grad_accum``,
  ``--compress_grads``, ``--grad_comm hier``) and ``--seq_parallel`` are
  accepted by both.
- What stays refused raises ``NotImplementedError`` naming its flag (also
  beside ``--grad_comm hier`` and ``--remat``, which run): ``--rebalance
  window`` for the language model in one process, ``--elastic`` across
  processes, a ``-gpu``
  slice naming several devices in one process (the message points to the
  multi-process flags) and ``--coordinator`` without the process count and
  id.
- The engine's runtime gate (the JAX ``_dispatch_epoch``'s) raises the JAX
  message when ``--grad_accum`` or ``--compress_grads`` meets a plan that
  fell back to the elastic path; an asymmetric ``-gpu`` map across
  processes raises as the JAX trainer's.
"""

import pytest

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

BASE = dict(model="densenet", dataset="cifar10", world_size=4)
LM = dict(model="transformer", dataset="wikitext2")


@pytest.mark.parametrize("ok", [
    {"fused_dbs": True}, {"fused_dbs": True, "compress_grads": "int8"},
    {"fused_dbs": True, "grad_accum": 4}, {"shard_update": True},
    {"dynamic_batch_size": False, "compress_grads": "int8", "shard_update": True},
    {"dynamic_batch_size": False, "grad_accum": 2},
    {"coordinator": "127.0.0.1:1234", "num_processes": 2, "process_id": 1},
    {"num_processes": 4, "process_id": 3, "device": [0, 0, 0, 0]},
    {"num_processes": 2, "process_id": 0, "device": [0, 0, 1, 1]},
    # the language model across ranks and on its fused paths, and sequence
    # parallelism (lifted with the language model's ranks)
    {**LM, "grad_comm": "hier", "num_processes": 4}, {**LM, "num_processes": 2},
    {**LM, "fused_dbs": True}, {**LM, "shard_update": True},
    {**LM, "dynamic_batch_size": False, "grad_accum": 2, "compress_grads": "int8"},
    {**LM, "seq_parallel": "ring", "num_processes": 2}, {**LM, "seq_parallel": "ulysses"},
    # --rebalance window and --ckpt_dir across processes (the language
    # model's too; window cadence falls back to epoch cadence there, as the
    # JAX trainer's does), and --elastic in one process
    {**LM, "rebalance": "window", "grad_comm": "hier", "num_processes": 4},
    {"rebalance": "window", "grad_comm": "hier", "hier_levels": "host:2",
     "grad_comm_wires": "int8,fp32", "num_processes": 4},
    {"ckpt_dir": "ck", "grad_comm": "hier", "dcn_bandwidth_probe": True, "num_processes": 4},
    {**LM, "ckpt_dir": "ck", "num_processes": 2},
    {"rebalance": "window", "num_processes": 2},
    {"ckpt_dir": "ck", "num_processes": 4, "process_id": 2},
    {**LM, "shard_update": True, "elastic": "on"},
])
def test_lifted_flags_are_accepted_by_both(ok):
    JaxConfig(**dict(BASE, **ok))
    Config(**dict(BASE, **ok))


@pytest.mark.parametrize("bad", [
    {"compress_grads": "int8"}, {"grad_accum": 2}, {"grad_accum": 2, "shard_update": True},
    {"compress_grads": "int8", "grad_accum": 3},
], ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_the_jax_fused_path_checks_raise_the_jax_message(bad):
    with pytest.raises(Exception) as want:
        JaxConfig(**dict(BASE, **bad))
    with pytest.raises(Exception) as got:
        Config(**dict(BASE, **bad))
    assert type(got.value) is type(want.value) is ValueError
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("override,flag", [
    ({"device": [0, 1, 0, 1]}, "-gpu"),
    ({"device": [0, 0, 0, 1], "num_processes": 2}, "--num_processes"),
    ({"coordinator": "127.0.0.1:1"}, "--coordinator"),
    ({"coordinator": "127.0.0.1:1", "num_processes": 2}, "--coordinator"),
    ({"process_id": 2}, "--process_id"),
    ({**LM, "rebalance": "window"}, "--rebalance"),
    ({"elastic": "on", "num_processes": 2}, "--elastic"),
    ({**LM, "seq_parallel": "ring", "num_processes": 2, "elastic": "on"}, "--elastic"),
    ({"elastic": "on", "remat": True, "num_processes": 2}, "--elastic"),
])
def test_refusals_raise_naming_the_flag(override, flag):
    with pytest.raises(NotImplementedError, match=flag):
        Config(**dict(BASE, **override))


def test_process_id_past_the_process_count_is_refused():
    with pytest.raises(ValueError, match="process_id 2 must be below num_processes 2"):
        Config(**dict(BASE, num_processes=2, process_id=2))


def _mnist(tmp_path, **kw):
    cfg = dict(debug=True, world_size=2, batch_size=64, epoch_size=1, dataset="mnist",
               model="mnistnet", bucket=8, n_train=256, log_dir=str(tmp_path / "l"),
               stat_dir=str(tmp_path / "s"))
    cfg.update(kw)
    return Trainer(Config(**cfg), bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                   device="cpu", log_to_file=False)


def test_runtime_gate_raises_the_jax_message(tmp_path):
    """Two workers on one device with ``--fused_dbs``: no fused path (one
    worker a device), so ``--grad_accum`` has nowhere to run."""
    tr = _mnist(tmp_path, fused_dbs=True, grad_accum=2)
    plan, faults = tr._plan_epoch(0)
    with pytest.raises(RuntimeError, match="grad_accum/compress_grads require a fused path"):
        tr._dispatch_epoch(plan, faults, 0)


def test_one_worker_takes_the_fused_path_with_the_jax_width(tmp_path):
    """One process, one worker: ``-dbs false`` is the fused path, and
    ``--fused_dbs`` pads to ``_cap_b``; both learn."""
    for kw, path in (({"dynamic_batch_size": False}, "fused"), ({"fused_dbs": True}, "fused_dbs")):
        tr = _mnist(tmp_path / path, world_size=1, epoch_size=2, **kw)
        rec = tr.run()
        assert tr.recorder.meta["paths"] == [path] * 2
        assert rec.data["train_loss"][-1] < rec.data["train_loss"][0]
