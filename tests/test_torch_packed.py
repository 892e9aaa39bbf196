"""Packed single-device epochs (``--packed auto|on|off``).

Every worker of the port shares one card, so a vision run takes the packed
path by default, as the JAX package does when its workers share one chip:
each step concatenates the workers' true-width batches and runs one forward
and one backward with the elastic path's per-example weights, then one
SGD-momentum update. The sum over examples is the sum over workers, so:

- a packed step equals the elastic step over the same batches: parameters
  after 3 steps within atol 1e-5 (one backward over the concatenation
  against per-worker backwards summed into ``.grad``: f32 sums in another
  order), dropout off;
- under one deterministic ``timing_model`` the ``partition`` and
  ``node_time`` series equal a JAX ``device=0, packed="auto"`` run's
  (the JAX package's ``tests/test_packed.py`` ``_run``) exactly;
- ``_cap_packed`` equals the JAX trainer's over a grid of (B, ws, bucket,
  dbs, snapping).
"""

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.faults import (
    StaticStragglerInjector as JaxStraggler,
)
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.faults import StaticStragglerInjector
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.mnistnet import MnistNet
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import elastic_step, packed_step
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

FACTORS = [3.0, 1.0, 1.0, 1.0]


def linear_time(plan):
    return np.array(FACTORS) * np.array([w.batch_size * w.steps for w in plan.workers])


MODELS = {
    "mnistnet": (lambda: MnistNet(), (28, 28, 1)),
    "densenet_2x2": (lambda: DenseNet((2, 2), growth_rate=8, image_size=16), (16, 16, 3)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_packed_step_equals_elastic_steps(name):
    ctor, hwc = MODELS[name]
    models = []
    for _ in range(2):
        m = ctor().to(memory_format=torch.channels_last).eval()  # dropout off
        init_flax_defaults(m, torch.Generator().manual_seed(0))
        models.append(m)
    opts = [make_optimizer(list(m.parameters()), 0.05, 0.9) for m in models]
    rng = np.random.RandomState(0)
    sizes = (5, 11, 16, 8)  # unequal true widths, as a rebalanced plan has
    for _ in range(3):
        batches = []
        for b in sizes:
            x = torch.from_numpy(rng.randn(b, *hwc).astype(np.float32))
            y = torch.from_numpy(rng.randint(0, 10, b))
            w = torch.full((b,), 1.0 / sum(sizes))
            batches.append((x, y, w))
        loss_e = elastic_step(models[0], opts[0], batches)
        packed = tuple(torch.cat(parts) for parts in zip(*batches))
        loss_p = packed_step(models[1], opts[1], packed)
        torch.testing.assert_close(loss_p, loss_e, atol=1e-5, rtol=1e-6)
    for (n, a), b in zip(models[0].named_parameters(), models[1].parameters()):
        torch.testing.assert_close(b, a, atol=1e-5, rtol=0, msg=n)


def _kw(tmp_path, tag, **kw):
    base = dict(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=3,
        dataset="mnist", model="mnistnet", fault_tolerance=True, seed=1234, bucket=8,
        n_train=512, log_dir=str(tmp_path / tag / "logs"),
        stat_dir=str(tmp_path / tag / "statis"),
    )
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("packed")
    jtr = JaxTrainer(
        JaxConfig(**_kw(tmp, "jax", device=0, packed="auto")),
        bundle=jax_synthetic("mnist", n_train=512, n_test=128),
        injector=JaxStraggler(FACTORS, mode="virtual"), timing_model=linear_time,
        log_to_file=False,
    )
    jrec = jtr.run()
    tr = Trainer(
        Config(**_kw(tmp, "torch")), bundle=synthetic_dataset("mnist", n_train=512, n_test=128),
        injector=StaticStragglerInjector(FACTORS, mode="virtual"), timing_model=linear_time,
        device="cpu", log_to_file=False,
    )
    return jtr, jrec, tr, tr.run()


def test_partition_and_node_time_equal_a_jax_packed_run(runs):
    jtr, jrec, tr, rec = runs
    assert jtr._can_use_packed(None) and rec.meta["paths"] == ["packed"] * 3
    assert rec.data["partition"] == jrec.data["partition"]
    assert rec.data["node_time"] == jrec.data["node_time"]
    assert rec.data["partition"][-1][0] < 0.25


def test_packed_run_learns(runs):
    losses = runs[3].data["train_loss"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


def _cap(trainer_cls, cfg, ws):
    t = trainer_cls.__new__(trainer_cls)
    t.cfg, t.world_size = cfg, ws
    return type(t)._cap_packed.fget(t)


@pytest.mark.parametrize("dbs", [True, False])
@pytest.mark.parametrize("snap", [True, False])
def test_cap_packed_equals_the_jax_trainer(dbs, snap):
    for B in (64, 100, 128, 500, 512):
        for ws in (1, 2, 3, 4, 8):
            for bucket in (1, 8, 16, 32):
                kw = dict(world_size=ws, batch_size=B, bucket=bucket, dynamic_batch_size=dbs,
                          snap_to_bucket=snap, model="densenet", dataset="cifar10")
                got = _cap(Trainer, Config(**kw), ws)
                want = _cap(JaxTrainer, JaxConfig(**kw), ws)
                assert got == want, (kw, got, want)


def _trainer(tmp_path, **kw):
    cfg = Config(**_kw(tmp_path, "t", fault_tolerance=False, epoch_size=1, **kw))
    return Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=512, n_test=64),
                   device="cpu", log_to_file=False)


def test_packed_off_runs_the_elastic_path(tmp_path):
    rec = _trainer(tmp_path, packed="off").run()
    assert rec.meta["paths"] == ["elastic"]


def test_packed_on_raises_where_it_cannot_engage(tmp_path):
    with pytest.raises(ValueError, match="grad_clip"):
        _trainer(tmp_path, packed="on", grad_clip=0.5)
    _trainer(tmp_path, packed="on")  # a vision run without a clip engages
    assert not _trainer(tmp_path, grad_clip=0.5)._can_use_packed(None)  # auto: elastic
