"""Adaptive probe scheduling (``--probe_mode adaptive``, now the port's
default) against the JAX trainer's own decisions.

The oracle is the JAX ``Trainer``'s ``_should_probe`` and
``_update_probe_schedule``, not a wall clock: both trainers (MnistNet, CPU,
4 workers) are fed one scripted sequence of plans, injected faults, epoch
walls and probe anchors, and their decisions, next probe epoch and
slow-wall streak must be equal epoch by epoch (exact: the same integer and
float comparisons). The script holds a slow wall twice in a row, a plan
change on a skipped epoch, an injection-episode change, a rebalance under a
batch-scaled compute injection (not an episode change) and the
``probe_every`` anchor.
"""

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data import partitioner as jax_part
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.faults import EpochFaults as JaxEpochFaults
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import partitioner, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.faults import EpochFaults
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

WS, B, N = 4, 128, 512
A, Bp, C = [32, 32, 32, 32], [16, 48, 32, 32], [16, 32, 48, 32]
NONE = ([0.0] * WS, [0] * WS, [1.0] * WS)  # (virtual s, slow iters, multipliers)
VIRT = ([0.0, 0.0, 6.0, 0.0], [0] * WS, [1.0] * WS)
# a batch-scaled compute injection on worker 0: 5 iterations an example
SLOW_A = ([0.0] * WS, [160, 0, 0, 0], [1.0] * WS)
SLOW_C = ([0.0] * WS, [80, 0, 0, 0], [1.0] * WS)
# (batches, faults, epoch wall s) per epoch
SCRIPT = [
    (A, NONE, 1.00),    # 0: probed (epochs 0-1 always are)
    (A, NONE, 1.00),    # 1: probed; next anchor at 1 + probe_every
    (A, NONE, 1.05),    # 2: skipped
    (A, NONE, 1.40),    # 3: slow wall (> 1.25 x the reference), streak 1
    (A, NONE, 1.40),    # 4: slow again: streak 2, re-probe next epoch
    (A, NONE, 1.00),    # 5: probed by the wall trigger
    (Bp, NONE, 0.80),   # 6: plan change on a skipped epoch: re-base
    (Bp, NONE, 0.85),   # 7: skipped
    (Bp, VIRT, 0.90),   # 8: injection episode changed: probed
    (Bp, VIRT, 1.20),   # 9: slow once: streak 1
    (Bp, VIRT, 0.90),   # 10: back: streak 0
    (Bp, VIRT, 0.90),   # 11: skipped
    (A, SLOW_A, 1.60),  # 12: compute injection starts: episode changed
    (C, SLOW_C, 1.55),  # 13: rebalance under it (ratio fixed): skipped
    (C, SLOW_C, 1.55),  # 14: skipped
    (C, SLOW_C, 1.55),  # 15: skipped
    (C, SLOW_C, 1.55),  # 16: skipped
    (C, SLOW_C, 1.55),  # 17: the probe_every anchor (12 + 5)
    (C, SLOW_C, 1.55),  # 18: skipped
]
DECISIONS = [True, True, False, False, False, True, False, False, True, False, False,
             False, True, False, False, False, False, True, False]


def _kw(tmp_path, tag):
    return dict(
        debug=True, world_size=WS, batch_size=B, epoch_size=len(SCRIPT), dataset="mnist",
        model="mnistnet", seed=1234, bucket=16, n_train=N, probe_every=5,
        log_dir=str(tmp_path / tag / "logs"), stat_dir=str(tmp_path / tag / "statis"),
    )


@pytest.fixture(scope="module")
def trainers(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("probe_schedule")
    jtr = JaxTrainer(
        JaxConfig(**_kw(tmp, "jax"), probe_mode="adaptive"),
        bundle=jax_synthetic("mnist", n_train=N, n_test=64), log_to_file=False,
    )
    tr = Trainer(
        Config(**_kw(tmp, "torch")), bundle=synthetic_dataset("mnist", n_train=N, n_test=64),
        device="cpu", log_to_file=False,
    )
    return jtr, tr


def _state(t):
    return (t._next_probe_epoch, t._slow_streak, t._probe_wall_ref)


def test_port_default_is_adaptive():
    assert Config().probe_mode == "adaptive" == JaxConfig().probe_mode


def test_scripted_decisions_equal_the_jax_trainer(trainers):
    jtr, tr = trainers
    shares = np.full(WS, 1.0 / WS)
    got, want = [], []
    for epoch, (batches, (virt, slow, mult), wall) in enumerate(SCRIPT):
        bs = np.asarray(batches)
        args = (N, shares, bs, B, epoch)
        jplan = jax_part.build_epoch_plan(*args, seed=1234, bucket=16)
        plan = partitioner.build_epoch_plan(*args, seed=1234, bucket=16)
        arrays = (np.asarray(virt, float), np.asarray(slow, np.int64), np.asarray(mult, float))
        jfaults, faults = JaxEpochFaults(*arrays), EpochFaults(*(a.copy() for a in arrays))
        want.append(jtr._should_probe(epoch, jplan, jfaults))
        got.append(tr._should_probe(epoch, plan, faults))
        jtr._probe_this_epoch, tr._probe_this_epoch = want[-1], got[-1]
        if got[-1]:  # a probed epoch anchors the per-example cost on both
            cost = 1e-3 * (1.0 + np.arange(WS))
            jtr.per_example_cost, tr.per_example_cost = cost.copy(), cost.copy()
        jtr._update_probe_schedule(epoch, jplan, jfaults, wall, {})
        tr._update_probe_schedule(epoch, plan, faults, wall)
        assert got[-1] == want[-1], f"epoch {epoch}: port {got[-1]}, JAX {want[-1]}"
        assert _state(tr) == _state(jtr), f"epoch {epoch}"
    assert want == DECISIONS  # the script exercises what its comments say


def test_always_probes_every_epoch(tmp_path):
    cfg = Config(**dict(_kw(tmp_path, "always"), probe_mode="always"))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=N, n_test=64), device="cpu",
                 log_to_file=False)
    plan = partitioner.build_epoch_plan(N, np.full(WS, 0.25), np.asarray(A), B, 0, bucket=16)
    tr.per_example_cost = np.full(WS, 1e-3)
    assert all(tr._should_probe(e, plan, EpochFaults.none(WS)) for e in range(2, 9))


def test_adaptive_run_skips_epoch_2_probes(tmp_path):
    """A port-only run on the CPU's wall clock: epochs 0-1 probe, epoch 2
    runs on modeled times (no probe wall), each worker's modeled compute is
    its anchored cost an example times its examples, and the virtual 3:1
    straggler still moves share off worker 0."""
    cfg = Config(**dict(_kw(tmp_path, "run"), world_size=2, batch_size=64, bucket=8,
                        epoch_size=3, straggler="3,1"))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=N, n_test=64), device="cpu",
                 log_to_file=False)
    probed = []
    probe = tr._probe_workers

    def counting(plan, batches, faults, epoch, **kw):
        probed.append(epoch)
        return probe(plan, batches, faults, epoch, **kw)

    tr._probe_workers = counting
    plans = []
    build = tr._build_plan
    tr._build_plan = lambda epoch, bs: plans.append(build(epoch, bs)) or plans[-1]
    rec = tr.run()
    assert probed == [0, 1]
    assert rec.data["probe_time"][2] == 0.0 and min(rec.data["probe_time"][:2]) > 0
    assert rec.meta["node_time_source"] == ["probed", "probed", "modeled"]
    modeled = [tr.per_example_cost[r] * w.batch_size * w.steps * f
               for r, (w, f) in enumerate(zip(plans[2].workers, (3.0, 1.0)))]
    np.testing.assert_allclose(rec.data["node_time"][2], modeled, rtol=1e-12)
    assert rec.data["partition"][-1][0] < 0.5
