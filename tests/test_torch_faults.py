"""The reference's fault flags in the port: ``-ft``/``-ftc``
(``LuckyFaultInjector``) and ``--fault_mode compute`` (the synthetic load),
against the JAX package's ``faults.py`` and ``ops/faultload.py``.

- ``LuckyFaultInjector``'s draws (``seed * 977 + r`` streams of Python's
  ``random``) and the resulting per-epoch faults equal the JAX injector's
  bit for bit over 50 epochs, 4 workers, in both modes;
- ``StaticStragglerInjector``'s compute-mode iterations equal JAX's;
- ``synthetic_load`` equals the JAX function at 0, 1 and 3 iterations
  within atol 1e-6 (the scalar it returns is about 3e-8 once an iteration
  runs, so it is also held within rtol 1e-5: f32 sums of 65,536 terms in
  another order);
- the engine builds the injector in the JAX order and, in compute mode,
  calibrates the in-step iteration cost on the injection-free epoch 0 and
  injects the straggler from epoch 1.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu import faults as jax_faults
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.ops.faultload import (
    synthetic_load as jax_synthetic_load,
)
from dynamic_load_balance_distributeddnn_tpu_torch import faults
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import (
    SyntheticLoad,
    synthetic_load,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.faultload import synthetic_load_cuda
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _ctx(pkg, ws, epoch):
    rng = np.random.RandomState(epoch)
    return pkg.FaultContext(
        batch_sizes=rng.randint(8, 200, ws).astype(np.float64),
        iter_cost_s=1e-5 * (1 + epoch % 3),
        per_example_cost_s=rng.uniform(1e-4, 1e-3, ws),
    )


def _same(got, want):
    for field in ("virtual_seconds", "slow_iters_per_step", "time_multipliers"):
        g, w = getattr(got, field), getattr(want, field)
        assert g.dtype == w.dtype and np.array_equal(g, w), field


def test_seeded_rngs_equal_the_jax_streams():
    for g, w in zip(faults.seeded_rngs(1234, 4), jax_faults.seeded_rngs(1234, 4)):
        assert [g.random() for _ in range(20)] == [w.random() for _ in range(20)]


@pytest.mark.parametrize("mode", ["virtual", "compute"])
@pytest.mark.parametrize("seed,chance", [(1234, 0.1), (7, 0.5), (0, 0.9)])
def test_lucky_injector_draws_equal_the_jax_injector(mode, seed, chance):
    got = faults.LuckyFaultInjector(4, chance, mode=mode, seed=seed)
    want = jax_faults.LuckyFaultInjector(4, chance, mode=mode, seed=seed)
    hits = 0
    for epoch in range(50):
        steps = 3 + epoch % 5
        g = got.epoch_faults(epoch, steps, _ctx(faults, 4, epoch))
        w = want.epoch_faults(epoch, steps, _ctx(jax_faults, 4, epoch))
        _same(g, w)
        hits += int(np.any(g.virtual_seconds) or np.any(g.slow_iters_per_step))
    assert got._wait_s == want._wait_s and got._until == want._until
    assert hits > 0  # the schedule injected


@pytest.mark.parametrize("mode", ["virtual", "compute"])
def test_static_straggler_equals_the_jax_injector(mode):
    got = faults.StaticStragglerInjector([3.0, 1.0, 1.5, 2.0], mode=mode)
    want = jax_faults.StaticStragglerInjector([3.0, 1.0, 1.5, 2.0], mode=mode)
    for epoch in range(10):
        _same(got.epoch_faults(epoch, 8, _ctx(faults, 4, epoch)),
              want.epoch_faults(epoch, 8, _ctx(jax_faults, 4, epoch)))
    # compute mode before the anchors exist: nothing injected, as in JAX
    bare_g = faults.FaultContext(batch_sizes=np.full(4, 32.0))
    bare_w = jax_faults.FaultContext(batch_sizes=np.full(4, 32.0))
    _same(got.epoch_faults(0, 8, bare_g), want.epoch_faults(0, 8, bare_w))
    if mode == "compute":
        assert got.epoch_faults(3, 8, _ctx(faults, 4, 3)).slow_iters_per_step[0] > 0


@pytest.mark.parametrize("n_iters", [0, 1, 3])
@pytest.mark.parametrize("seed_val", [0.0, 1.7, 123.4])
def test_synthetic_load_equals_the_jax_function(n_iters, seed_val):
    want = float(jax_synthetic_load(jnp.int32(n_iters), jnp.float32(seed_val)))
    got = synthetic_load(n_iters, torch.tensor(seed_val))
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), want, atol=1e-6, rtol=1e-5)
    # the engine's runner is the plain chain on a CPU tensor
    assert float(SyntheticLoad()(n_iters, torch.tensor(seed_val))) == float(got)


def test_synthetic_load_kernel_takes_only_cuda_tensors():
    """The kernel's wrapper raises on a CPU tensor and counts no launch; the
    engine's runner takes the plain chain there, also without a count."""
    runtime.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        synthetic_load_cuda(3, torch.tensor(1.0))
    SyntheticLoad()(3, torch.tensor(1.0))
    assert runtime.LAUNCHES["synthetic_load"] == 0
    assert "faultload" in runtime.SOURCES


def test_calibrated_iteration_cost_is_cached_per_device():
    load = SyntheticLoad()
    cost = load.calibrate_iter_cost("cpu", iters=4)
    assert cost > 0 and load.calibrate_iter_cost("cpu", iters=4) == cost


def _cfg(tmp_path, **kw):
    base = dict(model="mnistnet", dataset="mnist", world_size=2, batch_size=64, bucket=8,
                epoch_size=2, n_train=256, log_dir=str(tmp_path / "logs"),
                stat_dir=str(tmp_path / "statis"))
    base.update(kw)
    return Config(**base)


@pytest.mark.parametrize("kw,kind", [
    (dict(straggler="3,1"), faults.StaticStragglerInjector),
    (dict(straggler="3,1", fault_tolerance=True), faults.StaticStragglerInjector),
    (dict(fault_tolerance=True, fault_tolerance_chance=0.5), faults.LuckyFaultInjector),
    ({}, faults.NullInjector),
])
@pytest.mark.parametrize("mode", ["virtual", "compute"])
def test_injector_order_and_iteration_cost_need(tmp_path, kw, kind, mode):
    """The straggler profile first, then ``-ft``, then none (the JAX
    order); the iteration cost is needed in compute mode with an injector."""
    cfg = _cfg(tmp_path, fault_mode=mode, **kw)
    JaxConfig(**{k: getattr(cfg, k) for k in ("world_size", "straggler", "fault_tolerance",
                                              "fault_mode")})  # the JAX package accepts it
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                 device="cpu", log_to_file=False)
    assert type(tr.injector) is kind
    assert tr._needs_iter_cost == (mode == "compute" and kind is not faults.NullInjector)
    if kind is faults.LuckyFaultInjector:
        assert tr.injector.chance == 0.5 and tr.injector.mode == mode


def test_compute_straggler_calibrates_then_injects(tmp_path):
    """``--straggler 3,1 --fault_mode compute`` on the CPU: epoch 0 has no
    anchors, so nothing is injected and the in-step cost is calibrated;
    epoch 1 gives worker 0 (and only it) synthetic-load iterations sized
    off the anchors, and the realized profile is recorded."""
    tr = Trainer(_cfg(tmp_path, straggler="3,1", fault_mode="compute", packed="off"),
                 bundle=synthetic_dataset("mnist", n_train=256, n_test=64), device="cpu",
                 log_to_file=False)
    seen = []
    epoch_faults = tr.injector.epoch_faults
    tr.injector.epoch_faults = lambda *a: seen.append(epoch_faults(*a)) or seen[-1]
    rec = tr.run()
    assert seen[0].slow_iters_per_step.tolist() == [0, 0]
    assert tr._iter_cost_calibrated and rec.meta["iter_cost_s"] > 0
    assert seen[1].slow_iters_per_step[0] > 0 and seen[1].slow_iters_per_step[1] == 0
    assert len(rec.meta["realized_injection_profile"]) == 2
