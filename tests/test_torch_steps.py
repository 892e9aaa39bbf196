"""The port's elastic DBS step against the JAX package's ``StepLibrary``.

Two workers with unequal batches (24 and 40 rows), per-example weights from
``example_weights``, the reduced DenseNet with bridged weights. JAX side:
``worker_step_first`` / ``worker_step_acc`` on a 1-device mesh, then
``combine_update``. Port side: ``elastic_step``. After each of 2
SGD-momentum steps at lr 0.1 the parameters agree within atol 1e-5, and the
momentum buffers (sums of gradients) within the repo's gradient tolerance,
atol 5e-4: the two frameworks sum the per-example and per-worker terms in
different orders, so equality is to f32 rounding, not bitwise.

Each step starts both sides from the same state (the JAX parameters and
momentum trace, bridged): run freely, the second step's relu boundaries turn
f32 rounding into ~2e-5 parameter differences — on either side alike, each
measured against a float64 run of the port on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.data.datasets import NORM_STATS
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.models.densenet import DenseNet as FlaxDenseNet
from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import (
    data_mesh,
    replicated_sharding,
)
from dynamic_load_balance_distributeddnn_tpu.train.state import (
    create_state,
    make_optimizer as jax_optimizer,
)
from dynamic_load_balance_distributeddnn_tpu.train.steps import (
    StepLibrary,
    shard_views,
    stack_partials,
)
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.mnistnet import MnistNet
from dynamic_load_balance_distributeddnn_tpu_torch.ops.augment import normalize_images
from dynamic_load_balance_distributeddnn_tpu_torch.ops.losses import example_weights
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
    combine_probe,
    elastic_step,
    probe_grads,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SIZES = (24, 40)
LR = 0.1
MEAN, STD = NORM_STATS["cifar10"]


def _data(step: int, uniform_worker_weight: bool):
    rng = np.random.RandomState(100 + step)
    out = []
    for b in SIZES:
        x = rng.randint(0, 256, (b, 16, 16, 3)).astype(np.uint8)
        y = rng.randint(0, 10, (b,)).astype(np.int32)
        w = example_weights(
            np.ones(b, bool), sum(SIZES), b, len(SIZES), uniform_worker_weight
        )
        out.append((x, y, w))
    return out


@pytest.mark.parametrize("uniform_worker_weight", [False, True])
def test_elastic_step_matches_step_library(uniform_worker_weight):
    mesh = data_mesh([jax.devices()[0]])
    spec = ModelSpec("densenet", FlaxDenseNet((2, 2), growth_rate=32), "logits", "image")
    tx = jax_optimizer(LR, 0.9)
    state = create_state(
        spec.module, jnp.zeros((1, 16, 16, 3)), tx, seed=0,
        sharding=replicated_sharding(mesh),
    )
    lib = StepLibrary(spec, mesh, tx, mean=MEAN, std=STD, augment=False)

    model = DenseNet((2, 2), growth_rate=32, image_size=16).to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_flax(state.params, model))
    opt = make_optimizer(model.parameters(), LR, 0.9)

    key = jax.random.PRNGKey(0)
    for step in range(2):
        if step:  # restart the port from the JAX state (see module doc)
            model.load_state_dict(params_from_flax(state.params, model))
            trace = params_from_flax(state.opt_state.inner_state[0].trace, model)
            for name, p in model.named_parameters():
                opt.state[p]["momentum_buffer"].copy_(trace[name])
        data = _data(step, uniform_worker_weight)
        view = shard_views(state.params, [jax.devices()[0]])[0]
        acc, aux0 = lib.worker_step_first(view, *data[0], key, jnp.int32(0))
        acc, aux1 = lib.worker_step_acc(view, acc, *data[1], key, jnp.int32(0))
        state = lib.combine_update(state, stack_partials([acc], mesh))

        batches = [
            (normalize_images(torch.from_numpy(x), MEAN, STD),
             torch.from_numpy(y.astype(np.int64)), torch.from_numpy(w))
            for x, y, w in data
        ]
        loss_sum = elastic_step(model, opt, batches)
        np.testing.assert_allclose(
            float(loss_sum), float(aux0[1]) + float(aux1[1]), rtol=1e-5
        )

        want = params_from_flax(state.params, model)
        trace = params_from_flax(state.opt_state.inner_state[0].trace, model)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(
                p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name
            )
            np.testing.assert_allclose(
                opt.state[p]["momentum_buffer"].numpy(), trace[name].numpy(),
                atol=5e-4, err_msg=name,
            )


def _mnist_setup():
    model = MnistNet().eval()  # dropout off: the probe must be deterministic
    opt = make_optimizer(model.parameters(), LR, 0.9)
    rng = np.random.RandomState(0)
    batches = [
        (torch.from_numpy(rng.randn(b, 28, 28, 1).astype(np.float32)),
         torch.from_numpy(rng.randint(0, 10, b)), torch.full((b,), 1.0 / sum(SIZES)))
        for b in SIZES
    ]
    return model, opt, batches


@pytest.mark.parametrize("steps_before", [0, 1])
def test_probe_twins_leave_state_untouched_and_match_the_update(steps_before):
    """probe_grads writes no .grad; combine_probe predicts the parameters the
    real step produces (first step: no momentum buffer yet; second: with
    one), and writes neither parameters nor buffers."""
    model, opt, batches = _mnist_setup()
    for _ in range(steps_before):
        elastic_step(model, opt, batches)
    opt.zero_grad(set_to_none=True)
    params = list(model.parameters())
    before = [p.detach().clone() for p in params]
    bufs = [opt.state.get(p, {}).get("momentum_buffer") for p in params]
    bufs = [None if b is None else b.clone() for b in bufs]
    grads = [probe_grads(model, params, b) for b in batches]
    assert all(p.grad is None for p in params)
    predicted = combine_probe(opt, grads)
    for p, b0 in zip(params, before):
        assert torch.equal(p, b0)
    for p, b0 in zip(params, bufs):
        b1 = opt.state.get(p, {}).get("momentum_buffer")
        assert (b0 is None and b1 is None) or torch.equal(b0, b1)
    elastic_step(model, opt, batches)
    for p, q in zip(params, predicted):
        torch.testing.assert_close(p.detach(), q, atol=1e-6, rtol=0)


def test_empty_worker_batch_is_skipped():
    model, opt, batches = _mnist_setup()
    a = elastic_step(model, opt, [batches[0], None])
    assert a is not None and torch.isfinite(a)
    assert elastic_step(model, opt, [None, None]) is None
