"""``--remat`` (``train/steps.py`` ``set_remat``/``forward``) on the CPU.

- **Bit for bit with remat off**: from one state and the same inputs, the
  elastic step (two workers, reduced DenseNet at 16x16 and MnistNet with
  its dropout), the packed step and the language model's clipped elastic
  step with dropout 0.2 (flash attention, and the plain attention with its
  probability dropout) give the same gradients, parameters, momentum
  buffers and loss sums with and without remat, in f32 and under a bf16
  compute dtype. The dropout masks of the recompute are the forward's
  (``models/common.py`` ``keep_mask``), and the generator ends where it ends
  without remat.
- **Through the trainers**: MnistNet (dropout 0.5) on the packed and the
  elastic paths and the small LM, ``--remat true`` against ``false`` under
  ``--superstep auto`` and ``off``: every series and parameter equal.
- **Against the JAX package**: the port's remat step beside the JAX
  ``StepLibrary(remat=True)`` (``_apply_train`` under ``jax.checkpoint``)
  on bridged weights, within the tolerances of
  ``tests/test_torch_steps.py`` and ``tests/test_torch_lm.py``.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.models.densenet import DenseNet as FlaxDenseNet
from dynamic_load_balance_distributeddnn_tpu.models.transformer import TransformerLM as FlaxLM
from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import data_mesh, replicated_sharding
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
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.mnistnet import MnistNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import TransformerLM
from dynamic_load_balance_distributeddnn_tpu_torch.ops.augment import normalize_images
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
    elastic_step,
    packed_step,
    set_remat,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_lm import SMALL, SmallLM, _token_batches
from tests.test_torch_lm import straggler_time as lm_time
from tests.test_torch_steps import LR, MEAN, STD, _data

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def _vision(name):
    torch.manual_seed(0)
    if name == "densenet":
        model = DenseNet((2, 2), growth_rate=32, image_size=16)
        x = torch.rand(6, 16, 16, 3)  # NHWC, as normalize_images gives it
    else:
        model = MnistNet()
        x = torch.rand(6, 28, 28, 1)
    model = model.to(memory_format=torch.channels_last)
    g = torch.Generator().manual_seed(1)
    batches = []
    for lo, hi in ((0, 2), (2, 6)):
        w = torch.rand(hi - lo, generator=g)
        batches.append((x[lo:hi], torch.randint(0, 10, (hi - lo,), generator=g), w / 6))
    return model, batches


def _lm(use_flash):
    torch.manual_seed(0)
    model = TransformerLM(**dict(SMALL, dropout=0.2), use_flash=use_flash)
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _token_batches()]
    return model, batches


def _with_dropout_generator(model, seed=5):
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout

    gen = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = gen
    return gen


def _run_steps(model, batches, step, remat, dtype, clip=0.0):
    """Two steps of ``step`` from the model's state (a deep copy): the
    parameters, momentum buffers, ``.grad``, loss sums and the dropout
    generator's state after them."""
    model = copy.deepcopy(model)
    gen = _with_dropout_generator(model)
    set_remat(model, remat)
    opt = make_optimizer(model.parameters(), 0.1, 0.9)
    losses = []
    for _ in range(2):
        if step == "packed":
            b = [torch.cat(t) for t in zip(*batches)]
            losses.append(packed_step(model, opt, b, compute_dtype=dtype))
        else:
            losses.append(elastic_step(model, opt, batches, clip, compute_dtype=dtype))
    return ([p.detach().clone() for p in model.parameters()],
            [opt.state[p]["momentum_buffer"].clone() for p in model.parameters()],
            [p.grad.clone() for p in model.parameters()], losses, gen.get_state())


def _assert_same(a, b):
    for x, y in zip(a[:3], b[:3]):
        assert all(torch.equal(u, v) for u, v in zip(x, y))
    assert all(torch.equal(u, v) for u, v in zip(a[3], b[3]))
    assert torch.equal(a[4], b[4])  # the generator moved as far


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("name,step", [("densenet", "elastic"), ("densenet", "packed"),
                                       ("mnistnet", "elastic"), ("mnistnet", "packed")])
def test_remat_vision_steps_are_bit_for_bit(name, step, dtype):
    model, batches = _vision(name)
    on = _run_steps(model, batches, step, True, DTYPES[dtype])
    off = _run_steps(model, batches, step, False, DTYPES[dtype])
    _assert_same(on, off)
    assert any(float(g.abs().max()) > 0 for g in on[2])


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_remat_lm_step_with_dropout_is_bit_for_bit(use_flash, dtype):
    model, batches = _lm(use_flash)
    on = _run_steps(model, batches, "elastic", True, DTYPES[dtype], clip=0.25)
    off = _run_steps(model, batches, "elastic", False, DTYPES[dtype], clip=0.25)
    _assert_same(on, off)
    # the masks moved the result: without dropout the step differs
    model.apply(lambda m: setattr(m, "p", 0.0) if hasattr(m, "generator") else None)
    quiet = _run_steps(model, batches, "elastic", True, DTYPES[dtype], clip=0.25)
    assert not all(torch.equal(u, v) for u, v in zip(quiet[0], on[0]))


@pytest.mark.parametrize("remat", [True, False])
def test_the_backward_recomputes_and_redraws_nothing(remat):
    """Under remat the backward runs the forward again (each layer twice a
    step) and takes the forward's masks from the tape: the generator does
    not move in the backward."""
    from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import weighted_loss

    model, batches = _lm(False)
    gen = _with_dropout_generator(model)
    set_remat(model, remat)
    calls = []
    model.EncoderLayer_0.register_forward_hook(lambda *a: calls.append(1))
    before = gen.get_state()
    wl, _ = weighted_loss(model, *batches[0])
    after_forward = gen.get_state()
    assert not torch.equal(before, after_forward) and len(calls) == 1
    wl.backward()
    assert torch.equal(gen.get_state(), after_forward)
    assert len(calls) == (2 if remat else 1)


# -------------------------------------------------------------- trainers


def _vision_run(tmp, remat, superstep, packed):
    cfg = Config(debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
                 dataset="mnist", model="mnistnet", bucket=8, n_train=256, straggler="3,1",
                 packed=packed, superstep=superstep, remat=remat,
                 log_dir=str(tmp / "l"), stat_dir=str(tmp / "s"))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                 timing_model=lambda plan: np.array([3e-3, 1e-3]) * [w.batch_size for w in plan.workers],
                 device="cpu", log_to_file=False)
    return tr, tr.run()


@pytest.mark.parametrize("superstep", ["auto", "off"])
@pytest.mark.parametrize("packed", ["auto", "off"], ids=["packed", "elastic"])
def test_remat_trainer_runs_equal_the_runs_without_it(tmp_path, superstep, packed):
    a, ra = _vision_run(tmp_path / "on", True, superstep, packed)
    b, rb = _vision_run(tmp_path / "off", False, superstep, packed)
    assert ra.meta["paths"] == rb.meta["paths"] == (["packed"] if packed == "auto" else ["elastic"]) * 2
    for k in ("partition", "train_loss", "val_loss", "accuracy"):
        assert ra.data[k] == rb.data[k], k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


@pytest.mark.parametrize("superstep", ["auto", "off"])
def test_remat_lm_trainer_equals_the_run_without_it(tmp_path, superstep):
    corpus = make_tiny_corpus(tmp_path / "corpus")
    del corpus
    runs = []
    for remat in (True, False):
        cfg = Config(debug=True, world_size=4, batch_size=40, learning_rate=0.5, epoch_size=2,
                     dataset="wikitext2", model="transformer", bucket=4, bptt=16,
                     straggler="3,1,1,1", superstep=superstep, remat=remat,
                     log_dir=str(tmp_path / f"{remat}" / "l"), stat_dir=str(tmp_path / f"{remat}" / "s"))
        tr = SmallLM(cfg, bundle=Corpus(str(tmp_path / "corpus")), timing_model=lm_time,
                     device="cpu", log_to_file=False)
        runs.append((tr, tr.run()))
    (a, ra), (b, rb) = runs
    for k in ("partition", "train_loss", "val_loss"):
        assert ra.data[k] == rb.data[k], k
    for p, q in zip(a.model.parameters(), b.model.parameters()):
        assert torch.equal(p, q)


# ------------------------------------------------------ against the JAX step


def test_remat_elastic_step_matches_the_jax_remat_step():
    """The reduced DenseNet's elastic step (two workers) with remat on both
    sides, as ``tests/test_torch_steps.py`` holds the step without it."""
    from dynamic_load_balance_distributeddnn_tpu.train.state import make_optimizer as jopt

    mesh = data_mesh([jax.devices()[0]])
    spec = ModelSpec("densenet", FlaxDenseNet((2, 2), growth_rate=32), "logits", "image")
    tx = jopt(LR, 0.9)
    state = create_state(spec.module, jnp.zeros((1, 16, 16, 3)), tx, seed=0,
                         sharding=replicated_sharding(mesh))
    lib = StepLibrary(spec, mesh, tx, mean=MEAN, std=STD, augment=False, remat=True)
    model = DenseNet((2, 2), growth_rate=32, image_size=16).to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_flax(state.params, model))
    set_remat(model, True)
    opt = make_optimizer(model.parameters(), LR, 0.9)
    data = _data(0, False)
    key = jax.random.PRNGKey(0)
    view = shard_views(state.params, [jax.devices()[0]])[0]
    acc, aux0 = lib.worker_step_first(view, *data[0], key, jnp.int32(0))
    acc, aux1 = lib.worker_step_acc(view, acc, *data[1], key, jnp.int32(0))
    state = lib.combine_update(state, stack_partials([acc], mesh))
    batches = [(normalize_images(torch.from_numpy(x), MEAN, STD),
                torch.from_numpy(y.astype(np.int64)), torch.from_numpy(w)) for x, y, w in data]
    loss_sum = elastic_step(model, opt, batches)
    np.testing.assert_allclose(float(loss_sum), float(aux0[1]) + float(aux1[1]), rtol=1e-5)
    want = params_from_flax(state.params, model)
    trace = params_from_flax(state.opt_state.inner_state[0].trace, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(), trace[name].numpy(),
                                   atol=5e-4, err_msg=name)


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_remat_lm_step_matches_the_jax_remat_step(use_flash):
    """The small LM's clipped elastic step, dropout off (the two frameworks
    draw other masks), remat on both sides."""
    mesh = data_mesh([jax.devices()[0]])
    fmod = FlaxLM(**SMALL, use_flash=use_flash)
    tx = jax_optimizer(0.5, 0.9)
    state = create_state(fmod, jnp.zeros((1, 35), jnp.int32), tx, seed=0,
                         sharding=replicated_sharding(mesh))
    lib = StepLibrary(ModelSpec("transformer", fmod, "logits", "tokens"), mesh, tx,
                      grad_clip=0.25, remat=True)
    model = TransformerLM(**SMALL, use_flash=use_flash)
    model.load_state_dict(params_from_flax(state.params, model))
    set_remat(model, True)
    opt = make_optimizer(model.parameters(), 0.5, 0.9)
    data = _token_batches()
    key = jax.random.PRNGKey(0)
    view = shard_views(state.params, [jax.devices()[0]])[0]
    acc, _ = lib.worker_step_first(view, *data[0], key, jnp.int32(0))
    acc, _ = lib.worker_step_acc(view, acc, *data[1], key, jnp.int32(0))
    state = lib.combine_update(state, stack_partials([acc], mesh))
    elastic_step(model, opt, [tuple(torch.from_numpy(a) for a in b) for b in data], grad_clip=0.25)
    want = params_from_flax(state.params, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
