"""``--precision bfloat16`` in the port against the JAX package, on the CPU.

The JAX package's compute-dtype policy (``StepLibrary._cast_compute``):
every f32 parameter and the normalised input are cast to bf16 for each
training forward, integer tokens stay as they are, the logits are cast to
f32 before the loss, the gradients reach the f32 master weights through the
casts, and evaluation never casts. The port does the same through
``train/steps.py`` ``cast_compute``.

Models (small, as the other parity tests): DenseNet with two blocks of two
bottlenecks at 16x16 (the JAX GroupNorm through its Pallas kernel in
interpret mode, the port's through its plain version), MnistNet, and a
2-layer Transformer LM of width 200 (the reference's, so the embedding's
scale factor is the real one) over 50 tokens with flash attention, dropout
off. Same seeded numpy inputs, flax weights bridged (``params_from_flax``).

Tolerances, each from the readings on this CPU over weight seeds 0-2:

- the port's bf16 loss within rtol 2e-3 of JAX's bf16 loss for DenseNet
  (read: up to 5.3e-4; each of its 13 bf16 layers rounds to 8 significant
  bits at other points in the two frameworks), 1e-4 for MnistNet and the LM
  (read: up to 1.1e-7);
- the port's bf16 gradients no further from an f64 run of the port than
  ``GRAD_MULTIPLE`` = 2 times JAX's bf16 gradients are (read: 0.75-1.00
  times);
- one SGD-momentum step: the summed gradient (the momentum buffer) within
  ``GRAD_MULTIPLE`` times JAX's own bf16 distance from the f64 gradient (the
  two frameworks' bf16 gradients differ by about as much as each differs
  from f64: a bias gradient sums thousands of bf16 products), the
  parameters within the learning rate times that, plus 1e-6;
- the dtypes, the representability of the gradients, the rounded scale
  factor and the partitions are exact.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.models.densenet import DenseNet as FlaxDenseNet
from dynamic_load_balance_distributeddnn_tpu.models.mnistnet import MnistNet as FlaxMnistNet
from dynamic_load_balance_distributeddnn_tpu.models.transformer import TransformerLM as FlaxLM
from dynamic_load_balance_distributeddnn_tpu.ops import pallas as jax_pallas
from dynamic_load_balance_distributeddnn_tpu.ops.losses import per_example_cross_entropy
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu.train.lm_engine import LMTrainer as JaxLMTrainer
from dynamic_load_balance_distributeddnn_tpu.train.state import make_optimizer as jax_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config, config_from_args
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model, transformer
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.mnistnet import MnistNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import (
    TransformerLM,
    embed_scale,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import plan
from dynamic_load_balance_distributeddnn_tpu_torch.train import engine
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
    cast_compute,
    elastic_step,
    packed_step,
    weighted_loss,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus

BF16 = torch.bfloat16
LOSS_RTOL = {"densenet": 2e-3, "mnistnet": 1e-4, "lm": 1e-4}
GRAD_MULTIPLE = 2.0
LR = 0.05
LM_KW = dict(ntoken=50, ninp=200, nhead=2, nhid=32, nlayers=2, dropout=0.0)
MODELS = {
    # flax constructor, port constructor, input kind, input shape
    "densenet": (lambda: FlaxDenseNet((2, 2), growth_rate=32),
                 lambda: DenseNet((2, 2), growth_rate=32, image_size=16), "images", (4, 16, 16, 3)),
    "mnistnet": (FlaxMnistNet, MnistNet, "images", (4, 28, 28, 1)),
    "lm": (lambda: FlaxLM(**LM_KW, use_flash=True), lambda: TransformerLM(**LM_KW, use_flash=True),
           "tokens", (3, 8)),
}


@contextlib.contextmanager
def pallas_gn():
    """The JAX GroupNorm through its Pallas kernel (interpret mode on the
    CPU), the kernel the port's K1 replaces; the toggle is read at trace
    time."""
    prev = jax_pallas.use_pallas()
    jax_pallas.set_use_pallas(True)
    try:
        yield
    finally:
        jax_pallas.set_use_pallas(prev)


def jax_cast(tree):
    """The JAX ``StepLibrary._cast_compute``."""
    return jax.tree_util.tree_map(
        lambda t: t.astype(jnp.bfloat16) if t.dtype == jnp.float32 else t, tree)


def make_batch(kind, shape, seed):
    """Seeded numpy ``(x, y, w)``: images with labels and weights 1/b, or
    token windows with next tokens and weights 1/tokens."""
    rng = np.random.RandomState(seed)
    if kind == "images":
        x = rng.randn(*shape).astype(np.float32)
        y = rng.randint(0, 10, shape[0])
        w = np.full(shape[0], 1.0 / shape[0], np.float32)
    else:
        x = rng.randint(0, LM_KW["ntoken"], shape).astype(np.int32)
        y = rng.randint(0, LM_KW["ntoken"], shape)
        w = np.full(shape, 1.0 / np.prod(shape), np.float32)
    return x, y, w


def jax_loss(fmod, params, batch, cast: bool):
    """The JAX ``local_grads`` loss: ``sum(losses * w)`` on f32 logits, the
    parameters and a float input cast to bf16 when ``cast``."""
    x, y, w = (jnp.asarray(a) for a in batch)
    if cast:
        params = jax_cast(params)
        x = x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
    out = fmod.apply(params, x, train=False).astype(jnp.float32)
    losses = per_example_cross_entropy(out.reshape(-1, out.shape[-1]), y.reshape(-1))
    return jnp.sum(losses * w.reshape(-1))


def port_model(name, state=None, double=False):
    """The port's model in eval mode (dropout off), channels-last for the
    CNNs, with ``state`` loaded, in f64 when ``double``."""
    _, ctor, kind, _ = MODELS[name]
    model = ctor()
    if kind == "images":
        model = model.to(memory_format=torch.channels_last)
    if state is not None:
        model.load_state_dict(state)
    if double:
        model = model.double()
    return model.eval()


def torch_batch(batch, double=False):
    x, y, w = (torch.from_numpy(np.asarray(a)) for a in batch)
    if double:
        x = x.double() if x.is_floating_point() else x
        w = w.double()
    return x, y, w


def port_grads(model, batch, dtype):
    """The port's weighted loss and its parameter gradients (f64 copies)."""
    loss, _ = weighted_loss(model, *batch, dtype)
    loss.backward()
    return loss.item(), {n: p.grad.detach().double() for n, p in model.named_parameters()}


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    """One model: the JAX bf16 loss and gradients (bridged), the port's bf16
    and f64 ones, on the same weights and batch."""
    name = request.param
    fctor, _, kind, shape = MODELS[name]
    batch = make_batch(kind, shape, 0)
    fmod = fctor()
    params = fmod.init(jax.random.PRNGKey(0), jnp.asarray(batch[0][:1]))
    with pallas_gn():
        jl, jg = jax.value_and_grad(lambda p: jax_loss(fmod, p, batch, cast=True))(params)
    state = params_from_flax(params, port_model(name))
    pl, pg = port_grads(port_model(name, state), torch_batch(batch), BF16)
    l64, g64 = port_grads(port_model(name, state, double=True), torch_batch(batch, True), None)
    return dict(name=name, fmod=fmod, params=params, state=state, batch=batch,
                jax=(float(jl), {k: v.double() for k, v in params_from_flax(jg, port_model(name)).items()}),
                port=(pl, pg), f64=(l64, g64))


def test_bf16_loss_is_within_tolerance_of_jax(case):
    (jl, _), (pl, _) = case["jax"], case["port"]
    assert np.isfinite(pl)
    np.testing.assert_allclose(pl, jl, rtol=LOSS_RTOL[case["name"]])


def test_bf16_gradient_error_against_f64_is_within_a_multiple_of_jax(case):
    g64 = case["f64"][1]
    err = {side: max((case[side][1][n] - g64[n]).abs().max().item() for n in g64)
           for side in ("jax", "port")}
    assert err["jax"] > 0  # the yardstick is bf16's own error, not zero
    assert err["port"] <= GRAD_MULTIPLE * err["jax"], err


def test_worker_gradients_are_bf16_representable_on_both_sides(case):
    """An unclipped worker's gradient reaches each f32 leaf as a widened
    bf16 value, in JAX through the transpose of ``astype``."""
    for side in ("jax", "port"):
        grads = case[side][1]
        assert any(g.abs().max() > 0 for g in grads.values()), side
        for n, g in grads.items():
            g32 = g.float()
            assert torch.equal(g32, g32.bfloat16().float()), (side, n)


def _port_outputs(model, batch):
    """{module path: output dtype} of the port's modules in one cast
    forward, and the dtypes K3 was handed."""
    seen, attn = {}, []
    def hook(name):
        def record(m, i, o):
            seen.setdefault(name, o.dtype)
        return record

    hooks = [m.register_forward_hook(hook(n)) for n, m in model.named_modules() if n]
    flash = transformer.flash_attention
    transformer.flash_attention = lambda q, k, v, causal: attn.append(q.dtype) or flash(q, k, v, causal)
    try:
        weighted_loss(model, *batch, BF16)
    finally:
        transformer.flash_attention = flash
        for h in hooks:
            h.remove()
    return seen, attn


def _jax_outputs(fmod, params, batch):
    """{module path: output dtype} of the flax modules in one cast forward."""
    x = jnp.asarray(batch[0])
    x = x.astype(jnp.bfloat16) if x.dtype == jnp.float32 else x
    with pallas_gn():
        _, state = fmod.apply(jax_cast(params), x, train=False, capture_intermediates=True,
                              mutable=["intermediates"])
    flat = jax.tree_util.tree_flatten_with_path(state["intermediates"])[0]
    return {".".join(k.key for k in path[:-2]): leaf.dtype for path, leaf in flat
            if path[-2].key == "__call__"}


def test_dtype_flow_equals_jax_module_by_module(case):
    """Every port module that has a flax counterpart of the same path
    returns the dtype flax returns; then the facts named: conv, GroupNorm
    and classifier outputs bf16 for the CNNs; for the LM, the embedding bf16,
    f32 from ``+ pe`` on (the embedding dropout's output), f32 into
    attention (the projections and K3's operands) and f32 logits."""
    name = case["name"]
    model = port_model(name, case["state"])
    got, attn = _port_outputs(model, torch_batch(case["batch"]))
    want = _jax_outputs(case["fmod"], case["params"], case["batch"])
    common = sorted(set(got) & set(want))
    kinds = (torch.nn.Conv2d, torch.nn.Linear, GroupNorm, torch.nn.Embedding, torch.nn.LayerNorm)
    layers = {n for n, m in model.named_modules() if isinstance(m, kinds)}
    assert layers <= set(common), sorted(layers - set(common))
    for n in common:
        assert str(got[n]).replace("torch.", "") == str(want[n]), (n, got[n], want[n])
    if name == "lm":
        assert got["Embed_0"] == BF16
        assert got["Dropout_0"] == got["EncoderLayer_0.attn.query"] == torch.float32
        assert attn and set(attn) == {torch.float32}
        assert got["Dense_0"] == torch.float32
    else:
        assert {got[n] for n in layers} == {BF16}


def test_lm_scale_then_positions_equal_jax_bit_for_bit():
    """The LM's activation after ``x * sqrt(ninp)`` in bf16 and ``+ pe``: the
    embedding dropout's input (port) equals its output (flax, eval mode),
    bit for bit, and 14.125 is the factor at ``ninp = 200``."""
    batch = make_batch("tokens", (3, 8), 1)
    fmod = MODELS["lm"][0]()
    params = fmod.init(jax.random.PRNGKey(1), jnp.asarray(batch[0][:1]))
    _, state = fmod.apply(jax_cast(params), jnp.asarray(batch[0]), train=False,
                          capture_intermediates=True, mutable=["intermediates"])
    want = np.asarray(state["intermediates"]["Dropout_0"]["__call__"][0])
    model = port_model("lm", params_from_flax(params, port_model("lm")))
    got = []
    h = model.Dropout_0.register_forward_hook(lambda m, i, o: got.append(i[0]))
    with torch.no_grad():
        weighted_loss(model, *torch_batch(batch), BF16)
    h.remove()
    assert got[0].dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_array_equal(got[0].numpy(), want)
    assert embed_scale(200, BF16) == 14.125
    assert float(jnp.ones((), jnp.bfloat16) * jnp.sqrt(200.0)) == 14.125
    assert embed_scale(200, torch.float32) == float(np.float32(np.sqrt(200.0)))


@pytest.mark.parametrize("kind", ["elastic", "packed"])
@pytest.mark.parametrize("name", ["mnistnet", "lm"])
def test_sgd_momentum_step_matches_jax(name, kind):
    """One step of the port's elastic step (two workers) or packed step
    (their concatenated batch) in bf16 against ``jax.value_and_grad`` over
    the cast parameters, the workers' f32 gradients summed, and the same
    SGD-momentum update (optax, as the JAX package builds it). The summed
    gradient (the momentum buffer) within ``GRAD_MULTIPLE`` times JAX's own
    bf16 distance from the f64 gradient, the parameters within the learning
    rate times that (plus 1e-6); both stay f32."""
    fctor, _, kind_in, shape = MODELS[name]
    fmod = fctor()
    dummy = jnp.zeros((1,) + shape[1:], jnp.int32 if kind_in == "tokens" else jnp.float32)
    params = fmod.init(jax.random.PRNGKey(2), dummy)
    state = params_from_flax(params, port_model(name))
    workers = [make_batch(kind_in, (2,) + shape[1:], 10 + r) for r in range(2)]
    for b in workers:  # weights over the step's two batches
        b[2][...] = b[2] / 2
    packed = tuple(np.concatenate(a) for a in zip(*workers))
    model = port_model(name, state)
    opt = make_optimizer(model.parameters(), LR, 0.9)
    if kind == "elastic":
        elastic_step(model, opt, [torch_batch(b) for b in workers], compute_dtype=BF16)
        grads = [jax.grad(lambda p: jax_loss(fmod, p, b, cast=True))(params) for b in workers]
        grad = jax.tree_util.tree_map(lambda a, b: a + b, *grads)
    else:
        packed_step(model, opt, torch_batch(packed), compute_dtype=BF16)
        grad = jax.grad(lambda p: jax_loss(fmod, p, packed, cast=True))(params)
    tx = jax_optimizer(LR, 0.9)
    updates, opt_state = tx.update(grad, tx.init(params), params)
    want = params_from_flax(jax.tree_util.tree_map(lambda p, u: p + u, params, updates), model)
    trace = params_from_flax(opt_state.inner_state[0].trace, model)
    g64 = port_grads(port_model(name, state, double=True), torch_batch(packed, True), None)[1]
    tol = GRAD_MULTIPLE * max((trace[n].double() - g64[n]).abs().max().item() for n in g64)
    for n, p in model.named_parameters():
        buf = opt.state[p]["momentum_buffer"]
        assert p.dtype == buf.dtype == torch.float32, n
        torch.testing.assert_close(buf, trace[n], atol=tol, rtol=0, msg=n)
        torch.testing.assert_close(p.detach(), want[n], atol=LR * tol + 1e-6, rtol=0, msg=n)


def test_cast_compute_casts_f32_tensors_only():
    named = [("w", torch.ones(2)), ("i", torch.arange(3)), ("d", torch.ones(2, dtype=torch.float64))]
    cast = cast_compute(named, BF16)
    assert [cast[k].dtype for k in ("w", "i", "d")] == [BF16, torch.int64, torch.float64]
    assert cast_compute(named, None) is None


# ----------------------------------------------------------------- trainers

FACTORS = (3.0, 1.0)


def straggler_time(plan):
    """Deterministic compute model: time ∝ examples, worker 0 three times
    slower per example."""
    return np.array([f * w.batch_size * w.steps * 1e-3 for f, w in zip(FACTORS, plan.workers)])


def _vision_kw(tmp, tag):
    return dict(
        debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=512,
        precision="bfloat16", log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"),
    )


@pytest.mark.parametrize("packed", ["auto", "off"])
def test_vision_trainer_partitions_equal_the_jax_trainer_in_bf16(tmp_path, packed):
    """Both trainers at ``precision="bfloat16"`` under the same timing model:
    equal ``partition`` and ``node_time`` series, finite losses; the port's
    parameters and momentum buffers f32 after the run."""
    jrec = JaxTrainer(JaxConfig(**_vision_kw(tmp_path, "jax")),
                      bundle=jax_synthetic("mnist", n_train=512, n_test=256),
                      timing_model=straggler_time, log_to_file=False).run()
    tr = Trainer(Config(**_vision_kw(tmp_path, "torch"), packed=packed),
                 bundle=synthetic_dataset("mnist", n_train=512, n_test=256),
                 timing_model=straggler_time, device="cpu", log_to_file=False)
    rec = tr.run()
    assert rec.data["partition"] == jrec.data["partition"]
    assert rec.data["node_time"] == jrec.data["node_time"]
    assert rec.data["partition"][-1][0] < 0.5
    assert np.isfinite(rec.data["train_loss"]).all()
    assert rec.meta["paths"] == ["packed" if packed == "auto" else "elastic"] * 2
    for p in tr.params:
        assert p.dtype == tr.optimizer.state[p]["momentum_buffer"].dtype == torch.float32


class SmallJaxLM(JaxLMTrainer):
    EMSIZE = 16
    NHID = 16


class SmallLM(LMTrainer):
    EMSIZE = 16
    NHID = 16


def test_lm_trainer_partitions_equal_the_jax_lm_trainer_in_bf16(tmp_path):
    kw = lambda tag: dict(  # noqa: E731
        debug=True, world_size=4, batch_size=40, learning_rate=0.5, epoch_size=2,
        dataset="wikitext2", model="transformer", bucket=4, bptt=16, straggler="3,1,1,1",
        fault_mode="virtual", precision="bfloat16",
        log_dir=str(tmp_path / tag / "logs"), stat_dir=str(tmp_path / tag / "statis"))
    lm_time = lambda plan: np.array(  # noqa: E731
        [f * w.batch_size * w.steps * 1e-3 for f, w in zip((3.0, 1.0, 1.0, 1.0), plan.workers)])
    jrec = SmallJaxLM(JaxConfig(**kw("jax")), bundle=make_tiny_corpus(tmp_path / "corpus"),
                      timing_model=lm_time, log_to_file=False).run()
    tr = SmallLM(Config(**kw("torch")), bundle=Corpus(str(tmp_path / "corpus")),
                 timing_model=lm_time, device="cpu", log_to_file=False)
    rec = tr.run()
    assert rec.data["partition"] == jrec.data["partition"]
    assert rec.data["node_time"] == jrec.data["node_time"]
    assert np.isfinite(rec.data["train_loss"]).all()
    for p in tr.params:
        assert p.dtype == tr.optimizer.state[p]["momentum_buffer"].dtype == torch.float32


@pytest.fixture
def spies(monkeypatch):
    """Record the dtype of the model's first layer's output in every probe
    (``engine.probe_grads``) and in ``validate``, and the parameters' dtypes
    there."""
    seen = {"probe": [], "validate": [], "validate_params": []}

    def first_layer(model):
        return next(m for m in model.modules() if isinstance(m, (torch.nn.Conv2d, torch.nn.Embedding)))

    def spy(where, fn):
        def wrapped(model, *a, **k):
            h = first_layer(model).register_forward_hook(lambda m, i, o: seen[where].append(o.dtype))
            try:
                return fn(model, *a, **k)
            finally:
                h.remove()
        return wrapped

    def spy_validate(validate):
        def wrapped(self):
            seen["validate_params"] += [p.dtype for p in self.model.parameters()]
            return spy("validate", lambda model: validate(self))(self.model)
        return wrapped

    monkeypatch.setattr(engine, "probe_grads", spy("probe", engine.probe_grads))
    for cls in (Trainer, LMTrainer):
        monkeypatch.setattr(cls, "validate", spy_validate(cls.validate))
    return seen


@pytest.mark.parametrize("recipe", [
    "-m mnistnet -ds mnist -ws 2 -b 64 --n_train 512 --straggler 3,1",
    "-m mnistnet -ds mnist -ws 2 -b 64 --n_train 512 --straggler 3,1 --packed off "
    "--fault_mode compute",
    "-m transformer -ds wikitext2 -ws 2 -b 8 --bptt 16 --grad_clip 0.25 --straggler 3,1 "
    "--use_flash_attention true",
], ids=["packed", "elastic-compute", "lm"])
def test_cli_trains_in_bf16(tmp_path, spies, recipe):
    """``cli.main ... --precision bfloat16``, 2 epochs: the 9 series, finite
    losses; every probe (and, in compute mode, the calibration, which times
    through the same probe) ran the cast forward; ``validate`` ran on the
    f32 parameters, in f32."""
    argv = recipe.split() + ["-e", "2", "--precision", "bfloat16",
                             "--log_dir", str(tmp_path / "logs"), "--stat_dir", str(tmp_path / "statis")]
    if "transformer" in recipe:
        make_tiny_corpus(tmp_path / "corpus")
        argv += ["--lm_data_dir", str(tmp_path / "corpus")]
    assert cli.main(argv, device="cpu") == 0
    cfg = config_from_args(argv)
    with open(os.path.join(cfg.stat_dir, cfg.base_filename().format(0) + ".json")) as f:
        saved = json.load(f)
    for k in SERIES:
        assert len(saved[k]) == 2, k
    assert np.isfinite(saved["train_loss"]).all() and np.isfinite(saved["val_loss"]).all()
    assert spies["probe"] and set(spies["probe"]) == {BF16}
    assert spies["validate"] and set(spies["validate"]) == {torch.float32}
    assert set(spies["validate_params"]) == {torch.float32}
    if "compute" in recipe:
        assert saved["_meta"]["iter_cost_s"] > 0


# -------------------------------------------------------------------- flags

_LM = dict(model="transformer", dataset="wikitext2")
STILL_UNPORTED = [
    {"coordinator": "localhost:1"}, {"process_id": 1}, {"rebalance": "window", **_LM},
]
# the language model's fused paths and ranks, sequence parallelism,
# --elastic in one process and checkpoints across processes
LIFTED = [
    {"elastic": "on", "grad_comm": "hier", "hier_hosts": 2}, {"elastic": "on"},
    {"ckpt_dir": "ck", "num_processes": 2},
    {"fused_dbs": True, **_LM}, {"shard_update": True, **_LM},
    {"compress_grads": "int8", **_LM, "dynamic_batch_size": False},
    {"grad_accum": 2, **_LM, "dynamic_batch_size": False}, {"num_processes": 2, **_LM},
    {"seq_parallel": "ring", **_LM}, {"seq_parallel": "ring", "remat": True, **_LM},
    {"seq_parallel": "ulysses", **_LM},
]


def test_precision_flag_is_accepted():
    cfg = config_from_args("-m densenet -ds cifar10 --precision bfloat16".split())
    assert cfg.precision == "bfloat16"
    assert Config(model="densenet", dataset="cifar10").precision == "float32"
    with pytest.raises(ValueError, match="precision"):
        Config(model="densenet", dataset="cifar10", precision="float16")


@pytest.mark.parametrize("override", STILL_UNPORTED, ids=lambda o: next(iter(o)))
def test_still_unported_flags_raise_under_bf16(override):
    with pytest.raises(NotImplementedError, match=f"--{next(iter(override))}"):
        Config(**dict(dict(model="densenet", dataset="cifar10", precision="bfloat16"), **override))


@pytest.mark.parametrize("override", LIFTED, ids=lambda o: next(iter(o)))
def test_lifted_flags_are_accepted_under_bf16(override):
    kw = dict(dict(model="densenet", dataset="cifar10", precision="bfloat16"), **override)
    JaxConfig(**kw)
    assert Config(**kw).precision == "bfloat16"


# ------------------------------------------------------------ K1's routes


@pytest.mark.parametrize("name", ["densenet", "resnet", "googlenet", "regnet"])
def test_k1_takes_the_tiled_route_in_bf16_at_every_packed_shape(name):
    """Every GroupNorm call of DenseNet-121, ResNet-101, GoogLeNet and
    RegNetY-400MF at a packed step's b = 512, forward and backward, in
    bf16: ``plan`` picks the tiled route (C in whole 8-element vectors),
    as in f32."""
    model = build_model(name).to(memory_format=torch.channels_last)
    calls = []
    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(lambda m, i, o: calls.append((i[0].shape[2] * i[0].shape[3],
                                                                  i[0].shape[1], m.num_groups)))
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    assert calls
    for s, c, g in calls:
        for back in (False, True):
            assert plan(512, s, c, g, BF16, back).route == "tiled", (s, c, g, back)
