"""The port's ResNet, GoogLeNet and RegNet against the JAX package's flax
models, through the weight bridge (``bridge.params_from_flax``).

Same inputs (numpy, seeded), same weights (flax init, bridged), batch 2:

- logits (or a module's output) in f32 on both sides, within atol 1e-4;
- parameter gradients of ``sum(out * r)`` in float64 on both sides (the
  port's model and input cast to f64; the JAX model under
  ``jax.enable_x64`` with params and input cast), within atol 5e-4 (they
  agree within about 1e-12). In f32 a relu pre-activation can lie within
  rounding of zero, and which side of it each package's f32 lands on moves
  a gradient by up to 1e-2: the JAX side's f32 gradients of the Bottleneck
  ResNet are 1.2e-2 from its own f64 ones (the port's f32 within 4e-6 of
  them), the port's of the RegNet case 7.4e-3 (the JAX side's within 7e-7),
  measured on the CPU. An f32 comparison would test that rounding, not the
  port.

Input sizes: RegNet at 16x16, as DenseNet's parity test. ResNet's final
4x4 pool and GoogLeNet's 8x8 one need a 32x32 input (at 16x16 the pooled
map is empty). GoogLeNet at its published widths compiles its gradient in
about 230 s on the CPU, so its full model is held at the logits only, and
its gradients on one Inception module (at 8x8 with 192 channels) and on the
stem alone.
"""

import copy
import math

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu.models import googlenet as flax_googlenet
from dynamic_load_balance_distributeddnn_tpu.models import regnet as flax_regnet
from dynamic_load_balance_distributeddnn_tpu.models import resnet as flax_resnet
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model, googlenet, regnet, resnet
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# one block a stage; widths with GroupNorm groups gcd(32, w) = 8, 16, 32, 32
REGNET_CFG = dict(depths=[1, 1, 1, 1], widths=[24, 48, 96, 192], strides=[1, 1, 2, 2],
                  group_width=24, bottleneck_ratio=1, se_ratio=0.25)


class FlaxStem(fnn.Module):
    """GoogLeNet's stem: its first ``_conv_gn_relu``."""

    @fnn.compact
    def __call__(self, x):
        return flax_googlenet._conv_gn_relu(x, 192, 3, 8)


def torch_stem():
    stem = nn.Module()
    googlenet._add_conv_gn_relu(stem, 0, 3, 192, 3, 8)
    return stem


def nchw_out(fn):
    """A port module's NCHW output on an NHWC input, as NHWC (flax's)."""
    return lambda m, x: fn(m, x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


CASES = {
    "resnet_basic": (lambda: flax_resnet.ResNet(flax_resnet.BasicBlock, (1, 1, 1, 1)),
                     lambda: resnet.ResNet(resnet.BasicBlock, (1, 1, 1, 1)),
                     (2, 32, 32, 3), lambda m, x: m(x)),
    "resnet_bottleneck": (lambda: flax_resnet.ResNet(flax_resnet.Bottleneck, (1, 1, 1, 1)),
                          lambda: resnet.ResNet(resnet.Bottleneck, (1, 1, 1, 1)),
                          (2, 32, 32, 3), lambda m, x: m(x)),
    "regnet": (lambda: flax_regnet.RegNet(REGNET_CFG), lambda: regnet.RegNet(REGNET_CFG),
               (2, 16, 16, 3), lambda m, x: m(x)),
    "inception": (lambda: flax_googlenet.Inception(64, 96, 128, 16, 32, 32),
                  lambda: googlenet.Inception(192, 64, 96, 128, 16, 32, 32),
                  (2, 8, 8, 192), nchw_out(lambda m, x: m(x))),
    "googlenet_stem": (FlaxStem, torch_stem, (2, 16, 16, 3),
                       nchw_out(lambda m, x: googlenet._conv_gn_relu(m, 0, x))),
}


def _bridged(flax_ctor, torch_ctor, shape):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    fmod = flax_ctor()
    params = fmod.init(jax.random.PRNGKey(0), jnp.zeros((1,) + shape[1:]))
    model = torch_ctor().to(memory_format=torch.channels_last)
    model.load_state_dict(params_from_flax(params, model))
    return fmod, params, model.eval(), x


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    flax_ctor, torch_ctor, shape, forward = CASES[request.param]
    fmod, params, model, x = _bridged(flax_ctor, torch_ctor, shape)
    return fmod, params, model, x, forward


def _apply(fmod, params, x):
    kw = {"train": False} if isinstance(fmod, (flax_resnet.ResNet, flax_regnet.RegNet)) else {}
    return fmod.apply(params, x, **kw)


def test_logits_match_flax(case):
    fmod, params, model, x, forward = case
    want = np.asarray(_apply(fmod, params, jnp.asarray(x)))
    with torch.no_grad():
        got = forward(model, torch.from_numpy(x))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_param_grads_match_flax(case):
    fmod, params, model, x, forward = case
    with torch.no_grad():
        out_shape = tuple(forward(model, torch.from_numpy(x)).shape)
    r = np.random.RandomState(1).randn(*out_shape)
    with jax.enable_x64(True):
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(np.asarray(a), jnp.float64), params)
        grads = jax.grad(
            lambda p: jnp.sum(_apply(fmod, p, jnp.asarray(x, jnp.float64)) * jnp.asarray(r))
        )(p64)
        grads = jax.tree_util.tree_map(np.asarray, grads)
    model = copy.deepcopy(model).double()  # the fixture's model stays f32
    (forward(model, torch.from_numpy(x).double()) * torch.from_numpy(r)).sum().backward()
    want = params_from_flax(grads, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].double().numpy(), atol=5e-4,
                                   err_msg=name)


def test_googlenet_logits_at_published_widths():
    fmod, params, model, x = _bridged(flax_googlenet.GoogLeNet, googlenet.GoogLeNet, (2, 32, 32, 3))
    want = np.asarray(fmod.apply(params, jnp.asarray(x), train=False))
    with torch.no_grad():
        got = model(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


@pytest.mark.parametrize("name,ctor,params", [
    ("resnet", resnet.ResNet101, 42_512_970),
    ("resnet18", resnet.ResNet18, 11_173_962),
    ("googlenet", googlenet.GoogLeNet, 6_166_250),
    ("regnet", regnet.RegNetY_400MF, 5_714_362),
    ("regnetx200mf", regnet.RegNetX_200MF, 2_321_946),
])
def test_family_names_build_the_reference_constructors(name, ctor, params):
    """``-m`` names select the reference's constructors (``resnet`` is
    ResNet-101, ``regnet`` RegNetY-400MF), with the JAX models' parameter
    counts, and the config accepts them."""
    model = build_model(name)
    assert type(model) is type(ctor()) and sum(p.numel() for p in model.parameters()) == params
    assert Config(model=name, dataset="cifar10").model == name


@pytest.mark.parametrize("name,ctor", [
    ("resnet101", flax_resnet.ResNet101), ("googlenet", flax_googlenet.GoogLeNet),
    ("regnety400mf", flax_regnet.RegNetY_400MF),
])
def test_parameter_counts_equal_the_flax_models(name, ctor):
    shapes = jax.eval_shape(lambda: ctor().init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
    want = sum(math.prod(a.shape) for a in jax.tree_util.tree_leaves(shapes))
    assert sum(p.numel() for p in build_model(name).parameters()) == want


@pytest.mark.parametrize("name,groups", [
    ("regnetx200mf", {8, 16, 32}), ("googlenet", {8, 16}), ("resnet", {32}),
])
def test_groupnorm_group_counts(name, groups):
    """GroupNorm groups as the JAX package sets them: ``gcd(32, C)``
    (RegNetX-200MF's 24, 56, 152 and 368 channels take 8, 8, 8 and 16
    groups, its 64-channel stem 32), GoogLeNet's fixed 8 and 16."""
    got = {m.num_groups for m in build_model(name).modules() if isinstance(m, GroupNorm)}
    assert got == groups


def test_plain_groupnorm_keeps_float64_as_flax_does():
    """flax's GroupNorm computes its statistics in at least f32 and keeps an
    f64 input in f64; the port's plain version did its sums in f32 whatever
    the input (found and repaired with the zoo's f64 gradient checks). f64
    against flax in f64: within 1e-12."""
    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import group_norm_ref

    x = np.random.RandomState(3).randn(2, 4, 4, 48) * 3 + 5
    with jax.enable_x64(True):
        gn = fnn.GroupNorm(num_groups=16, epsilon=1e-6)
        want = np.asarray(gn.apply(gn.init(jax.random.PRNGKey(0), jnp.asarray(x)), jnp.asarray(x)))
    got = group_norm_ref(torch.from_numpy(x).reshape(2, 16, 48), torch.ones(48, dtype=torch.float64),
                         torch.zeros(48, dtype=torch.float64), 16)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy().reshape(x.shape), want, atol=1e-12)
