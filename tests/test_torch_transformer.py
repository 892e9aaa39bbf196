"""The port's Transformer LM against the JAX package's flax model, through
the weight bridge.

A small model (ntoken 50, ninp 32, 2 heads, nhid 32, 2 layers) on seeded
tokens [3, 35] (the LM path's bptt), with flash attention (the JAX side runs
its Pallas kernel in interpret mode, the port the kernels' plain versions)
and with the plain multi-head attention; and with flash attention on tokens
[2, 96], a bptt above the port's short route (T <= 64), where the port's
attention takes the tiled kernels' plain versions. Dropout is off on both
sides (threefry and Philox never draw the same masks). Logits agree within
atol 1e-4 and every parameter gradient within 5e-4.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.models.transformer import (
    TransformerLM as FlaxLM,
    sinusoidal_positions as jax_positions,
)
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import (
    TransformerLM,
    sinusoidal_positions,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import SHORT_T
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

SMALL = dict(ntoken=50, ninp=32, nhead=2, nhid=32, nlayers=2, dropout=0.2)


@pytest.fixture(scope="module", params=[True, False], ids=["flash", "plain"])
def bridged(request):
    fmod = FlaxLM(**SMALL, use_flash=request.param)
    rng = np.random.RandomState(0)
    tokens = rng.randint(0, 50, (3, 35)).astype(np.int32)
    cot = rng.randn(3, 35, 50).astype(np.float32)
    params = fmod.init(jax.random.PRNGKey(0), jnp.asarray(tokens))["params"]
    model = TransformerLM(**SMALL, use_flash=request.param).eval()
    model.load_state_dict(params_from_flax(params, model))
    return fmod, params, model, tokens, cot


def test_logits_match_flax(bridged):
    fmod, params, model, tokens, _ = bridged
    want = fmod.apply({"params": params}, jnp.asarray(tokens))
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=0)


def test_param_grads_match_flax(bridged):
    fmod, params, model, tokens, cot = bridged
    grads = jax.grad(
        lambda p: jnp.sum(fmod.apply({"params": p}, jnp.asarray(tokens)) * cot)
    )(params)
    model.zero_grad()
    (model(torch.from_numpy(tokens)) * torch.from_numpy(cot)).sum().backward()
    want = params_from_flax(grads, model)
    assert set(want) == {n for n, _ in model.named_parameters()}
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(), atol=5e-4, rtol=0, err_msg=name)


@pytest.fixture(scope="module")
def bridged_long():
    """The flash-attention LM on tokens [2, 96]: T above ``SHORT_T``."""
    fmod = FlaxLM(**SMALL, use_flash=True)
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 50, (2, 96)).astype(np.int32)
    cot = rng.randn(2, 96, 50).astype(np.float32)
    params = fmod.init(jax.random.PRNGKey(1), jnp.asarray(tokens))["params"]
    model = TransformerLM(**SMALL, use_flash=True).eval()
    model.load_state_dict(params_from_flax(params, model))
    return fmod, params, model, tokens, cot


def test_logits_match_flax_above_the_short_route(bridged_long):
    assert bridged_long[3].shape[1] > SHORT_T
    test_logits_match_flax(bridged_long)


def test_param_grads_match_flax_above_the_short_route(bridged_long):
    test_param_grads_match_flax(bridged_long)


def test_bridge_maps_dense_general_and_embedding_layouts(bridged):
    _, params, model, _, _ = bridged
    sd = params_from_flax(params, model)
    q = np.asarray(params["EncoderLayer_0"]["attn"]["query"]["kernel"])  # [in, H, hd]
    out = np.asarray(params["EncoderLayer_0"]["attn"]["out"]["kernel"])  # [H, hd, out]
    assert q.shape == (32, 2, 16) and out.shape == (2, 16, 32)
    np.testing.assert_array_equal(sd["EncoderLayer_0.attn.query.weight"].numpy(), q.reshape(32, 32).T)
    np.testing.assert_array_equal(sd["EncoderLayer_0.attn.out.weight"].numpy(), out.reshape(32, 32).T)
    np.testing.assert_array_equal(sd["Embed_0.weight"].numpy(), np.asarray(params["Embed_0"]["embedding"]))
    np.testing.assert_array_equal(
        sd["EncoderLayer_1.LayerNorm_1.weight"].numpy(),
        np.asarray(params["EncoderLayer_1"]["LayerNorm_1"]["scale"]),
    )
    assert model.EncoderLayer_0.LayerNorm_0.eps == 1e-6  # flax's, not torch's 1e-5


def test_positions_equal_the_jax_table():
    np.testing.assert_array_equal(sinusoidal_positions(35, 200), jax_positions(35, 200))


def test_init_follows_flax_defaults():
    model = build_model("transformer", ntoken=300, ninp=64, nhead=2, nhid=48, nlayers=2)
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    emb = model.Embed_0.weight
    assert emb.min() >= -0.1 and emb.max() <= 0.1 and emb.abs().mean() > 0.04
    ln = model.EncoderLayer_1.LayerNorm_0
    assert torch.equal(ln.weight, torch.ones(64)) and torch.equal(ln.bias, torch.zeros(64))
    for lin, fan_in in ((model.EncoderLayer_0.attn.query, 64), (model.EncoderLayer_0.Dense_1, 48),
                        (model.Dense_0, 64)):
        std = math.sqrt(1.0 / fan_in)  # lecun_normal's target standard deviation
        assert abs(lin.weight.std().item() - std) < 0.1 * std
        assert torch.equal(lin.bias, torch.zeros_like(lin.bias))
    again = build_model("transformer", ntoken=300, ninp=64, nhead=2, nhid=48, nlayers=2)
    init_flax_defaults(again, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(model.parameters(), again.parameters()))


@pytest.mark.parametrize("use_flash", [True, False])
def test_dropout_is_seeded_and_off_in_eval(use_flash):
    """Train mode draws its masks from the modules' generator (the same seed
    gives the same logits); eval mode applies no dropout."""
    model = TransformerLM(**SMALL, use_flash=use_flash)
    init_flax_defaults(model, torch.Generator().manual_seed(0))
    tokens = torch.from_numpy(np.random.RandomState(1).randint(0, 50, (2, 35)))
    outs = []
    for _ in range(2):
        gen = torch.Generator().manual_seed(5)
        for m in model.modules():
            if hasattr(m, "generator"):
                m.generator = gen
        outs.append(model.train()(tokens))
    assert torch.equal(outs[0], outs[1])
    with torch.no_grad():
        ev = model.eval()(tokens)
    assert not torch.allclose(outs[0], ev)
