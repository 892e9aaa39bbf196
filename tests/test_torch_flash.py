"""K3 (flash attention) of the port against the JAX package's Pallas kernel,
run in interpret mode on the CPU as ``tests/test_pallas.py`` runs it.

The same seeded numpy q, k, v go through the JAX ``flash_attention`` and
through the port's ``flash_attention`` (on the CPU: the kernels' plain
versions under the same autograd function as on the card) and its
``attention_ref``. Tolerances are the JAX package's own for its kernel:
forward atol 2e-5, gradients atol 5e-4. The CUDA kernels themselves are
held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.ops.pallas import flash_attention as jax_flash
from dynamic_load_balance_distributeddnn_tpu.ops.pallas.flash_attention import _fwd_impl
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
    attention_ref,
    attn_bwd_dkv,
    attn_fwd,
    attn_fwd_ref,
    flash_attention,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# (shape, block_q, block_k): the LM path's T and D, and the JAX tests'
# mixed-block case
CASES = [((2, 2, 35, 100), 128, 128), ((2, 2, 96, 16), 32, 16)]


def _inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    q = (rng.randn(*shape) * 0.5).astype(np.float32)
    k = (rng.randn(*shape) * 0.5).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    tgt = rng.randn(*shape).astype(np.float32)
    return q, k, v, tgt


@pytest.fixture(scope="module", params=[(c, causal) for c in CASES for causal in (False, True)],
                ids=lambda p: f"{'x'.join(map(str, p[0][0]))}-{'causal' if p[1] else 'full'}")
def jax_run(request):
    """The JAX kernel's output and the gradients of sum((o - tgt)^2)."""
    (shape, bq, bk), causal = request.param
    q, k, v, tgt = _inputs(shape)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=bq, block_k=bk)
        return jnp.sum((o - tgt) ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v))
    )
    return (q, k, v, tgt), causal, np.asarray(o), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("fn", ["flash_attention", "attention_ref"])
def test_forward_and_gradients_match_the_jax_kernel(jax_run, fn):
    (q, k, v, tgt), causal, o_want, g_want = jax_run
    attend = {"flash_attention": flash_attention, "attention_ref": attention_ref}[fn]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o = attend(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), o_want, atol=2e-5, rtol=0)
    grads = torch.autograd.grad(((o - torch.from_numpy(tgt)) ** 2).sum(), (qt, kt, vt))
    for got, want, name in zip(grads, g_want, "qkv"):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("causal", [False, True])
def test_plain_forward_lse_matches_the_jax_kernel(causal):
    """The saved log-sum-exp of the forward's plain version against the one
    the JAX kernel writes (its [bh, 1, t_pad] layout, sliced)."""
    q, k, v, _ = _inputs((2, 2, 35, 100), seed=3)
    flat = [a.reshape(4, 35, 100) for a in (q, k, v)]
    o, lse, _ = _fwd_impl(*(jnp.asarray(a) for a in flat), causal, 48, 48, True)
    o_ref, lse_ref = attn_fwd_ref(*(torch.from_numpy(a) for a in flat), causal)
    np.testing.assert_allclose(o_ref.numpy(), np.asarray(o), atol=2e-5, rtol=0)
    np.testing.assert_allclose(lse_ref.numpy(), np.asarray(lse)[:, 0, :35], atol=2e-5, rtol=0)


def test_cpu_route_counts_no_launch_and_kernels_refuse_cpu_tensors():
    q = torch.randn(1, 2, 8, 4, requires_grad=True)
    runtime.reset_launches()
    flash_attention(q, q, q, causal=True).sum().backward()
    assert runtime.LAUNCHES["attn_fwd"] == runtime.LAUNCHES["attn_bwd_dkv"] == 0
    flat = q.detach().reshape(2, 8, 4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_fwd(flat, flat, flat, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_bwd_dkv(flat, flat, flat, flat, flat[..., 0], flat[..., 0], True)
    with pytest.raises(ValueError, match="no kernel"):
        flash_attention(q.detach().to("meta"), q.detach().to("meta"), q.detach().to("meta"))
