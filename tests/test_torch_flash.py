"""K3 (flash attention) of the port against the JAX package's Pallas kernel,
run in interpret mode on the CPU as ``tests/test_pallas.py`` runs it.

The same seeded numpy q, k, v go through the JAX ``flash_attention`` and
through the port's ``flash_attention`` (on the CPU: the kernels' plain
versions under the same autograd function as on the card) and its
``attention_ref``. Tolerances are the JAX package's own for its kernel:
forward atol 2e-5, gradients atol 5e-4. The CUDA kernels themselves are
held against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``). The short route's inputs also come as the model passes
them: ``[B, H, T, D]`` views of ``[B, T, H*D]`` buffers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.ops.pallas import flash_attention as jax_flash
from dynamic_load_balance_distributeddnn_tpu.ops.pallas.flash_attention import _fwd_impl
from dynamic_load_balance_distributeddnn_tpu_torch.obs.kernel_timing import attn_work
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import flash_attention as fa
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
    attention_ref,
    attn_bwd_dkv,
    attn_bwd_short,
    attn_bwd_short_ref,
    attn_fwd,
    attn_fwd_ref,
    attn_fwd_short,
    flash_attention,
    plan,
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


# the short route's shapes: the LM path's, and a T below 64 that is not a
# multiple of 8 with a head dim that is not a multiple of 4
SHORT_CASES = [(2, 2, 35, 100), (1, 3, 21, 13)]


def _model_view(a: np.ndarray, requires_grad: bool = False) -> torch.Tensor:
    """A [B, H, T, D] array as the model passes it: a view of a [B, T, H*D]
    buffer."""
    b, h, t, d = a.shape
    buf = torch.from_numpy(np.ascontiguousarray(a.transpose(0, 2, 1, 3)).reshape(b, t, h * d))
    buf.requires_grad_(requires_grad)
    return buf, buf.view(b, t, h, d).transpose(1, 2)


@pytest.fixture(scope="module", params=[(s, c) for s in SHORT_CASES for c in (False, True)],
                ids=lambda p: f"{'x'.join(map(str, p[0]))}-{'causal' if p[1] else 'full'}")
def jax_short(request):
    """The JAX kernel's output and the gradients of sum((o - tgt)^2), at the
    short route's shapes."""
    shape, causal = request.param
    q, k, v, tgt = _inputs(shape, seed=5)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=32, block_k=32)
        return jnp.sum((o - tgt) ** 2), o

    (_, o), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v))
    )
    return (q, k, v, tgt), causal, np.asarray(o), [np.asarray(g) for g in grads]


def test_strided_views_match_the_jax_kernel(jax_short):
    """The model's strided views through ``flash_attention`` (the CPU route
    of the autograd function), forward and gradients."""
    (q, k, v, tgt), causal, o_want, g_want = jax_short
    bufs, views = zip(*(_model_view(a, requires_grad=True) for a in (q, k, v)))
    o = flash_attention(*views, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), o_want, atol=2e-5, rtol=0)
    ((o - torch.from_numpy(tgt)) ** 2).sum().backward()
    for buf, want, name in zip(bufs, g_want, "qkv"):
        got = buf.grad.view(*want.transpose(0, 2, 1, 3).shape).permute(0, 2, 1, 3)
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0, err_msg=f"d{name}")


def test_plain_fused_backward_matches_the_jax_kernel(jax_short):
    """``attn_bwd_short_ref`` from the forward's o and lse, delta computed
    inside, against the JAX kernel's gradients (dO = 2 (o - tgt))."""
    (q, k, v, tgt), causal, _, g_want = jax_short
    views = [_model_view(a)[1] for a in (q, k, v)]
    o, lse = attn_fwd_ref(*views, causal)
    do = 2 * (o - torch.from_numpy(tgt))
    grads = attn_bwd_short_ref(*views, do, o, lse, causal)
    for got, want, x, name in zip(grads, g_want, views, "qkv"):
        np.testing.assert_allclose(got.numpy(), want, atol=5e-4, rtol=0, err_msg=f"d{name}")
        assert got.stride() == x.stride(), name


def test_cpu_route_gives_the_card_route_layouts_without_copies():
    """The output is a [B, H, T, D] view of a [B, T, H, D] buffer, as the
    short kernel writes it, so the model's ``o.transpose(1, 2).reshape(b, t,
    e)`` is a view; each gradient reaches the projection's buffer in its own
    [B, T, H*D] layout."""
    b, h, t, d = 2, 2, 35, 100
    rng = np.random.RandomState(1)
    bufs, views = zip(*(_model_view(rng.randn(b, h, t, d).astype(np.float32), True) for _ in range(3)))
    o = flash_attention(*views, causal=True)
    assert o.stride() == (t * h * d, d, h * d, 1)
    flat = o.transpose(1, 2).reshape(b, t, h * d)
    assert flat.data_ptr() == o.data_ptr() and flat.is_contiguous()
    flat.sum().backward()
    assert all(buf.grad.shape == buf.shape and buf.grad.is_contiguous() for buf in bufs)


@pytest.mark.parametrize("bh", [1, 6, 40, 52, 80, 127, 128, 2048])
@pytest.mark.parametrize("t", [1, 17, 35, 64])
def test_short_route_plan_is_a_launch_the_kernels_take(bh, t):
    (rows, threads), (bwd_threads, parts) = plan(bh, t, 100)
    whole = (t + 3) // 4 * 4
    assert rows % 4 == 0 and 4 <= rows <= whole
    assert rows == (whole if bh >= fa.SPLIT_BH else min(fa.FWD_ROWS, whole))
    for n in (threads, bwd_threads):
        assert n % 32 == 0 and 32 <= n <= 384
    assert parts == (2 if bh < fa.BWD_SPLIT_BH else 1)


def test_short_kernels_refuse_cpu_tensors():
    q = torch.zeros(1, 2, 8, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_fwd_short(q, q, q, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_bwd_short(q, q, q, q, q, q[..., 0], True)


def test_attn_work_counts_each_input_read_and_output_written_once():
    """The fused backward reads q, k, v, dO, o and lse and writes dq, dk, dv
    (no delta); the tiled pair reads delta and lse twice between them."""
    b, h, t, d = 40, 2, 35, 100
    mat, rows = b * h * t * d * 4, b * h * t * 4
    pairs = b * h * t * (t + 1) // 2
    work = attn_work((b, h, t, d), True)
    assert work["attn_fwd"] == (4 * mat + rows, 4 * d * pairs)
    assert work["attn_bwd"] == (8 * mat + rows, 10 * d * pairs + 2 * d * b * h * t)
    assert work["attn_bwd_dkv"][0] + work["attn_bwd_dq"][0] == 11 * mat + 4 * rows
