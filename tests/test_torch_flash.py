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


# ------------------------------------------------------------- tiled route

@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [1, 33, 100, 128])
@pytest.mark.parametrize("t", [65, 127, 129, 256])
def test_tiled_route_matches_the_jax_kernel(t, d, causal):
    """Above ``SHORT_T`` the port's ``flash_attention`` on the CPU runs the
    tiled route's host code (the ``[BH, T, D]`` flattening, delta, the
    layouts handed back) over the kernels' plain versions: its output and
    gradients against the JAX kernel's, and its lse against the one the
    JAX kernel writes, at the route's first T, either side of a 64-row
    tile, the language model's --bptt 256 window, and D from 1 to 128."""
    q, k, v, tgt = _inputs((1, 2, t, d), seed=t + d)

    def loss(q, k, v):
        o = jax_flash(q, k, v, causal=causal, block_q=64, block_k=64)
        return jnp.sum((o - tgt) ** 2), o

    (_, o_want), g_want = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v))
    )
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    runtime.reset_launches()
    o = flash_attention(qt, kt, vt, causal=causal)
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_want), atol=2e-5, rtol=0)
    grads = torch.autograd.grad(((o - torch.from_numpy(tgt)) ** 2).sum(), (qt, kt, vt))
    for got, want, name in zip(grads, g_want, "qkv"):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-4, rtol=0, err_msg=f"d{name}")
    assert not any(runtime.LAUNCHES.values())  # CPU tensors: the plain versions
    _, lse = fa._tiled_fwd(*(torch.from_numpy(a) for a in (q, k, v)), causal)
    _, lse_want, _ = _fwd_impl(*(jnp.asarray(a.reshape(2, t, d)) for a in (q, k, v)), causal, 64, 64, True)
    np.testing.assert_allclose(lse.reshape(2, t).numpy(), np.asarray(lse_want)[:, 0, :t], atol=2e-5, rtol=0)


def _tf32(x: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest with ties away from
    zero: ``cvt.rna.tf32.f32``."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _unit_reads(x: np.ndarray) -> np.ndarray:
    """An f32 register as the TF32 unit reads it: its low 13 bits dropped."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return (u & np.uint32(0xFFFFE000)).view(np.float32)


def _mma_product(a: np.ndarray, b: np.ndarray, terms: str) -> np.ndarray:
    """``a @ b`` as the tensor cores form it from f32 operands, 8 products
    of the contraction at a time (one m16n8k8 k-step) into an f32
    accumulator: ``terms`` "3xtf32" splits each operand as the kernels do,
    hi = x rounded to TF32 and lo = x - hi as the unit reads it, and adds
    lo*hi, hi*lo, hi*hi; "tf32" rounds each operand to TF32 and adds the one
    product; "f32" adds the f32 operands' product."""
    if terms == "3xtf32":
        ah, bh = _tf32(a), _tf32(b)
        al, bl = _unit_reads(a - ah), _unit_reads(b - bh)
        pairs = [(al, bh), (ah, bl), (ah, bh)]
    elif terms == "tf32":
        pairs = [(_tf32(a), _tf32(b))]
    else:
        pairs = [(a, b)]
    acc = np.zeros((a.shape[0], b.shape[1]), dtype=np.float32)
    for k0 in range(0, a.shape[1], 8):
        for x, y in pairs:  # each step's products exact, then rounded into f32
            acc = (acc.astype(np.float64) + x[:, k0:k0 + 8].astype(np.float64)
                   @ y[k0:k0 + 8].astype(np.float64)).astype(np.float32)
    return acc


def _forward(q, k, v, terms=None):
    """Causal attention forward ``(o, lse)``: in f64 when ``terms`` is None,
    else in f32 with both products (S = Q K^T, O = P V) as ``_mma_product``
    forms them."""
    t, d = q.shape
    dt = np.float64 if terms is None else np.float32
    mm = (lambda a, b: a @ b) if terms is None else (lambda a, b: _mma_product(a, b, terms))
    s = mm(q.astype(dt), k.T.astype(dt)).astype(dt) * dt(1.0 / np.sqrt(d))
    s = np.where(np.tril(np.ones((t, t), dtype=bool)), s, dt(-1e30))
    m = s.max(axis=1, keepdims=True)
    p = np.exp(s - m).astype(dt)
    l = p.sum(axis=1, keepdims=True)
    o = mm(p, v.astype(dt)).astype(dt) / l
    return o, (m + np.log(l))[:, 0]


def test_3xtf32_products_keep_the_forward_within_its_tolerance():
    """The tiled kernels' arithmetic, emulated: both products of the causal
    forward at (1, 1, 512, 128) in 3xTF32 stay within the forward tolerance
    (2e-5) of an f64 forward, with an error of the order of plain f32's
    (within 4x); one TF32 term alone misses the tolerance."""
    q, k, v, _ = _inputs((512, 128), seed=9)
    o64, lse64 = _forward(q, k, v)
    err = {}
    for terms in ("3xtf32", "f32", "tf32"):
        o, lse = _forward(q, k, v, terms)
        err[terms] = max(np.abs(o - o64).max(), np.abs(lse - lse64).max())
    assert err["3xtf32"] <= 2e-5, err
    assert err["3xtf32"] <= 4 * err["f32"], err
    assert err["tf32"] > 2e-5, err
