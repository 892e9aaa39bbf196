"""K2's plain versions (``xent_fwd_ref``, ``xent_bwd_ref``: what the CUDA
kernels compute, lse included) against the JAX package's Pallas kernel,
which runs in interpret mode on the CPU, and the launch plan the wrapper
picks. tests/test_torch_cuda.py holds the kernels to these plain versions
on a card.

Tolerances: loss, lse and gradient atol 1e-5, the JAX package's own for
its kernel (tests/test_pallas.py); each gradient entry also within rtol
1e-5 of the Pallas kernel's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.ops.pallas import fused_softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import xent
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
    plan,
    softmax_xent,
    softmax_xent_ref,
    xent_bwd_ref,
    xent_fwd_ref,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

VS = [10, 1000, 4099]


def _inputs(v: int, r: int = 13, seed: int = 0, out_of_range: bool = False):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(r, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, (r,)).astype(np.int64)
    labels[0], labels[-1] = 0, v - 1
    if out_of_range:
        labels[1], labels[2] = -1, v
    return logits, labels, rng.rand(r).astype(np.float32)


def _pallas_loss(logits, labels):
    return np.asarray(fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels.astype(np.int32))))


def _pallas_grad(logits, labels, w):
    lbl = jnp.asarray(labels.astype(np.int32))
    return np.asarray(jax.grad(lambda l: jnp.sum(fused_softmax_xent(l, lbl) * w))(jnp.asarray(logits)))


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("v", VS)
def test_xent_fwd_ref_matches_pallas(v, out_of_range):
    logits, labels, _ = _inputs(v, seed=v, out_of_range=out_of_range)
    loss, lse = xent_fwd_ref(torch.from_numpy(logits), torch.from_numpy(labels))
    assert loss.dtype == lse.dtype == torch.float32 and loss.shape == lse.shape == (13,)
    np.testing.assert_allclose(loss.numpy(), _pallas_loss(logits, labels), atol=1e-5)


@pytest.mark.parametrize("out_of_range", [False, True])
@pytest.mark.parametrize("v", VS)
def test_xent_bwd_ref_with_its_lse_matches_pallas_grad(v, out_of_range):
    logits, labels, w = _inputs(v, seed=v + 1, out_of_range=out_of_range)
    lt, yt = torch.from_numpy(logits), torch.from_numpy(labels)
    _, lse = xent_fwd_ref(lt, yt)
    dx = xent_bwd_ref(lt, yt, torch.from_numpy(w), lse).numpy()
    want = _pallas_grad(logits, labels, w)
    np.testing.assert_allclose(dx, want, atol=1e-5)
    # most entries are far below 1e-5 (about w * 1e-6 at V = 4099), so each
    # is also held to its own size; the gold column, where p - 1 cancels,
    # to 2**-20 * w (eight f32 steps of a p near 1: two exps apart)
    gold = np.arange(v)[None, :] == labels[:, None]
    lim = 1e-5 * np.abs(want) + gold * (2.0**-20 * w[:, None])
    assert (np.abs(dx - want) <= lim).all()


@pytest.mark.parametrize("v", VS)
def test_xent_lse_is_the_logsumexp(v):
    logits, labels, _ = _inputs(v, seed=v + 2)
    lt = torch.from_numpy(logits)
    _, lse = xent_fwd_ref(lt, torch.from_numpy(labels))
    torch.testing.assert_close(lse, torch.logsumexp(lt, -1), atol=1e-5, rtol=0)


def test_xent_out_of_range_label_gives_the_bare_lse_and_no_onehot():
    logits, labels, w = _inputs(10, seed=3, out_of_range=True)
    lt, yt, wt = torch.from_numpy(logits), torch.from_numpy(labels), torch.from_numpy(w)
    loss, lse = xent_fwd_ref(lt, yt)
    assert torch.equal(loss[1:3], lse[1:3])
    dx = xent_bwd_ref(lt, yt, wt, lse)
    torch.testing.assert_close(dx[1:3], wt[1:3, None] * torch.softmax(lt[1:3], -1), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_xent_refs_are_the_plain_loss_and_its_autograd(dtype):
    """The pair of plain versions is the loss the CPU route differentiates."""
    logits, labels, w = _inputs(1000, seed=4, out_of_range=True)
    lt = torch.from_numpy(logits).to(dtype).requires_grad_()
    yt, wt = torch.from_numpy(labels), torch.from_numpy(w)
    ref = softmax_xent_ref(lt, yt)
    (want,) = torch.autograd.grad(ref, lt, wt)
    loss, lse = xent_fwd_ref(lt.detach(), yt)
    torch.testing.assert_close(loss, ref.detach(), atol=1e-5, rtol=0)
    got = xent_bwd_ref(lt.detach(), yt, wt, lse)
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want.float(), atol=1e-5, rtol=2.0**-8 if dtype == torch.bfloat16 else 0)
    torch.testing.assert_close(softmax_xent(lt, yt), ref, atol=0, rtol=0)


@pytest.mark.parametrize("v,want", [
    (10, (0, 0)),       # a DenseNet worker's logits: a warp per row
    (100, (0, 0)),
    (1000, (0, 0)),
    (xent.SMALL_V - 1, (0, 0)),
    (xent.SMALL_V, (128, 512)),  # from here a block per row
    (18328, (128, 512)),  # the LM's vocabulary, at every row count
    (33278, (128, 512)),
])
def test_xent_plan_by_regime(v, want):
    assert plan(v) == want


@pytest.mark.parametrize("v", [1, 10, 100, xent.SMALL_V - 1, xent.SMALL_V, 4097, 4099, 18328,
                               33278, 2**20])
def test_xent_plan_takes_only_block_sizes_the_kernels_have(v):
    """0 (a warp per row) or a block of a multiple of 32 threads, at most
    512 (``kMaxThreads`` in ``csrc/xent.cu``)."""
    fwd, bwd = plan(v)
    assert all(t % 32 == 0 and 0 <= t <= 512 for t in (fwd, bwd))
    assert (fwd == 0) == (bwd == 0) == (v < xent.SMALL_V)
