"""The port's kernels (K1 GroupNorm + relu, K2 softmax cross-entropy) against
the JAX package's Pallas kernels, which run in interpret mode on the CPU.

On the CPU the port's wrappers run their plain PyTorch versions, so these
tests hold the plain versions to the Pallas kernels; tests/test_torch_cuda.py
holds the CUDA kernels to the plain versions on a card.

Tolerances, as in tests/test_pallas.py: GroupNorm forward atol 1e-4 (f32
statistics, different reduction order), gradients atol 5e-4, cross-entropy
forward and backward atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.ops.pallas import (
    fused_group_norm,
    fused_softmax_xent,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
    group_norm,
    group_norm_bwd,
    group_norm_fwd,
    group_norm_ref,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
    softmax_xent,
    xent_bwd,
    xent_fwd,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

GN_CASES = [((3, 8, 8, 64), 32), ((2, 16, 16, 24), 8), ((4, 10, 48), 16)]


def _gn_inputs(shape, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*shape).astype(np.float32)
    c = shape[-1]
    return x, rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)


def _to3(x: np.ndarray) -> torch.Tensor:
    b, c = x.shape[0], x.shape[-1]
    return torch.from_numpy(x.reshape(b, -1, c))


# ------------------------------------------------------------- GroupNorm


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_forward_matches_pallas(shape, groups, relu):
    x, s, b = _gn_inputs(shape)
    want = fused_group_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b), groups, relu=relu)
    got = group_norm(_to3(x), torch.from_numpy(s), torch.from_numpy(b), groups, relu=relu)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(want).reshape(got.shape), atol=1e-4
    )


@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups", GN_CASES)
def test_groupnorm_grads_match_pallas(shape, groups, relu):
    x, s, b = _gn_inputs(shape, seed=1)

    def f_jax(x, s, b):
        return jnp.sum(jnp.tanh(fused_group_norm(x, s, b, groups, relu=relu)))

    want = jax.grad(f_jax, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    xt, st, bt = (torch.from_numpy(a).requires_grad_() for a in (x, s, b))
    xt3 = xt.reshape(x.shape[0], -1, x.shape[-1])
    torch.tanh(group_norm(xt3, st, bt, groups, relu=relu)).sum().backward()
    for got, w in zip((xt.grad, st.grad, bt.grad), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=5e-4)


def test_groupnorm_bf16_keeps_bf16():
    x, s, b = _gn_inputs((2, 16, 32), seed=2)
    xb = _to3(x).to(torch.bfloat16)
    y = group_norm(xb, torch.from_numpy(s), torch.from_numpy(b), 8, relu=True)
    assert y.dtype == torch.bfloat16 and y.shape == xb.shape
    ref = group_norm_ref(xb.float(), torch.from_numpy(s), torch.from_numpy(b), 8, relu=True)
    # bf16 keeps 8 bits of mantissa: outputs of magnitude ~3 round by ~1e-2
    np.testing.assert_allclose(y.float().numpy(), ref.numpy(), atol=3e-2)


def test_groupnorm_large_mean_no_nan():
    """Cancellation guard: E[x^2]-mean^2 clamps at 0 for a huge mean."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy((1000.0 + 0.01 * rng.randn(2, 16, 32)).astype(np.float32))
    y = group_norm(x, torch.ones(32), torch.zeros(32), 32)
    assert torch.isfinite(y).all()


def test_groupnorm_kernel_wrappers_refuse_cpu_tensors():
    x, s, b = (torch.from_numpy(a) for a in _gn_inputs((2, 4, 32)))
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_fwd(x, s, b, 8)
    mean = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        group_norm_bwd(x, x, s, b, mean, mean, 8)
    with pytest.raises(ValueError, match="no kernel"):
        group_norm(x.to("meta"), s.to("meta"), b.to("meta"), 8)


# -------------------------------------------------------- cross-entropy


def _xent_inputs(v: int, r: int = 13, seed: int = 2):
    rng = np.random.RandomState(seed)
    logits = (rng.randn(r, v) * 3).astype(np.float32)
    labels = rng.randint(0, v, (r,)).astype(np.int64)
    labels[0], labels[-1] = 0, v - 1  # both ends of the class range
    return logits, labels, rng.rand(r).astype(np.float32)


@pytest.mark.parametrize("v", [10, 1000])
def test_xent_forward_matches_pallas(v):
    logits, labels, _ = _xent_inputs(v)
    want = fused_softmax_xent(jnp.asarray(logits), jnp.asarray(labels.astype(np.int32)))
    got = softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("v", [10, 1000])
def test_xent_backward_matches_pallas(v):
    logits, labels, w = _xent_inputs(v, seed=3)
    lbl = jnp.asarray(labels.astype(np.int32))
    want = jax.grad(lambda l: jnp.sum(fused_softmax_xent(l, lbl) * w))(jnp.asarray(logits))
    lt = torch.from_numpy(logits).requires_grad_()
    (softmax_xent(lt, torch.from_numpy(labels)) * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want), atol=1e-5)


def test_xent_kernel_wrappers_refuse_cpu_tensors():
    logits, labels, w = (torch.from_numpy(a) for a in _xent_inputs(10))
    with pytest.raises(ValueError, match="CUDA"):
        xent_fwd(logits, labels)
    with pytest.raises(ValueError, match="CUDA"):
        xent_bwd(logits, labels, w)


def test_kernel_library_key_covers_source_and_flags(tmp_path, monkeypatch):
    """The build cache key changes with the source, so an edited kernel is
    rebuilt rather than a stale library loaded."""
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(runtime, "CSRC", tmp_path)
    first = runtime._lib_path("k")
    src.write_text("// two\n")
    assert runtime._lib_path("k") != first
    assert runtime._lib_path("k").parent == runtime.BUILD_DIR
