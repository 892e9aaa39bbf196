"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Without a card every test skips: a CUDA kernel has no CPU mode.

Tolerances: f32 GroupNorm forward atol 1e-4 and gradients 5e-4 (f32
statistics, other reduction order); the parameter gradients are sums over
B*S terms, held relative to their size (rtol 1e-4); bf16 input and output
round to 8 significant bits (atol 3e-2 plus rtol 1e-2); cross-entropy atol
1e-5; flash attention forward atol 2e-5 and gradients 5e-4 (the JAX
package's own tolerances for its kernel, ``tests/test_pallas.py``).
"""

import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
    attention_ref,
    attn_bwd_dkv,
    attn_bwd_dq,
    attn_bwd_ref,
    attn_fwd,
    attn_fwd_ref,
    flash_attention,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
    group_norm_bwd,
    group_norm_fwd,
    group_norm_ref,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import (
    softmax_xent,
    softmax_xent_ref,
    xent_bwd,
    xent_fwd,
)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _gn_inputs(shape, seed):
    g = torch.Generator().manual_seed(seed)
    c = shape[-1]
    return (torch.randn(shape, generator=g), 1 + 0.1 * torch.randn(c, generator=g),
            0.1 * torch.randn(c, generator=g), torch.randn(shape, generator=g))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 0.0),
    (torch.bfloat16, 3e-2, 1e-2),
])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups", [
    ((4, 64, 64), 32), ((2, 16, 96), 32), ((3, 10, 24), 8), ((2, 9, 300), 1),
])
def test_groupnorm_kernels_match_plain(cuda, shape, groups, relu, dtype, atol, rtol):
    x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 4))
    x, dy = x.to(dtype), dy.to(dtype)
    y, mean, rstd = group_norm_fwd(x, w, b, groups, 1e-6, relu)
    xr, wr, br = (t.detach().clone().float().requires_grad_() for t in (x, w, b))
    yr = group_norm_ref(xr, wr, br, groups, 1e-6, relu)
    torch.testing.assert_close(y.float(), yr.detach(), atol=atol, rtol=rtol)
    dx, dw, db = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu)
    gx, gw, gb = torch.autograd.grad(yr, (xr, wr, br), dy.float())
    gatol = 5e-4 if dtype == torch.float32 else atol
    torch.testing.assert_close(dx.float(), gx, atol=gatol, rtol=rtol)
    torch.testing.assert_close(dw, gw, atol=gatol, rtol=max(rtol, 1e-4))
    torch.testing.assert_close(db, gb, atol=gatol, rtol=max(rtol, 1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("v", [10, 1000, 33278])
def test_xent_kernels_match_plain(cuda, v):
    g = torch.Generator().manual_seed(6)
    logits = (3 * torch.randn(13, v, generator=g)).to(cuda)
    labels = torch.randint(0, v, (13,), generator=g)
    labels[0], labels[-1] = 0, v - 1
    labels = labels.to(cuda)
    w = torch.rand(13, generator=g).to(cuda)
    loss = xent_fwd(logits, labels)
    lr = logits.clone().requires_grad_()
    ref = softmax_xent_ref(lr, labels)
    torch.testing.assert_close(loss, ref.detach(), atol=1e-5, rtol=0)
    (want,) = torch.autograd.grad(ref, lr, w)
    torch.testing.assert_close(xent_bwd(logits, labels, w), want, atol=1e-5, rtol=0)


@pytest.mark.cuda
def test_densenet_on_the_card_matches_the_cpu(cuda):
    """A reduced DenseNet through the kernels (card) and through the plain
    versions (CPU), same weights and inputs: logits and the loss gradient
    agree; every kernel launched. TF32 is off on the card, so both sides
    run full f32 (atol 1e-3: many layers of differently ordered f32 sums)."""
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    cpu = DenseNet((2, 2), growth_rate=32, image_size=16)
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    gpu = DenseNet((2, 2), growth_rate=32, image_size=16)
    gpu.load_state_dict(cpu.state_dict())
    gpu = gpu.to(cuda, memory_format=torch.channels_last)
    x = torch.randn(8, 16, 16, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (8,), generator=torch.Generator().manual_seed(2))
    runtime.reset_launches()
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        logits = model(x.to(dev))
        softmax_xent(logits, y.to(dev)).mean().backward()
        outs.append((logits.detach().cpu(), model.Conv_0.weight.grad.cpu()))
    torch.testing.assert_close(outs[1][0], outs[0][0], atol=1e-3, rtol=0)
    torch.testing.assert_close(outs[1][1], outs[0][1], atol=1e-3, rtol=0)
    cnn = ("groupnorm_fwd", "groupnorm_bwd", "xent_fwd", "xent_bwd")
    assert all(runtime.LAUNCHES[k] > 0 for k in cnn), runtime.LAUNCHES


def _qkv(shape, seed):
    g = torch.Generator().manual_seed(seed)
    q, k = (0.5 * torch.randn(shape, generator=g) for _ in range(2))
    v, do = (torch.randn(shape, generator=g) for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", [
    (2, 2, 35, 100), (2, 2, 96, 16), (1, 2, 130, 128), (3, 1, 1, 8), (1, 1, 64, 33),
])
def test_flash_attention_kernels_match_plain(cuda, shape, causal):
    """Each K3 kernel against its plain version on the same inputs, and the
    autograd route against plain softmax attention."""
    b, h, t, d = shape
    q, k, v, do = (x.to(cuda) for x in _qkv(shape, 7))
    flat = [x.reshape(b * h, t, d) for x in (q, k, v, do)]
    o, lse = attn_fwd(*flat[:3], causal)
    o_ref, lse_ref = attn_fwd_ref(*flat[:3], causal)
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=0)
    delta = (flat[3] * o).sum(-1)
    dk, dv = attn_bwd_dkv(*flat, lse, delta, causal)
    dq = attn_bwd_dq(*flat, lse, delta, causal)
    for got, want in zip((dq, dk, dv), attn_bwd_ref(*flat, lse, delta, causal)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=0)

    runtime.reset_launches()
    qr, kr, vr = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention(qr, kr, vr, causal=causal)
    grads = torch.autograd.grad(out, (qr, kr, vr), do)
    assert [runtime.LAUNCHES[n] for n in ("attn_fwd", "attn_bwd_dkv", "attn_bwd_dq")] == [1, 1, 1]
    qp, kp, vp = (x.clone().requires_grad_() for x in (q, k, v))
    ref = attention_ref(qp, kp, vp, causal=causal)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for got, want in zip(grads, torch.autograd.grad(ref, (qp, kp, vp), do)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_flash_attention_gradients_are_the_same_on_every_run(cuda):
    q, k, v, do = (x.to(cuda).reshape(4, 200, 64) for x in _qkv((2, 2, 200, 64), 8))
    o, lse = attn_fwd(q, k, v, True)
    delta = (do * o).sum(-1)
    first = attn_bwd_dkv(q, k, v, do, lse, delta, True) + (attn_bwd_dq(q, k, v, do, lse, delta, True),)
    again = attn_bwd_dkv(q, k, v, do, lse, delta, True) + (attn_bwd_dq(q, k, v, do, lse, delta, True),)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_flash_attention_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(2, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn_fwd(q, q, q, True)
    q = torch.zeros(2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="contiguous f32"):
        attn_fwd(q, q.double(), q, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_fwd(q.cpu(), q.cpu(), q.cpu(), True)
