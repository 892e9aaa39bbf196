"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Without a card every test skips: a CUDA kernel has no CPU mode.

Tolerances: f32 GroupNorm forward atol 1e-4 and gradients 5e-4 (f32
statistics, other reduction order); the parameter gradients are sums over
B*S terms, held relative to their size (rtol 1e-4); bf16 input and output
round to 8 significant bits (atol 3e-2 plus rtol 1e-2); cross-entropy loss
and lse atol 1e-5 (the JAX package's), and each gradient entry within rtol
1e-5 of the plain version's in f32, 2**-8 + 1e-5 for bf16 (one rounding to
its 8 significant bits), the gold column, where p - 1 cancels, also within
2**-21 * g: a typical entry at V = 18,328 is about g * 1e-6, so a limit set
by each entry's own size is the one that sees a fault there; flash
attention forward atol 2e-5 and gradients 5e-4 (the JAX package's own
tolerances for its kernel, ``tests/test_pallas.py``).
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
    SMALL_V,
    SoftmaxXentFunction,
    softmax_xent,
    softmax_xent_ref,
    xent_bwd,
    xent_bwd_ref,
    xent_fwd,
    xent_fwd_ref,
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


def _xent_inputs(r, v, dtype, seed=6):
    g = torch.Generator().manual_seed(seed)
    logits = (3 * torch.randn(r, v, generator=g)).to(dtype)
    labels = torch.randint(0, v, (r,), generator=g)
    labels[0], labels[-1] = 0, v - 1
    return logits, labels, torch.rand(r, generator=g)


def _assert_dlogits_close(dx, want, labels, w, rtol, gold_atol=2.0**-21):
    """Each entry of dx within ``rtol`` of ``want``'s, and on the gold
    column also within ``gold_atol * w`` of it."""
    gold = torch.arange(want.shape[-1], device=want.device) == labels[:, None]
    lim = rtol * want.abs() + gold * (gold_atol * w[:, None])
    err = (dx.float() - want).abs()
    worst = (err / lim.clamp_min(1e-38)).max().item()
    assert (err <= lim).all(), f"dlogits off by {worst:.3g} of the limit (max |err| {err.max().item():.3g})"


def _check_xent(logits, labels, w):
    """The kernel pair against its plain versions on the same inputs (the
    backward's with the kernel's own lse), and the lse against logsumexp."""
    loss, lse = xent_fwd(logits, labels)
    loss_ref, lse_ref = xent_fwd_ref(logits, labels)
    torch.testing.assert_close(loss, loss_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, torch.logsumexp(logits.float(), -1), atol=1e-5, rtol=0)
    dx = xent_bwd(logits, labels, w, lse)
    assert dx.dtype == logits.dtype and dx.shape == logits.shape
    want = xent_bwd_ref(logits.float(), labels, w, lse)  # f32, rounded nowhere
    rtol = 1e-5 if logits.dtype == torch.float32 else 2.0**-8 + 1e-5
    _assert_dlogits_close(dx, want, labels, w, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [1, 13, 105, 1400])
@pytest.mark.parametrize("v", [10, 100, 1000, 4097, 4099, 18328, 33278])
def test_xent_kernels_match_plain(cuda, v, r, dtype):
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(r, v, dtype))
    _check_xent(logits, labels, w)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("r", [9, 300])
@pytest.mark.parametrize("v", [SMALL_V - 1, SMALL_V, SMALL_V + 3])
def test_xent_kernels_match_plain_on_both_sides_of_the_plan_threshold(cuda, v, r, dtype):
    """The warp-per-row kernel just below SMALL_V classes, the block-per-row
    kernel from it up (aligned rows, then rows off 16 bytes)."""
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(r, v, dtype, seed=7))
    _check_xent(logits, labels, w)


@pytest.mark.cuda
@pytest.mark.parametrize("v", [10, 4099, 18328])
def test_xent_labels_out_of_range_give_gold_zero(cuda, v):
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(6, v, torch.float32))
    labels[1], labels[2], labels[3] = -1, v, 2**40
    _check_xent(logits, labels, w)
    loss, lse = xent_fwd(logits, labels)
    torch.testing.assert_close(loss[1:4], lse[1:4], atol=0, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("v", [10, 4099, 33278])
def test_xent_row_slice_with_a_misaligned_base(cuda, v, dtype):
    """``logits[1:]`` starts one row (V * 4 or V * 2 bytes, no multiple of
    16 for these V) into an aligned buffer, while the gradient the kernel
    allocates starts on a 16-byte boundary."""
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(14, v, dtype))
    sliced = logits[1:]
    assert sliced.is_contiguous() and sliced.data_ptr() % 16 != 0
    _check_xent(sliced, labels[1:], w[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("r,v", [(105, 18328), (1400, 33278), (128, 10)])
def test_xent_kernels_give_the_same_bits_on_every_run(cuda, r, v):
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(r, v, torch.float32))
    first = xent_fwd(logits, labels)
    again = xent_fwd(logits, labels)
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    assert torch.equal(xent_bwd(logits, labels, w, first[1]), xent_bwd(logits, labels, w, again[1]))


@pytest.mark.cuda
@pytest.mark.parametrize("v", [10, 18328])
def test_xent_autograd_route_saves_the_forward_lse(cuda, v):
    """One forward and one backward launch per loss; the backward consumes
    the lse the forward saved, and the gradient is the plain loss's."""
    logits, labels, w = (t.to(cuda) for t in _xent_inputs(40, v, torch.float32))
    runtime.reset_launches()
    lr = logits.clone().requires_grad_()
    loss = SoftmaxXentFunction.apply(lr, labels)
    saved = loss.grad_fn.saved_tensors
    assert len(saved) == 3 and saved[2].shape == (40,) and saved[2].dtype == torch.float32
    torch.testing.assert_close(saved[2], torch.logsumexp(logits, -1), atol=1e-5, rtol=0)
    (got,) = torch.autograd.grad(loss, lr, w)
    assert (runtime.LAUNCHES["xent_fwd"], runtime.LAUNCHES["xent_bwd"]) == (1, 1)
    _assert_dlogits_close(got, xent_bwd_ref(logits, labels, w, saved[2]), labels, w, 1e-5)
    # the plain loss's autograd has its own lse, a few f32 steps from this one
    lp = logits.clone().requires_grad_()
    (want,) = torch.autograd.grad(softmax_xent_ref(lp, labels), lp, w)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=0)
    _assert_dlogits_close(got, want, labels, w, 1e-4, gold_atol=1e-5)
    # the route the engines call, on [B, T, V] logits
    runtime.reset_launches()
    l3 = logits.view(4, 10, v).clone().requires_grad_()
    out = softmax_xent(l3, labels.view(4, 10))
    (g3,) = torch.autograd.grad(out, l3, w.view(4, 10))
    assert out.shape == (4, 10)
    assert (runtime.LAUNCHES["xent_fwd"], runtime.LAUNCHES["xent_bwd"]) == (1, 1)
    torch.testing.assert_close(g3.view(40, v), got, atol=0, rtol=0)


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
