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
    SHORT_T,
    attention_ref,
    attn_bwd_dkv,
    attn_bwd_dq,
    attn_bwd_ref,
    attn_bwd_short,
    attn_bwd_short_ref,
    attn_fwd,
    attn_fwd_ref,
    attn_fwd_short,
    flash_attention,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
    general_plan,
    group_norm,
    group_norm_bwd,
    group_norm_bwd_ref,
    group_norm_fwd,
    group_norm_ref,
    group_norm_stats_ref,
    plan,
    tiled_plan,
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


# K1's routes, forced through ``launch``: (shape, groups, route, the tile,
# cluster or block size forced in place of ``plan``'s, whether the tiled
# launch splits S over a cluster). The shapes
# hold cg = 2, 3, 4, 5, 16, 31 and 32 channels a group, S = 1, 16, 32, 64
# and 1,024, and S = 999 and 1,000, which the cluster's ranks split
# unevenly or evenly; blocks of 32 to 512 threads, and tile rows of 8 to
# 128 vectors (a row spanning up to four warps).
GN_ROUTES = [
    ((2, 1024, 64), 32, "tiled", {}, True),
    ((2, 1000, 96), 32, "tiled", {}, True),
    ((2, 999, 160), 32, "tiled", {}, True),
    ((3, 16, 128), 32, "tiled", {"cluster": 8}, True),
    ((3, 16, 128), 32, "tiled", {}, False),
    ((2, 1, 1024), 32, "tiled", {}, False),
    ((4, 64, 992), 32, "tiled", {}, False),
    ((2, 32, 512), 32, "tiled", {"tile": 512, "cluster": 1}, False),
    ((300, 16, 1024), 32, "tiled", {}, False),
    ((16, 64, 512), 32, "tiled", {"threads": 512}, False),
    ((2, 1024, 64), 32, "general", {}, False),
    ((3, 16, 128), 32, "general", {}, False),
    ((2, 1, 1024), 32, "general", {}, False),
]


def _gn_launch(shape, groups, dtype, backward, route, force):
    b, s, c = shape
    if route == "general":
        return general_plan(s, c // groups, backward)
    p = plan(b, s, c, groups, dtype, backward)
    f = {"tile": p.tile, "cluster": p.cluster, "threads": p.threads, **force}
    return tiled_plan(s, f["tile"], c // groups, f["cluster"], f["threads"], dtype, backward)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 0.0),
    (torch.bfloat16, 3e-2, 1e-2),
])
@pytest.mark.parametrize("relu", [False, True])
@pytest.mark.parametrize("shape,groups,route,force,clustered", GN_ROUTES)
def test_groupnorm_every_route_matches_plain(cuda, shape, groups, route, force, clustered,
                                             relu, dtype, atol, rtol):
    """K1 on each route (tiled without and with a cluster, general), forced
    through ``launch``, against the plain version at the tolerances of
    ``test_groupnorm_kernels_match_plain``: y and the gradients against
    autograd through ``group_norm_ref``, the saved statistics against
    ``group_norm_stats_ref``, and the backward against
    ``group_norm_bwd_ref`` from the kernel's own statistics."""
    fwd, bwd = (_gn_launch(shape, groups, dtype, back, route, force) for back in (False, True))
    assert fwd.route == bwd.route == route
    if route == "tiled":
        assert (fwd.cluster > 1) == clustered, fwd
    x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 5))
    x, dy = x.to(dtype), dy.to(dtype)
    runtime.reset_launches()
    y, mean, rstd = group_norm_fwd(x, w, b, groups, 1e-6, relu, launch=fwd)
    dx, dw, db = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu, launch=bwd)
    general = int(route == "general")
    assert [runtime.LAUNCHES[k] for k in ("groupnorm_fwd", "groupnorm_bwd", "groupnorm_fwd_general",
                                          "groupnorm_bwd_general")] == [1, 1, general, general]
    xr, wr, br = (t.detach().clone().float().requires_grad_() for t in (x, w, b))
    yr = group_norm_ref(xr, wr, br, groups, 1e-6, relu)
    gx, gw, gb = torch.autograd.grad(yr, (xr, wr, br), dy.float())
    assert y.dtype == dx.dtype == dtype
    torch.testing.assert_close(y.float(), yr.detach(), atol=atol, rtol=rtol)
    gatol = 5e-4 if dtype == torch.float32 else atol
    torch.testing.assert_close(dx.float(), gx, atol=gatol, rtol=rtol)
    torch.testing.assert_close(dw, gw, atol=gatol, rtol=max(rtol, 1e-4))
    torch.testing.assert_close(db, gb, atol=gatol, rtol=max(rtol, 1e-4))
    for got, want in zip((mean, rstd), group_norm_stats_ref(x, groups, 1e-6)):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    px, pw, pb = group_norm_bwd_ref(x.float(), dy.float(), w, b, mean, rstd, groups, relu)
    torch.testing.assert_close(dx.float(), px, atol=gatol, rtol=rtol)
    torch.testing.assert_close(dw, pw, atol=gatol, rtol=max(rtol, 1e-4))
    torch.testing.assert_close(db, pb, atol=gatol, rtol=max(rtol, 1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(4, 1024, 64), (8, 64, 992), (32, 16, 1024), (300, 16, 1024)])
def test_groupnorm_backward_gives_the_same_bits_on_every_run(cuda, shape, dtype):
    """No float atomics: dx, dscale and dbias repeat bit for bit (the first
    shape runs as a cluster, the others without)."""
    x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 6))
    x, dy = x.to(dtype), dy.to(dtype)
    _, mean, rstd = group_norm_fwd(x, w, b, 32, 1e-6, True)
    first, again = (group_norm_bwd(x, dy, w, b, mean, rstd, 32, True) for _ in range(2))
    assert all(torch.equal(u, v) for u, v in zip(first, again))


@pytest.mark.cuda
def test_groupnorm_misaligned_operands_take_the_general_route(cuda):
    """A contiguous view whose base is off 16 bytes runs on the general route
    (the tiled one copies 16-byte vectors); a forced tiled plan refuses it."""
    shape = (2, 64, 128)
    x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 7))
    n = x.numel()
    xs = torch.empty(n + 1, device=cuda)[1:].view(shape).copy_(x)
    assert xs.is_contiguous() and xs.data_ptr() % 16
    runtime.reset_launches()
    y, mean, rstd = group_norm_fwd(xs, w, b, 32, 1e-6, True)
    assert runtime.LAUNCHES["groupnorm_fwd_general"] == 1
    torch.testing.assert_close(y, group_norm_ref(x, w, b, 32, 1e-6, True), atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="aligned"):
        group_norm_fwd(xs, w, b, 32, 1e-6, True, launch=plan(*shape, 32))


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 256, 128), (3, 10, 18)])
def test_groupnorm_autograd_route_takes_the_planned_route(cuda, shape):
    """``group_norm`` on a CUDA tensor launches the route ``plan`` picks:
    tiled for C % 4 == 0, general otherwise; gradients match the plain
    version."""
    groups = 32 if shape[2] % 32 == 0 else 6
    x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 8))
    runtime.reset_launches()
    xr, wr, br = (t.clone().requires_grad_() for t in (x, w, b))
    out = group_norm(xr, wr, br, groups, relu=True)
    grads = torch.autograd.grad(out, (xr, wr, br), dy)
    general = int(plan(*shape, groups).route == "general")
    assert general == int(shape[2] % 4 != 0)
    assert [runtime.LAUNCHES[k] for k in ("groupnorm_fwd", "groupnorm_bwd", "groupnorm_fwd_general",
                                          "groupnorm_bwd_general")] == [1, 1, general, general]
    xp, wp, bp = (t.clone().requires_grad_() for t in (x, w, b))
    ref = group_norm_ref(xp, wp, bp, groups, 1e-6, True)
    torch.testing.assert_close(out, ref, atol=1e-4, rtol=0)
    for got, want in zip(grads, torch.autograd.grad(ref, (xp, wp, bp), dy)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=1e-4)


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
    # T <= 64 takes the short kernels, T > 64 the tiled ones
    short = int(t <= SHORT_T)
    names = ("attn_fwd", "attn_bwd", "attn_fwd_tiled", "attn_bwd_dkv", "attn_bwd_dq")
    assert [runtime.LAUNCHES[n] for n in names] == [short, short] + [1 - short] * 3
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


def _views(shape, seed, layout, dev):
    """q, k, v, dO as [B, H, T, D] on the card: "contiguous"; "model", views
    of [B, T, H*D] buffers, as the model's projections give them (and dO as
    autograd hands it back); "offset", the same views one float into their
    buffers, so no row is 16-byte aligned."""
    b, h, t, d = shape
    out = []
    for x in _qkv(shape, seed):
        if layout == "contiguous":
            out.append(x.to(dev))
            continue
        pad = int(layout == "offset")
        buf = torch.zeros(b, t, h * d + pad, device=dev)
        buf[..., pad:] = x.transpose(1, 2).reshape(b, t, h * d).to(dev)
        out.append(buf[..., pad:].unflatten(-1, (h, d)).transpose(1, 2))
    return out


LM_SHAPES = [(3, 2, 35, 100), (20, 2, 35, 100), (26, 2, 35, 100), (40, 2, 35, 100)]


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["model", "contiguous", "offset"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", LM_SHAPES + [
    (2, 2, 35, 128), (2, 2, 35, 33), (3, 1, 1, 8), (2, 2, 17, 100), (1, 2, 64, 100),
    (1, 2, 64, 128), (2, 3, 13, 13), (600, 1, 35, 100),
])
def test_flash_attention_short_kernels_match_plain(cuda, shape, causal, layout):
    """The short forward and the fused backward against their plain versions
    on the same strided inputs (the backward from the kernel's own o and
    lse), the output in the [B, T, H, D] layout and each gradient in its
    operand's layout."""
    b, h, t, d = shape
    q, k, v, do = _views(shape, 9, layout, cuda)
    o, lse = attn_fwd_short(q, k, v, causal)
    o_ref, lse_ref = attn_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=0)
    assert o.stride() == (t * h * d, d, h * d, 1)
    grads = attn_bwd_short(q, k, v, do, o, lse, causal)
    for got, want, x in zip(grads, attn_bwd_short_ref(q, k, v, do, o, lse, causal), (q, k, v)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=0)
        if layout != "offset":  # a dense operand's gradient takes its strides
            assert got.stride() == x.stride()


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rows", [4, 8, 12, 16, 36])
@pytest.mark.parametrize("threads", [32, 64, 128, 256, 288, 384])
def test_flash_attention_short_kernels_match_plain_under_every_plan(cuda, threads, rows, causal):
    q, k, v, do = _views((5, 2, 35, 100), 10, "model", cuda)
    o, lse = attn_fwd_short(q, k, v, causal, launch=(rows, threads))
    o_ref, lse_ref = attn_fwd_ref(q, k, v, causal)
    torch.testing.assert_close(o, o_ref, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, lse_ref, atol=2e-5, rtol=0)
    want = attn_bwd_short_ref(q, k, v, do, o, lse, causal)
    for parts in (1, 2):
        got = attn_bwd_short(q, k, v, do, o, lse, causal, launch=(threads, parts))
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, atol=5e-4, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", [1, 2])
def test_flash_attention_short_backward_gives_the_same_bits_on_every_run(cuda, parts):
    q, k, v, do = _views((26, 2, 35, 100), 11, "model", cuda)
    o, lse = attn_fwd_short(q, k, v, True)
    first = attn_bwd_short(q, k, v, do, o, lse, True, launch=(256, parts))
    again = attn_bwd_short(q, k, v, do, o, lse, True, launch=(256, parts))
    assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.cuda
def test_flash_attention_short_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 2, 8, 129, device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        attn_fwd_short(q, q, q, True)
    q = torch.zeros(1, 2, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="f32"):
        attn_fwd_short(q, q.double(), q, True)
    strided = torch.zeros(1, 2, 16, 8, device=cuda).transpose(2, 3)  # q's shape, stride(-1) 8
    with pytest.raises(ValueError, match="last dimension"):
        attn_fwd_short(q, strided, q, True)
    with pytest.raises(ValueError, match="CUDA tensors"):
        attn_fwd_short(q.cpu(), q.cpu(), q.cpu(), True)
    with pytest.raises(ValueError, match="T = 65"):
        attn_fwd_short(*(torch.zeros(1, 2, 65, 16, device=cuda),) * 3, True)
    o, lse = attn_fwd_short(q, q, q, True)
    with pytest.raises(ValueError, match="lse"):
        attn_bwd_short(q, q, q, q, o, lse.double(), True)
    with pytest.raises(ValueError, match="last dimension"):
        attn_bwd_short(q, q, q, strided, o, lse, True)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [35, 64, 65, 96])
def test_flash_attention_routes_by_sequence_length(cuda, t):
    """Through autograd on the model's views: the short kernels once each at
    T <= 64 (no tiled launch), the tiled kernels once each above it."""
    q, k, v, do = _views((2, 2, t, 100), 12, "model", cuda)
    qr, kr, vr = (x.detach().requires_grad_() for x in (q, k, v))
    runtime.reset_launches()
    out = flash_attention(qr, kr, vr, causal=True)
    grads = torch.autograd.grad(out, (qr, kr, vr), do)
    short = int(t <= SHORT_T)
    names = ("attn_fwd", "attn_bwd", "attn_fwd_tiled", "attn_bwd_dkv", "attn_bwd_dq")
    assert [runtime.LAUNCHES[n] for n in names] == [short, short] + [1 - short] * 3
    qp, kp, vp = (x.detach().clone().requires_grad_() for x in (q, k, v))
    ref = attention_ref(qp, kp, vp, causal=True)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)
    for got, want in zip(grads, torch.autograd.grad(ref, (qp, kp, vp), do)):
        torch.testing.assert_close(got, want, atol=5e-4, rtol=0)
