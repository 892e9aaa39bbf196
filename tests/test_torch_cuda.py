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

from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import GroupNorm, init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad, synthetic_load
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
    tiled_occupancy,
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
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import elastic_step, packed_step


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
    # the tiled route at D = 100 (the language model's) with a T that is
    # not a multiple of 64 and at its --bptt 256 windows, the long-context
    # 2,048, and a D not a multiple of 8
    (2, 2, 159, 100), (6, 2, 256, 100), (1, 2, 2048, 128), (1, 1, 130, 33),
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
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shape", [(26, 2, 256, 100), (1, 2, 2048, 128), (2, 1, 130, 33)])
def test_flash_attention_tiled_gradients_are_the_same_on_every_run(cuda, shape, causal):
    """The tiled route's forward and backward twice from the same inputs:
    the same bits (each output element owned by one block, no float
    atomics)."""
    b, h, t, d = shape
    q, k, v, do = (x.to(cuda).reshape(b * h, t, d) for x in _qkv(shape, 9))
    (o, lse), again = attn_fwd(q, k, v, causal), attn_fwd(q, k, v, causal)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])
    delta = (do * o).sum(-1)
    first = attn_bwd_dkv(q, k, v, do, lse, delta, causal) + (attn_bwd_dq(q, k, v, do, lse, delta, causal),)
    again = attn_bwd_dkv(q, k, v, do, lse, delta, causal) + (attn_bwd_dq(q, k, v, do, lse, delta, causal),)
    assert all(torch.equal(a, b_) for a, b_ in zip(first, again))
    torch.testing.assert_close(o, attn_fwd_ref(q, k, v, causal)[0], atol=2e-5, rtol=0)


@pytest.mark.cuda
def test_tiled_attention_blocks_fit_an_sm_side_by_side_at_every_head_dim(cuda):
    """At every D in [1, 128] each tiled kernel, as the kernels lay out their
    shared memory, fits at least 2 blocks an SM (the occupancy calculator's
    count), and stages D padded with zeros to a multiple of 8 columns; 3
    forward blocks share an SM up to the language model's D = 100."""
    for d in range(1, 129):
        occ = tiled_occupancy(d)
        for kernel, (blocks, _, _, cols) in occ.items():
            assert blocks >= 2 and cols >= d and cols % 8 == 0, (d, kernel, occ[kernel])
        if d <= 100:
            assert occ["fwd"][0] >= 3, (d, occ["fwd"])


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


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 3, 255, 256, 700])
def test_synthetic_load_graph_replays_equal_the_plain_chain(cuda, n):
    """The compute-mode straggler's load: ``SyntheticLoad`` on the card runs
    the whole chain in one launch of the cooperative kernel
    (``csrc/faultload.cu``), the same f32 products as the plain chain
    (atol 1e-6, rtol 1e-5: the sums in another order), the same bits on a
    rerun."""
    load = SyntheticLoad()
    seed = torch.tensor(2.5, device=cuda)
    runtime.reset_launches()
    got = load(n, seed)
    assert runtime.LAUNCHES["synthetic_load"] == 1
    torch.testing.assert_close(got, synthetic_load(n, seed), atol=1e-6, rtol=1e-5)
    assert torch.equal(got, load(n, seed))
    assert load.calibrate_iter_cost(cuda) > 0


@pytest.mark.cuda
def test_packed_step_on_the_card_equals_elastic_steps(cuda):
    """K1 and K2 under one backward over the workers' concatenated batches
    against per-worker backwards summed: parameters after 3 steps within
    atol 1e-4 (the kernels' f32 sums in another order, and TF32 off)."""
    torch.backends.cudnn.allow_tf32 = False
    models = []
    for _ in range(2):
        m = DenseNet((2, 2), growth_rate=8, image_size=16)
        init_flax_defaults(m, torch.Generator().manual_seed(0))
        models.append(m.to(cuda, memory_format=torch.channels_last))
    opts = [make_optimizer(list(m.parameters()), 0.05, 0.9) for m in models]
    g = torch.Generator().manual_seed(4)
    sizes = (5, 11, 16, 8)
    for _ in range(3):
        batches = [(torch.randn(b, 16, 16, 3, generator=g).to(cuda),
                    torch.randint(0, 10, (b,), generator=g).to(cuda),
                    torch.full((b,), 1.0 / sum(sizes), device=cuda)) for b in sizes]
        runtime.reset_launches()
        elastic_step(models[0], opts[0], batches)
        packed_step(models[1], opts[1], tuple(torch.cat(p) for p in zip(*batches)))
        n_gn = sum(isinstance(m, GroupNorm) for m in models[0].modules())
        assert runtime.LAUNCHES["groupnorm_fwd"] == 5 * n_gn  # 4 worker forwards + 1 packed
        assert runtime.LAUNCHES["xent_fwd"] == 5
    for a, b in zip(models[0].parameters(), models[1].parameters()):
        torch.testing.assert_close(b, a, atol=1e-4, rtol=0)


def _zoo_gn_calls(name):
    """The distinct ``(S, C, groups, relu)`` of ``-m name``'s GroupNorm calls
    on a 32x32 input, read off the model (CPU) with forward hooks."""
    model = build_model(name).to(memory_format=torch.channels_last)
    calls = set()

    def hook(m, inp, out):
        _, c, h, w = inp[0].shape
        calls.add((h * w, c, m.num_groups, m.relu))

    for m in model.modules():
        if isinstance(m, GroupNorm):
            m.register_forward_hook(hook)
    with torch.no_grad():
        model(torch.zeros(1, 32, 32, 3))
    return sorted(calls)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol,rtol", [
    (torch.float32, 1e-4, 0.0),
    (torch.bfloat16, 2e-2, 1e-2),
])
@pytest.mark.parametrize("name", ["densenet", "resnet", "googlenet", "regnet"])
def test_groupnorm_at_every_zoo_shape(cuda, name, dtype, atol, rtol):
    """K1 at every distinct GroupNorm call of DenseNet-121, ResNet-101,
    GoogLeNet and RegNetY-400MF (batch 3), on the route and cluster ``plan``
    picks: y against ``group_norm_ref`` (atol/rtol as
    ``test_groupnorm_kernels_match_plain``, bf16 2e-2: its inputs and outputs
    rounded to 8 significant bits), the saved statistics against
    ``group_norm_stats_ref`` (1e-5), the backward twice, bit for bit, against
    ``group_norm_bwd_ref`` from the kernel's own statistics (dx 5e-4 in f32;
    dscale/dbias also rtol 1e-4, sums over B*S terms)."""
    gatol = 5e-4 if dtype == torch.float32 else atol
    for n, (s, c, groups, relu) in enumerate(_zoo_gn_calls(name)):
        shape = (3, s, c)
        fwd, bwd = (plan(3, s, c, groups, dtype, back) for back in (False, True))
        assert fwd.route == bwd.route == "tiled", (shape, groups)
        x, w, b, dy = (t.to(cuda) for t in _gn_inputs(shape, 100 + n))
        x, dy = x.to(dtype), dy.to(dtype)
        y, mean, rstd = group_norm_fwd(x, w, b, groups, 1e-6, relu, launch=fwd)
        got = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu, launch=bwd)
        again = group_norm_bwd(x, dy, w, b, mean, rstd, groups, relu, launch=bwd)
        assert all(torch.equal(u, v) for u, v in zip(got, again)), (shape, groups)
        torch.testing.assert_close(y.float(), group_norm_ref(x.float(), w, b, groups, 1e-6, relu),
                                   atol=atol, rtol=rtol)
        for have, want in zip((mean, rstd), group_norm_stats_ref(x, groups, 1e-6)):
            torch.testing.assert_close(have, want, atol=1e-5, rtol=1e-5)
        dx, dw, db = got
        px, pw, pb = group_norm_bwd_ref(x.float(), dy.float(), w, b, mean, rstd, groups, relu)
        torch.testing.assert_close(dx.float(), px, atol=gatol, rtol=rtol)
        torch.testing.assert_close(dw, pw, atol=gatol, rtol=max(rtol, 1e-4))
        torch.testing.assert_close(db, pb, atol=gatol, rtol=max(rtol, 1e-4))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["resnet18", "resnet", "googlenet", "regnetx200mf", "regnety400mf"])
def test_new_families_on_the_card_match_the_cpu(cuda, name):
    """ResNet-18, ResNet-101, GoogLeNet and both RegNets through K1 and K2 on
    the card against the plain versions on the CPU, same weights, 4 inputs:
    logits within atol 2e-3 of the CPU's f32 run (tens of layers of
    differently ordered f32 sums; TF32 off), and the first conv's loss
    gradient within atol 5e-3 of the CPU's f64 run. The f64 run is the
    reference because ResNet-101's and RegNetY-400MF's gradients are
    ill-conditioned in f32: ``scripts/zoo_numerics.py`` (H100, weight seeds
    0-2, batches 4 and 8) puts their f32 runs up to 4.0e-3 from f64: the
    CPU's plain versions up to 4.02e-3, the card with the kernels up to
    3.75e-3 (this test's case) and with the plain versions up to 3.77e-3;
    the other three models' f32 runs lie within 8e-4."""
    torch.backends.cudnn.allow_tf32 = False
    cpu = build_model(name).to(memory_format=torch.channels_last).eval()
    init_flax_defaults(cpu, torch.Generator().manual_seed(0))
    x = torch.randn(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    y = torch.randint(0, 10, (4,), generator=torch.Generator().manual_seed(2))
    out = []
    for d, dtype in ((cuda, torch.float32), ("cpu", torch.float32), ("cpu", torch.float64)):
        model = build_model(name)
        model.load_state_dict(cpu.state_dict())
        model = model.to(d, dtype, memory_format=torch.channels_last).eval()
        runtime.reset_launches()
        logits = model(x.to(d, dtype))
        softmax_xent(logits, y.to(d)).mean().backward()
        if d == cuda:
            assert runtime.LAUNCHES["groupnorm_fwd"] > 0 and runtime.LAUNCHES["groupnorm_bwd"] > 0
            assert runtime.LAUNCHES["groupnorm_fwd_general"] == 0
            assert runtime.LAUNCHES["xent_fwd"] == runtime.LAUNCHES["xent_bwd"] == 1
        out.append((logits.detach().cpu(), model.Conv_0.weight.grad.cpu()))
    (got, grad), (want, _), (_, exact) = out
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
    torch.testing.assert_close(grad.double(), exact, atol=5e-3, rtol=0)


@pytest.mark.cuda
def test_bf16_packed_step_on_the_card_is_as_close_to_f64_as_the_cpu(cuda):
    """``--precision bfloat16``'s packed step (bf16 compute over f32 master
    weights) on the card: K1 on bf16 activations only, K2 on f32 logits;
    the step's summed gradient (the momentum buffer) and the updated
    parameters against the CPU's f64 step from the same weights and batch,
    within 4 times the CPU's own bf16 step's distance from f64 (the two
    round to bf16 at the same points; the card's convolutions and K1 sum in
    another order). Parameters and buffers stay f32."""
    torch.backends.cudnn.allow_tf32 = False
    ref = DenseNet((2, 2), growth_rate=8, image_size=16)
    init_flax_defaults(ref, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(5)
    x, y = torch.randn(24, 16, 16, 3, generator=g), torch.randint(0, 10, (24,), generator=g)
    w = torch.full((24,), 1.0 / 24)
    out = {}
    for tag, d, dtype in (("card", cuda, torch.bfloat16), ("cpu", "cpu", torch.bfloat16),
                          ("f64", "cpu", None)):
        m = DenseNet((2, 2), growth_rate=8, image_size=16)
        m.load_state_dict(ref.state_dict())
        wide = torch.float64 if dtype is None else torch.float32
        m = m.to(d, wide, memory_format=torch.channels_last)
        opt = make_optimizer(list(m.parameters()), 0.05, 0.9)
        runtime.reset_launches()
        packed_step(m, opt, (x.to(d, wide), y.to(d), w.to(d, wide)), compute_dtype=dtype)
        if tag == "card":
            n_gn = sum(isinstance(mod, GroupNorm) for mod in m.modules())
            assert runtime.LAUNCHES["groupnorm_fwd_bf16"] == runtime.LAUNCHES["groupnorm_fwd"] == n_gn
            assert runtime.LAUNCHES["groupnorm_bwd_bf16"] == runtime.LAUNCHES["groupnorm_bwd"] == n_gn
            assert runtime.LAUNCHES["xent_fwd"] == 1 and runtime.LAUNCHES["xent_fwd_bf16"] == 0
            for p in m.parameters():
                assert p.dtype == opt.state[p]["momentum_buffer"].dtype == torch.float32
        out[tag] = {n: (p.detach().double().cpu(), opt.state[p]["momentum_buffer"].double().cpu())
                    for n, p in m.named_parameters()}
    for i in (0, 1):  # parameters, buffers
        err = {tag: max((out[tag][n][i] - out["f64"][n][i]).abs().max().item() for n in out["f64"])
               for tag in ("card", "cpu")}
        assert 0 < err["card"] <= 4 * err["cpu"], (i, err)


@pytest.mark.cuda
def test_groupnorm_bf16_at_every_densenet121_packed_shape(cuda):
    """K1 on bf16 activations (``--precision bfloat16``: f32 scale and bias)
    at every distinct GroupNorm call of DenseNet-121 at a packed step's
    b = 512, on the tiled route ``plan`` picks: y against ``group_norm_ref``
    (atol 2e-2, rtol 1e-2: inputs and outputs rounded to 8 significant
    bits), the saved statistics (1e-5), and the backward, twice bit for bit,
    against ``group_norm_bwd_ref`` from the kernel's own statistics (dx at
    the bf16 tolerance; dscale/dbias also rtol 1e-4)."""
    gen = torch.Generator(device=cuda).manual_seed(6)
    b = 512
    for s, c, groups, relu in _zoo_gn_calls("densenet"):
        fwd, bwd = (plan(b, s, c, groups, torch.bfloat16, back) for back in (False, True))
        assert fwd.route == bwd.route == "tiled", (s, c, groups)
        x = torch.randn((b, s, c), device=cuda, generator=gen).to(torch.bfloat16)
        dy = torch.randn((b, s, c), device=cuda, generator=gen).to(torch.bfloat16)
        w = 1 + 0.1 * torch.randn(c, device=cuda, generator=gen)
        bias = 0.1 * torch.randn(c, device=cuda, generator=gen)
        runtime.reset_launches()
        y, mean, rstd = group_norm_fwd(x, w, bias, groups, 1e-6, relu, launch=fwd)
        got = group_norm_bwd(x, dy, w, bias, mean, rstd, groups, relu, launch=bwd)
        again = group_norm_bwd(x, dy, w, bias, mean, rstd, groups, relu, launch=bwd)
        assert runtime.LAUNCHES["groupnorm_fwd_bf16"] == 1 and runtime.LAUNCHES["groupnorm_bwd_bf16"] == 2
        assert all(torch.equal(u, v) for u, v in zip(got, again)), (s, c)
        torch.testing.assert_close(y.float(), group_norm_ref(x.float(), w, bias, groups, 1e-6, relu),
                                   atol=2e-2, rtol=1e-2)
        for have, want in zip((mean, rstd), group_norm_stats_ref(x, groups, 1e-6)):
            torch.testing.assert_close(have, want, atol=1e-5, rtol=1e-5)
        px, pw, pb = group_norm_bwd_ref(x.float(), dy.float(), w, bias, mean, rstd, groups, relu)
        dx, dw, db = got
        torch.testing.assert_close(dx.float(), px, atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(dw, pw, atol=2e-2, rtol=1e-2)
        torch.testing.assert_close(db, pb, atol=2e-2, rtol=1e-2)
        del x, dy, y, got, again, px, pw, pb, dx, dw, db
        torch.cuda.empty_cache()


# ------------------------------------------------- step graphs (--superstep)


def _replayed(fn):
    """``fn()`` warmed once on a side stream, captured into a CUDA graph and
    replayed once: (graph, the outputs of the replay)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = fn()
    graph.replay()
    torch.cuda.synchronize()
    return graph, outs


@pytest.mark.cuda
def test_load_reads_its_count_on_the_card_inside_a_graph(cuda):
    """The synthetic load captured once with a device count replays at
    each count copied in: equal to the int form's bits and within the
    plain chain's tolerance (atol 1e-6, rtol 1e-5)."""
    load = SyntheticLoad()
    seed = torch.tensor(1.25, device=cuda)
    count = torch.zeros((), dtype=torch.int32, device=cuda)
    graph, out = _replayed(lambda: load(count, seed))
    for n in (0, 3, 300):
        count.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, load(n, seed)), n
        torch.testing.assert_close(out, synthetic_load(n, seed), atol=1e-6, rtol=1e-5)


@pytest.mark.cuda
def test_kernels_replayed_in_a_graph_equal_their_eager_launches(cuda):
    """K1 (tiled route, f32 and bf16), K2 and K3's short route, forward and
    backward through their autograd functions, captured and replayed: the
    same bits as the same calls launched eagerly."""
    g = torch.Generator(device=cuda).manual_seed(0)
    x32 = torch.randn(16, 256, 128, device=cuda, generator=g)
    cases = {
        "groupnorm f32": (x32, lambda x, w, b: group_norm(x, w, b, 32, 1e-6, True)),
        "groupnorm bf16": (x32.bfloat16(), lambda x, w, b: group_norm(x, w, b, 32, 1e-6, True)),
    }
    wgt = (1 + 0.1 * torch.randn(128, device=cuda, generator=g)).requires_grad_()
    bias = (0.1 * torch.randn(128, device=cuda, generator=g)).requires_grad_()
    for name, (x, fn) in cases.items():
        x = x.clone().requires_grad_()
        dy = torch.randn(x.shape, device=cuda, generator=g).to(x.dtype)

        def step():
            return torch.autograd.grad(fn(x, wgt, bias), (x, wgt, bias), dy)

        _, got = _replayed(step)
        for a, b in zip(got, step()):
            assert torch.equal(a, b), name
    logits = torch.randn(700, 18328, device=cuda, generator=g).requires_grad_()
    labels = torch.randint(0, 18328, (700,), device=cuda, generator=g)
    wts = torch.rand(700, device=cuda, generator=g)

    def xent():
        loss = softmax_xent(logits, labels)
        return (loss,) + torch.autograd.grad(torch.sum(loss * wts), logits)

    _, got = _replayed(xent)
    for a, b in zip(got, xent()):
        assert torch.equal(a, b), "xent"
    qkv = torch.randn(20, 35, 3, 200, device=cuda, generator=g).requires_grad_()
    do = torch.randn(20, 2, 35, 100, device=cuda, generator=g)

    def attn():
        q, k, v = (qkv[:, :, i].view(20, 35, 2, 100).transpose(1, 2) for i in range(3))
        o = flash_attention(q, k, v, causal=True)
        return (o,) + torch.autograd.grad(o, qkv, do)

    _, got = _replayed(attn)
    for a, b in zip(got, attn()):
        assert torch.equal(a, b), "attention"


@pytest.mark.cuda
@pytest.mark.parametrize("t", [159, 256])
def test_tiled_attention_replayed_in_a_graph_equals_its_eager_launch(cuda, t):
    """K3's tiled route (T > 64: the language model at --bptt 256) forward
    and backward through the autograd function on the model's strided
    views, captured and replayed: the same bits as the eager calls, within
    the plain versions' tolerances (forward 2e-5, gradients 5e-4)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    qkv = torch.randn(6, t, 3, 200, device=cuda, generator=g).mul_(0.5).requires_grad_()
    do = torch.randn(6, 2, t, 100, device=cuda, generator=g)

    def attn():
        q, k, v = (qkv[:, :, i].view(6, t, 2, 100).transpose(1, 2) for i in range(3))
        o = flash_attention(q, k, v, causal=True)
        return (o,) + torch.autograd.grad(o, qkv, do)

    runtime.reset_launches()
    _, got = _replayed(attn)
    assert runtime.LAUNCHES["attn_fwd_tiled"] > 0 and runtime.LAUNCHES["attn_fwd"] == 0
    for a, b in zip(got, attn()):
        assert torch.equal(a, b), "tiled attention"
    ref = qkv.detach().clone().requires_grad_()
    q, k, v = (ref[:, :, i].view(6, t, 2, 100).transpose(1, 2) for i in range(3))
    o = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got[0], o, atol=2e-5, rtol=0)
    torch.testing.assert_close(got[1], torch.autograd.grad(o, ref, do)[0], atol=5e-4, rtol=0)


@pytest.mark.cuda
def test_replayed_dropout_draws_the_eager_masks(cuda):
    """The trainer's dropout generator registered with a graph: three
    replays draw the masks three eager calls draw from the same state."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout

    gen = torch.Generator(device=cuda).manual_seed(7)
    drop = Dropout(0.2)
    drop.generator = gen
    x = torch.ones(20, 35, 200, device=cuda)
    state = gen.get_state()
    eager = [drop(x) for _ in range(3)]
    gen.set_state(state)
    graph = torch.cuda.CUDAGraph()
    graph.register_generator_state(gen)
    with torch.cuda.graph(graph):
        out = drop(x)
    for want in eager:
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, want)


def _card_trainer(case, superstep, out, device, **extra):
    """A small run of each path for ``test_graphed_training_equals_eager``:
    DenseNet-121 (4 workers, B 64, 256 examples, a 3:1 straggler), elastic
    (virtual or compute mode, its load's costs pinned), packed, bf16; the
    language model on the committed wikitext-2 files (4 workers, 16
    columns, 4,000 tokens, clip 0.25, dropout, flash attention). A timing
    model fixes the plans, so the two runs see the same widths. One window
    an epoch (the default ``superstep_window`` over 4-8 steps): the
    augmentation is seeded at each window start, and ``off`` runs the
    epoch in one stream chunk, so equal windows draw equal crops.
    ``extra``: more config fields."""
    import os

    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
    from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer

    def timing(plan):
        return np.array([3.0, 1.0, 1.0, 1.0]) * np.array([w.batch_size * w.steps for w in plan.workers])

    common = dict(world_size=4, epoch_size=2, seed=0, straggler="3,1,1,1", superstep=superstep,
                  debug=True, device=0, log_dir=str(out / "logs"),
                  stat_dir=str(out / superstep), **extra)
    if case == "lm":
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        cfg = Config(model="transformer", dataset="wikitext2", batch_size=16, n_train=4000,
                     bptt=35, grad_clip=0.25, use_flash_attention=True, bucket=4,
                     lm_data_dir=os.path.join(root, "rnn_data", "wikitext-2"), **common)
        return LMTrainer(cfg, timing_model=timing, device=device, log_to_file=False)
    kw = {"packed": dict(packed="auto"), "bf16": dict(precision="bfloat16", packed="off"),
          "compute": dict(fault_mode="compute", packed="off")}.get(case, dict(packed="off"))
    cfg = Config(model="densenet", dataset="cifar10", batch_size=64, n_train=256, **common, **kw)
    tr = Trainer(cfg, timing_model=timing, device=device, log_to_file=False)
    if case == "compute":
        tr.per_example_cost = np.full(4, 1e-4)
        tr._iter_cost_s = 1e-5
    return tr


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["elastic", "compute", "packed", "bf16", "lm"])
def test_graphed_training_equals_eager_on_the_card(cuda, tmp_path, case):
    """``--superstep auto`` (step graphs) against ``off`` (eager steps) over
    two epochs on the card, cuDNN deterministic: the same train losses,
    parameters and momentum buffers, bit for bit; the auto run replayed
    graphs and its launch counts include the replays."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for superstep in ("off", "auto"):
            tr = _card_trainer(case, superstep, tmp_path, cuda)
            runtime.reset_launches()
            tr.run()
            runs[superstep] = (tr, dict(runtime.LAUNCHES))
    finally:
        torch.backends.cudnn.deterministic = det
    (off, n_off), (auto, n_auto) = runs["off"], runs["auto"]
    assert off.recorder.data["train_loss"] == auto.recorder.data["train_loss"]
    for p, q in zip(off.model.parameters(), auto.model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(off.optimizer.state[p]["momentum_buffer"],
                           auto.optimizer.state[q]["momentum_buffer"])
    ran = auto.recorder.meta["supersteps"]
    assert sum(r["captures"] for r in ran) >= 1 and sum(r["replays"] for r in ran) >= 2
    key = "attn_fwd" if case == "lm" else "groupnorm_bwd"
    assert n_auto[key] >= n_off[key] > 0  # replays counted, warm-ups added


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["elastic", "packed", "lm"])
def test_keys_captured_ahead_equal_lazy_captures_and_eager_steps(cuda, tmp_path, case):
    """A key the warm service captured ahead from its dummy slots (zero
    inputs, label 0, weight 1 / (b * world_size); ``--warm_start``: epoch
    0's keys in the pre-wall drain), then replayed with the real batches,
    against the same key captured lazily at its first step (``--aot_warm
    false``) and the eager steps (``--superstep off``), two epochs, cuDNN
    deterministic: the same train losses, parameters and momentum buffers,
    bit for bit."""
    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        runs = {}
        for name, superstep, extra in (("eager", "off", {}),
                                       ("lazy", "auto", dict(aot_warm=False)),
                                       ("ahead", "auto", dict(warm_start=True))):
            tr = _card_trainer(case, superstep, tmp_path / name, cuda, **extra)
            tr.run()
            runs[name] = tr
    finally:
        torch.backends.cudnn.deterministic = det
    ahead, lazy = runs["ahead"], runs["lazy"]
    drained = [a for a in ahead.recorder.meta["aot"] if a["epoch"] == 0 and a["at"] == "drain"]
    assert drained and drained[0]["captures"] >= 1
    assert ahead.recorder.meta["supersteps"][0]["foreground_captures"] == 0
    assert lazy.recorder.meta["supersteps"][0]["foreground_captures"] >= 1
    for other in ("lazy", "eager"):
        tr = runs[other]
        assert tr.recorder.data["train_loss"] == ahead.recorder.data["train_loss"], other
        for p, q in zip(tr.model.parameters(), ahead.model.parameters()):
            assert torch.equal(p, q), other
            assert torch.equal(tr.optimizer.state[p]["momentum_buffer"],
                               ahead.optimizer.state[q]["momentum_buffer"]), other


@pytest.mark.cuda
def test_staged_windows_survive_slot_reuse_on_the_card(cuda):
    """The host-fed path's staging on the card (``train/pipeline.py``):
    windows packed by ``take_rows`` into the two pinned slots, copied on the
    copy stream while the default stream is kept busy, each consumed after
    the next two windows reused its slot: every window's device rows equal
    its host rows, the slots are pinned, and the copies ran on the copy
    stream (the consumer waits on each window's event)."""
    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.runtime.native import take_rows
    from dynamic_load_balance_distributeddnn_tpu_torch.train.pipeline import (
        WindowStager,
        WindowTransferPipeline,
    )

    rng = np.random.RandomState(0)
    data = rng.randint(0, 255, size=(4096, 32, 32, 3)).astype(np.uint8)
    ranges = [(s, s + 1) for s in range(8)]
    sels = [rng.randint(0, 4096, size=512 + 64 * i) for i in range(8)]
    st = WindowStager(cuda)
    pinned = []

    def gather(s0, s1):
        x = st.host(s0, "x", (len(sels[s0]), 32, 32, 3), torch.uint8)
        pinned.append(x.is_pinned())
        take_rows(data, sels[s0], out=x.numpy())
        return (x,)

    busy = torch.randn(4096, 4096, device=cuda)
    got = []
    with WindowTransferPipeline(ranges, gather, lambda d, i, t: st.stage(i, t), [0]) as pipe:
        for i in range(len(ranges)):
            for _ in range(4):
                busy = busy @ busy / 64.0  # the consumer's stream stays behind
            x = pipe.get(i)[1][0].tensors[0]
            got.append((x.sum(dtype=torch.int64), x))  # read on the default stream
    torch.cuda.synchronize()
    assert all(pinned) and st._stream is not None
    for (total, x), sel in zip(got, sels):
        want = data[sel]
        assert np.array_equal(x.cpu().numpy(), want)
        assert int(total) == int(want.astype(np.int64).sum())


@pytest.mark.cuda
@pytest.mark.parametrize("packed", ["auto", "off"])
def test_host_fed_training_equals_resident_on_the_card(cuda, tmp_path, packed):
    """``--device_cache off`` against ``on`` on the card: DenseNet-121 (4
    workers, B 64, 512 examples, a 3:1 straggler, windows of 2 steps),
    packed or elastic, step graphs, cuDNN deterministic, a timing model
    fixing the plans: the same losses, parameters and momentum, bit for
    bit; nothing of the training set on the card under ``off``."""
    import numpy as np

    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    def timing(plan):
        return np.array([3.0, 1.0, 1.0, 1.0]) * np.array(
            [w.batch_size * w.steps for w in plan.workers])

    det = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        runs = {}
        for cache in ("on", "off"):
            cfg = Config(model="densenet", dataset="cifar10", batch_size=64, n_train=512,
                         world_size=4, epoch_size=2, seed=0, straggler="3,1,1,1", packed=packed,
                         stream_chunk_steps=2, device_cache=cache, debug=True, device=0,
                         log_dir=str(tmp_path / cache / "logs"),
                         stat_dir=str(tmp_path / cache / "statis"))
            tr = Trainer(cfg, timing_model=timing, device=cuda, log_to_file=False)
            tr.run()
            runs[cache] = tr
    finally:
        torch.backends.cudnn.deterministic = det
    on, off = runs["on"], runs["off"]
    assert off.train_x.device.type == "cpu" and off._train_dev is None
    assert on.recorder.data["train_loss"] == off.recorder.data["train_loss"]
    assert on.recorder.data["partition"] == off.recorder.data["partition"]
    assert all(v > 0 for v in off.recorder.data["host_put_s"])
    for p, q in zip(on.model.parameters(), off.model.parameters()):
        assert torch.equal(p, q)
        assert torch.equal(on.optimizer.state[p]["momentum_buffer"],
                           off.optimizer.state[q]["momentum_buffer"])
