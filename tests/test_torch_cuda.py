"""The port's CUDA kernels against their plain PyTorch versions, on a card.

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch is installed:
``python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py``.
Without a card every test skips: a CUDA kernel has no CPU mode.

Tolerances: f32 GroupNorm forward atol 1e-4 and gradients 5e-4 (f32
statistics, other reduction order); the parameter gradients are sums over
B*S terms, held relative to their size (rtol 1e-4); bf16 input and output
round to 8 significant bits (atol 3e-2 plus rtol 1e-2); cross-entropy atol
1e-5.
"""

import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.models.densenet import DenseNet
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime
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
    assert all(n > 0 for n in runtime.LAUNCHES.values()), runtime.LAUNCHES
