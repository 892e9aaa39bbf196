"""Shared model building blocks: GroupNorm (+ relu), seeded dropout, and
flax's default initializers.

Layout: activations are NCHW tensors in ``torch.channels_last`` memory, so a
``[B, C, H, W]`` activation is the contiguous ``[B, H*W, C]`` the GroupNorm
kernel (and the TPU kernel before it) reads.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.groupnorm import (
    group_norm as _group_norm,
)


class GroupNorm(nn.Module):
    """GroupNorm over the channel axis of an NCHW (channels-last) activation,
    with the relu applied inside the module when ``relu=True``.

    One parameter layout, ``weight``/``bias`` of shape [C] (flax's
    ``scale``/``bias``), whichever version runs: a CUDA tensor goes to the
    kernel, a CPU tensor to the plain version. ``eps`` defaults to flax's
    1e-6, not torch's 1e-5."""

    def __init__(self, channels: int, num_groups: int, eps: float = 1e-6, relu: bool = False):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"{channels} channels not divisible by {num_groups} groups")
        self.num_groups = num_groups
        self.eps = eps
        self.relu = relu
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, c, h, w = x.shape
        # [B, C, H, W] channels-last -> [B, H*W, C]: a view, no copy (reshape
        # copies only if the caller broke the channels-last layout)
        x3 = x.permute(0, 2, 3, 1).reshape(b, h * w, c)
        y = _group_norm(x3, self.weight, self.bias, self.num_groups, self.eps, self.relu)
        return y.reshape(b, h, w, c).permute(0, 3, 1, 2)

    def extra_repr(self) -> str:
        return (
            f"{self.weight.shape[0]}, groups={self.num_groups}, eps={self.eps}, "
            f"relu={self.relu}"
        )


def group_norm(channels: int, groups: int = 32, relu: bool = False) -> GroupNorm:
    """GroupNorm with the reference's group count where it divides the
    channel count, else ``gcd(groups, channels)``."""
    return GroupNorm(channels, math.gcd(groups, channels), relu=relu)


class Dropout(nn.Module):
    """Inverted dropout whose mask comes from an explicit generator
    (``self.generator``, set by the trainer for the model's device; the
    default generator when None). Identity in eval mode."""

    def __init__(self, p: float):
        super().__init__()
        self.p = p
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self.generator, device=x.device) >= self.p
        return x * keep.to(x.dtype) / (1.0 - self.p)


def flatten_nhwc(x: torch.Tensor) -> torch.Tensor:
    """Flatten [B, C, H, W] in (h, w, c) order, as flax flattens its NHWC
    activations, so bridged Dense weights need no row permutation."""
    return x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)


@torch.no_grad()
def init_flax_defaults(model: nn.Module, generator: torch.Generator) -> None:
    """flax's default initializers: conv/dense kernels lecun_normal (a normal
    truncated at two standard deviations, std sqrt(1/fan_in)/0.8796),
    biases zero, GroupNorm scale one. Drawn on the CPU from ``generator`` so
    a seed gives the same weights on every device."""
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.Linear)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=generator)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, GroupNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()
