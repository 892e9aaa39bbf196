"""CIFAR-style ResNet with GroupNorm (the JAX package's ``models/resnet.py``).

GroupNorm instead of BatchNorm is the reference's choice: batch statistics
would be skewed by DBS's unequal per-worker batches. Constructors
18/34/50/101/152 mirror the reference's; ``-m resnet`` selects ResNet-101.
Each block's last GroupNorm and the shortcut's run without relu; the relu
follows the residual sum.

Submodules carry flax's auto-names (``Conv_0``, ``GroupNorm_1``,
``Bottleneck_7``, ``Dense_0`` ...) so ``bridge.py`` maps flax parameter
paths to them by name. Input: the JAX package's NHWC float batch, permuted
once at the entry into an NCHW view whose memory is channels-last.
"""

from __future__ import annotations

from typing import Sequence, Type

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    flatten_nhwc,
    group_norm,
)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_planes, planes, 3, stride=stride, padding=1, bias=False)
        self.GroupNorm_0 = group_norm(planes, relu=True)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, padding=1, bias=False)
        self.GroupNorm_1 = group_norm(planes)
        self.shortcut = stride != 1 or in_planes != planes
        if self.shortcut:
            self.Conv_2 = nn.Conv2d(in_planes, planes, 1, stride=stride, bias=False)
            self.GroupNorm_2 = group_norm(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.GroupNorm_1(self.Conv_1(self.GroupNorm_0(self.Conv_0(x))))
        sc = self.GroupNorm_2(self.Conv_2(x)) if self.shortcut else x
        return torch.relu(out + sc)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        out_planes = self.expansion * planes
        self.Conv_0 = nn.Conv2d(in_planes, planes, 1, bias=False)
        self.GroupNorm_0 = group_norm(planes, relu=True)
        self.Conv_1 = nn.Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.GroupNorm_1 = group_norm(planes, relu=True)
        self.Conv_2 = nn.Conv2d(planes, out_planes, 1, bias=False)
        self.GroupNorm_2 = group_norm(out_planes)
        self.shortcut = stride != 1 or in_planes != out_planes
        if self.shortcut:
            self.Conv_3 = nn.Conv2d(in_planes, out_planes, 1, stride=stride, bias=False)
            self.GroupNorm_3 = group_norm(out_planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.GroupNorm_0(self.Conv_0(x))
        out = self.GroupNorm_1(self.Conv_1(out))
        out = self.GroupNorm_2(self.Conv_2(out))
        sc = self.GroupNorm_3(self.Conv_3(x)) if self.shortcut else x
        return torch.relu(out + sc)


class ResNet(nn.Module):
    def __init__(self, block: Type[nn.Module], num_blocks: Sequence[int],
                 num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.GroupNorm_0 = group_norm(64, relu=True)
        self.blocks = []
        in_planes = 64
        for planes, n, stride in zip((64, 128, 256, 512), num_blocks, (1, 2, 2, 2)):
            for i in range(n):
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(in_planes, planes, stride if i == 0 else 1))
                self.blocks.append(name)
                in_planes = block.expansion * planes
        self.Dense_0 = nn.Linear(in_planes, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.GroupNorm_0(self.Conv_0(x_nhwc.permute(0, 3, 1, 2)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        x = nn.functional.avg_pool2d(x, 4)
        return self.Dense_0(flatten_nhwc(x))


def ResNet18(num_classes=10, **kw):
    return ResNet(BasicBlock, (2, 2, 2, 2), num_classes, **kw)


def ResNet34(num_classes=10, **kw):
    return ResNet(BasicBlock, (3, 4, 6, 3), num_classes, **kw)


def ResNet50(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 4, 6, 3), num_classes, **kw)


def ResNet101(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 4, 23, 3), num_classes, **kw)


def ResNet152(num_classes=10, **kw):
    return ResNet(Bottleneck, (3, 8, 36, 3), num_classes, **kw)
