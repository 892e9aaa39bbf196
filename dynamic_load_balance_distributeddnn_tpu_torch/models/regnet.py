"""RegNetX/Y with SE blocks and GroupNorm (the JAX package's
``models/regnet.py``).

Constructors X_200MF / X_400MF / Y_400MF mirror the reference's;
``-m regnet`` selects RegNetY-400MF. The JAX package's ``GroupedConv`` is
``nn.Conv2d(groups=g, bias=False)`` here, with the same single kernel: flax
stores it ``(3, 3, in/g, out)`` (HWIO), which ``bridge.py``'s conv rule
turns into this module's ``(out, in/g, 3, 3)`` (OIHW). GroupNorm takes
``gcd(32, C)`` groups (``models/common.py group_norm``).

Submodules carry flax's auto-names (``Conv_k``, ``GroupNorm_k``,
``GroupedConv_0``, ``SE_0``, ``RegNetBlock_k``, ``Dense_0``) for
``bridge.py``. Input: NHWC, permuted once into an NCHW view whose memory is
channels-last.
"""

from __future__ import annotations

from typing import Mapping

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import group_norm


class SE(nn.Module):
    """Squeeze-and-excitation: a per-channel gate from the spatial mean."""

    def __init__(self, in_planes: int, se_planes: int):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_planes, se_planes, 1)
        self.Conv_1 = nn.Conv2d(se_planes, in_planes, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = x.mean(dim=(2, 3), keepdim=True)
        s = torch.sigmoid(self.Conv_1(torch.relu(self.Conv_0(s))))
        return x * s


class RegNetBlock(nn.Module):
    def __init__(self, w_in: int, w_out: int, stride: int, group_width: int,
                 bottleneck_ratio: float, se_ratio: float):
        super().__init__()
        w_b = int(round(w_out * bottleneck_ratio))
        num_groups = w_b // group_width
        self.Conv_0 = nn.Conv2d(w_in, w_b, 1, bias=False)
        self.GroupNorm_0 = group_norm(w_b, relu=True)
        self.GroupedConv_0 = nn.Conv2d(w_b, w_b, 3, stride=stride, padding=1,
                                       groups=num_groups, bias=False)
        self.GroupNorm_1 = group_norm(w_b, relu=True)
        self.se = se_ratio > 0
        if self.se:
            self.SE_0 = SE(w_b, int(round(w_in * se_ratio)))
        self.Conv_1 = nn.Conv2d(w_b, w_out, 1, bias=False)
        self.GroupNorm_2 = group_norm(w_out)
        self.shortcut = stride != 1 or w_in != w_out
        if self.shortcut:
            self.Conv_2 = nn.Conv2d(w_in, w_out, 1, stride=stride, bias=False)
            self.GroupNorm_3 = group_norm(w_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.GroupNorm_0(self.Conv_0(x))
        out = self.GroupNorm_1(self.GroupedConv_0(out))
        if self.se:
            out = self.SE_0(out)
        out = self.GroupNorm_2(self.Conv_1(out))
        sc = self.GroupNorm_3(self.Conv_2(x)) if self.shortcut else x
        return torch.relu(out + sc)


class RegNet(nn.Module):
    def __init__(self, cfg: Mapping, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 64, 3, padding=1, bias=False)
        self.GroupNorm_0 = group_norm(64, relu=True)
        self.blocks = []
        w_in = 64
        for depth, width, stride in zip(cfg["depths"], cfg["widths"], cfg["strides"]):
            for i in range(depth):
                name = f"RegNetBlock_{len(self.blocks)}"
                self.add_module(name, RegNetBlock(
                    w_in, width, stride if i == 0 else 1, cfg["group_width"],
                    cfg["bottleneck_ratio"], cfg["se_ratio"],
                ))
                self.blocks.append(name)
                w_in = width
        self.Dense_0 = nn.Linear(w_in, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.GroupNorm_0(self.Conv_0(x_nhwc.permute(0, 3, 1, 2)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def RegNetX_200MF(num_classes=10, **kw):
    return RegNet(dict(depths=[1, 1, 4, 7], widths=[24, 56, 152, 368], strides=[1, 1, 2, 2],
                       group_width=8, bottleneck_ratio=1, se_ratio=0), num_classes, **kw)


def RegNetX_400MF(num_classes=10, **kw):
    return RegNet(dict(depths=[1, 2, 7, 12], widths=[32, 64, 160, 384], strides=[1, 1, 2, 2],
                       group_width=16, bottleneck_ratio=1, se_ratio=0), num_classes, **kw)


def RegNetY_400MF(num_classes=10, **kw):
    return RegNet(dict(depths=[1, 2, 7, 12], widths=[32, 64, 160, 384], strides=[1, 1, 2, 2],
                       group_width=16, bottleneck_ratio=1, se_ratio=0.25), num_classes, **kw)
