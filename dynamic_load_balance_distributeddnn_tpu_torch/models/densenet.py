"""DenseNet-BC with GroupNorm (the JAX package's ``models/densenet.py``).

``-m densenet`` selects DenseNet-121 with growth 32, the model of the
canonical README recipe. The dataflow is the reference's literal per-layer
channel concat ``cat([out, x])``; the JAX package's preallocated-buffer
variant is not ported.

Submodules carry flax's auto-names (``Conv_0``, ``DenseBottleneck_3``,
``GroupNorm_1``, ``Transition_0``, ``Dense_0`` ...) so ``bridge.py`` maps
flax parameter paths to these modules by name, not by position.

Input: the JAX package's NHWC float batch, permuted once at the entry into
an NCHW view whose memory is channels-last (no copy).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    flatten_nhwc,
    group_norm,
)


class DenseBottleneck(nn.Module):
    """GN→relu→1x1 conv→GN→relu→3x3 conv producing ``growth_rate`` new
    channels; the concat with the input lives in ``DenseNet``."""

    def __init__(self, in_planes: int, growth_rate: int):
        super().__init__()
        self.GroupNorm_0 = group_norm(in_planes, relu=True)
        self.Conv_0 = nn.Conv2d(in_planes, 4 * growth_rate, 1, bias=False)
        self.GroupNorm_1 = group_norm(4 * growth_rate, relu=True)
        self.Conv_1 = nn.Conv2d(4 * growth_rate, growth_rate, 3, padding=1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.Conv_0(self.GroupNorm_0(x))
        return self.Conv_1(self.GroupNorm_1(out))


class Transition(nn.Module):
    def __init__(self, in_planes: int, out_planes: int):
        super().__init__()
        self.GroupNorm_0 = group_norm(in_planes, relu=True)
        self.Conv_0 = nn.Conv2d(in_planes, out_planes, 1, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return nn.functional.avg_pool2d(self.Conv_0(self.GroupNorm_0(x)), 2)


class DenseNet(nn.Module):
    def __init__(
        self,
        nblocks: Sequence[int],
        growth_rate: int = 12,
        reduction: float = 0.5,
        num_classes: int = 10,
        in_channels: int = 3,
        image_size: int = 32,
    ):
        super().__init__()
        g = growth_rate
        num_planes = 2 * g
        self.Conv_0 = nn.Conv2d(in_channels, num_planes, 3, padding=1, bias=False)
        self.stages = []  # per stage: (bottleneck names, transition name or None)
        n_bottleneck = 0
        for bi, nblock in enumerate(nblocks):
            names = []
            for _ in range(nblock):
                name = f"DenseBottleneck_{n_bottleneck}"
                self.add_module(name, DenseBottleneck(num_planes, g))
                names.append(name)
                n_bottleneck += 1
                num_planes += g
            trans = None
            if bi != len(nblocks) - 1:
                out_planes = int(math.floor(num_planes * reduction))
                trans = f"Transition_{bi}"
                self.add_module(trans, Transition(num_planes, out_planes))
                num_planes = out_planes
            self.stages.append((names, trans))
        self.GroupNorm_0 = group_norm(num_planes, relu=True)
        # spatial positions left after the transitions and the 4x4 pool,
        # flattened into Dense_0 (flax infers this width from the input)
        hw = (image_size >> (len(nblocks) - 1)) // 4
        self.Dense_0 = nn.Linear(num_planes * hw * hw, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = self.Conv_0(x_nhwc.permute(0, 3, 1, 2))
        for names, trans in self.stages:
            for name in names:
                out = getattr(self, name)(x)
                x = torch.cat([out, x], dim=1)
            if trans is not None:
                x = getattr(self, trans)(x)
        x = nn.functional.avg_pool2d(self.GroupNorm_0(x), 4)
        return self.Dense_0(flatten_nhwc(x))


def gn_shapes(b: int, nblocks: Sequence[int], growth_rate: int = 12, reduction: float = 0.5,
              image_size: int = 32) -> List[Tuple[int, int, int]]:
    """The ``[B, S, C]`` of every GroupNorm call of one :class:`DenseNet`
    forward at batch ``b``, in call order, from the architecture alone:
    each bottleneck's two (its input's C, then 4 * growth_rate), each
    transition's, and the final one."""
    g, planes, side = growth_rate, 2 * growth_rate, image_size
    shapes = []
    for bi, nblock in enumerate(nblocks):
        for _ in range(nblock):
            shapes += [(b, side * side, planes), (b, side * side, 4 * g)]
            planes += g
        if bi != len(nblocks) - 1:
            shapes.append((b, side * side, planes))
            planes, side = int(math.floor(planes * reduction)), side // 2
    return shapes + [(b, side * side, planes)]


def DenseNet121(num_classes=10, **kw):
    return DenseNet((6, 12, 24, 16), growth_rate=32, num_classes=num_classes, **kw)


def DenseNet169(num_classes=10, **kw):
    return DenseNet((6, 12, 32, 32), growth_rate=32, num_classes=num_classes, **kw)


def DenseNet201(num_classes=10, **kw):
    return DenseNet((6, 12, 48, 32), growth_rate=32, num_classes=num_classes, **kw)


def DenseNet161(num_classes=10, **kw):
    return DenseNet((6, 12, 36, 24), growth_rate=48, num_classes=num_classes, **kw)
