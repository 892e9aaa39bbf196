"""GoogLeNet / Inception-v1 for CIFAR with GroupNorm (the JAX package's
``models/googlenet.py``).

Every convolution (with a bias) is followed by GroupNorm + relu in 8 groups,
16 in the 3x3 branch's second convolution. The reference's b3 branch
normalises before its 1x1 convolution, a channel mismatch that crashes at
the first forward; the JAX package corrects the order (the norm after the
convolution, as in the other branches) and so does this port. The "5x5"
branch is two stacked 3x3 convolutions, as in the reference. Stage widths
are the reference's.

Submodules carry flax's auto-names (``Conv_k``/``GroupNorm_k`` in call
order, ``Inception_k``, ``Dense_0``) for ``bridge.py``. Input: NHWC,
permuted once into an NCHW view whose memory is channels-last.
"""

from __future__ import annotations

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    flatten_nhwc,
    group_norm,
)


def _add_conv_gn_relu(owner: nn.Module, k: int, cin: int, features: int, kernel: int,
                      groups: int) -> int:
    """Add ``Conv_k`` (bias on, same padding) and ``GroupNorm_k`` (relu)
    to ``owner``; returns ``features``."""
    owner.add_module(f"Conv_{k}", nn.Conv2d(cin, features, kernel, padding=kernel // 2))
    owner.add_module(f"GroupNorm_{k}", group_norm(features, groups, relu=True))
    return features


def _conv_gn_relu(owner: nn.Module, k: int, x: torch.Tensor) -> torch.Tensor:
    return getattr(owner, f"GroupNorm_{k}")(getattr(owner, f"Conv_{k}")(x))


class Inception(nn.Module):
    def __init__(self, in_planes: int, n1x1: int, n3x3red: int, n3x3: int, n5x5red: int,
                 n5x5: int, pool_planes: int):
        super().__init__()
        _add_conv_gn_relu(self, 0, in_planes, n1x1, 1, 8)
        _add_conv_gn_relu(self, 1, in_planes, n3x3red, 1, 8)
        _add_conv_gn_relu(self, 2, n3x3red, n3x3, 3, 16)
        _add_conv_gn_relu(self, 3, in_planes, n5x5red, 1, 8)
        _add_conv_gn_relu(self, 4, n5x5red, n5x5, 3, 8)
        _add_conv_gn_relu(self, 5, n5x5, n5x5, 3, 8)
        _add_conv_gn_relu(self, 6, in_planes, pool_planes, 1, 8)
        self.out_planes = n1x1 + n3x3 + n5x5 + pool_planes

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y1 = _conv_gn_relu(self, 0, x)
        y2 = _conv_gn_relu(self, 2, _conv_gn_relu(self, 1, x))
        y3 = _conv_gn_relu(self, 5, _conv_gn_relu(self, 4, _conv_gn_relu(self, 3, x)))
        y4 = _conv_gn_relu(self, 6, nn.functional.max_pool2d(x, 3, stride=1, padding=1))
        return torch.cat([y1, y2, y3, y4], dim=1)


# (n1x1, n3x3red, n3x3, n5x5red, n5x5, pool_planes) per Inception module;
# None marks the stride-2 max pools between the stages
_STAGES = (
    (64, 96, 128, 16, 32, 32), (128, 128, 192, 32, 96, 64), None,
    (192, 96, 208, 16, 48, 64), (160, 112, 224, 24, 64, 64), (128, 128, 256, 24, 64, 64),
    (112, 144, 288, 32, 64, 64), (256, 160, 320, 32, 128, 128), None,
    (256, 160, 320, 32, 128, 128), (384, 192, 384, 48, 128, 128),
)


class GoogLeNet(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 3):
        super().__init__()
        planes = _add_conv_gn_relu(self, 0, in_channels, 192, 3, 8)
        self.layers = []  # Inception names, None for a max pool
        for widths in _STAGES:
            if widths is None:
                self.layers.append(None)
                continue
            name = f"Inception_{sum(n is not None for n in self.layers)}"
            block = Inception(planes, *widths)
            self.add_module(name, block)
            self.layers.append(name)
            planes = block.out_planes
        self.Dense_0 = nn.Linear(planes, num_classes)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        x = _conv_gn_relu(self, 0, x_nhwc.permute(0, 3, 1, 2))
        for name in self.layers:
            if name is None:
                x = nn.functional.max_pool2d(x, 3, stride=2, padding=1)
            else:
                x = getattr(self, name)(x)
        x = nn.functional.avg_pool2d(x, 8, stride=1)
        return self.Dense_0(flatten_nhwc(x))
