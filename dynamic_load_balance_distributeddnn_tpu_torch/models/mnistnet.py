"""MnistNet — the debug-mode CNN (the JAX package's ``models/mnistnet.py``).

Two 5x5 valid convs with 2x2 max-pools, dropout, two dense layers; emits raw
logits for softmax cross-entropy. Submodules carry flax's auto-names. The
flatten before ``Dense_0`` runs in (h, w, c) order, as flax flattens NHWC,
so bridged weights need no row permutation.
"""

from __future__ import annotations

import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    Dropout,
    flatten_nhwc,
)


class MnistNet(nn.Module):
    def __init__(self, num_classes: int = 10, in_channels: int = 1):
        super().__init__()
        self.Conv_0 = nn.Conv2d(in_channels, 10, 5)
        self.Conv_1 = nn.Conv2d(10, 20, 5)
        self.Dense_0 = nn.Linear(320, 50)
        self.Dense_1 = nn.Linear(50, num_classes)
        self.Dropout_0 = Dropout(0.5)
        self.Dropout_1 = Dropout(0.5)

    def forward(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        f = nn.functional
        x = self.Conv_0(x_nhwc.permute(0, 3, 1, 2))
        x = f.relu(f.max_pool2d(x, 2))
        x = self.Dropout_0(self.Conv_1(x))
        x = f.relu(f.max_pool2d(x, 2))
        x = f.relu(self.Dense_0(flatten_nhwc(x)))
        return self.Dense_1(self.Dropout_1(x))
