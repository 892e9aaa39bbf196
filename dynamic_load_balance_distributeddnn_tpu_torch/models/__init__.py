"""Model zoo of the port: MnistNet and the DenseNet family.

``build_model(name)`` mirrors the JAX package's selection switch for the
names this port has (``densenet`` -> DenseNet-121).
"""

from __future__ import annotations

from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models import densenet, mnistnet

_TABLE = {
    "mnistnet": mnistnet.MnistNet,
    "densenet": densenet.DenseNet121,
    "densenet121": densenet.DenseNet121,
    "densenet169": densenet.DenseNet169,
    "densenet201": densenet.DenseNet201,
    "densenet161": densenet.DenseNet161,
}


def build_model(name: str, num_classes: int = 10, in_channels: int = 3) -> nn.Module:
    ctor = _TABLE.get(name)
    if ctor is None:
        raise ValueError(f"unknown or unported model {name!r}; choose from {sorted(_TABLE)}")
    return ctor(num_classes=num_classes, in_channels=in_channels)
