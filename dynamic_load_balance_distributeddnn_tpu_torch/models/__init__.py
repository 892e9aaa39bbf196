"""Model zoo of the port: MnistNet, the ResNet, DenseNet, GoogLeNet and
RegNet families, and the Transformer language model.

``build_model(name, **kw)`` mirrors the JAX package's selection switch (the
reference's model switch): ``resnet`` -> ResNet-101, ``densenet`` ->
DenseNet-121, ``googlenet`` -> GoogLeNet, ``regnet`` -> RegNetY-400MF, plus
every named variant, ``mnistnet`` and ``transformer``; ``kw`` goes to the
model's constructor (``num_classes``/``in_channels`` for the vision models,
``ntoken``/``ninp``/... for ``transformer``).
"""

from __future__ import annotations

from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models import (
    densenet,
    googlenet,
    mnistnet,
    regnet,
    resnet,
    transformer,
)

_TABLE = {
    "mnistnet": mnistnet.MnistNet,
    "resnet": resnet.ResNet101,
    "resnet18": resnet.ResNet18,
    "resnet34": resnet.ResNet34,
    "resnet50": resnet.ResNet50,
    "resnet101": resnet.ResNet101,
    "resnet152": resnet.ResNet152,
    "densenet": densenet.DenseNet121,
    "densenet121": densenet.DenseNet121,
    "densenet169": densenet.DenseNet169,
    "densenet201": densenet.DenseNet201,
    "densenet161": densenet.DenseNet161,
    "googlenet": googlenet.GoogLeNet,
    "regnet": regnet.RegNetY_400MF,
    "regnetx200mf": regnet.RegNetX_200MF,
    "regnetx400mf": regnet.RegNetX_400MF,
    "regnety400mf": regnet.RegNetY_400MF,
    "transformer": transformer.TransformerLM,
}


def build_model(name: str, **kw) -> nn.Module:
    ctor = _TABLE.get(name)
    if ctor is None:
        raise ValueError(f"unknown model {name!r}; choose from {sorted(_TABLE)}")
    return ctor(**kw)
