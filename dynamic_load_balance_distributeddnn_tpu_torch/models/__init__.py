"""Model zoo of the port: MnistNet, the DenseNet family and the Transformer
language model.

``build_model(name, **kw)`` mirrors the JAX package's selection switch for
the names this port has (``densenet`` -> DenseNet-121); ``kw`` goes to the
model's constructor (``num_classes``/``in_channels`` for the vision models,
``ntoken``/``ninp``/... for ``transformer``).
"""

from __future__ import annotations

from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models import densenet, mnistnet, transformer

_TABLE = {
    "mnistnet": mnistnet.MnistNet,
    "densenet": densenet.DenseNet121,
    "densenet121": densenet.DenseNet121,
    "densenet169": densenet.DenseNet169,
    "densenet201": densenet.DenseNet201,
    "densenet161": densenet.DenseNet161,
    "transformer": transformer.TransformerLM,
}


def build_model(name: str, **kw) -> nn.Module:
    ctor = _TABLE.get(name)
    if ctor is None:
        raise ValueError(f"unknown or unported model {name!r}; choose from {sorted(_TABLE)}")
    return ctor(**kw)
