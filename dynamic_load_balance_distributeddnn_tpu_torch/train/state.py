"""The optimizer: SGD with momentum, learning rate set per epoch.

``torch.optim.SGD(momentum=0.9, dampening=0, nesterov=False)`` equals the JAX
package's ``optax.inject_hyperparams(optax.sgd)(momentum=0.9)``: optax's
trace starts at zero, so its first step's buffer is the gradient itself,
which is what torch's buffer is initialized to.
"""

from __future__ import annotations

from typing import Iterable

import torch


def make_optimizer(
    params: Iterable[torch.nn.Parameter], learning_rate: float, momentum: float = 0.9
) -> torch.optim.SGD:
    return torch.optim.SGD(
        params, lr=learning_rate, momentum=momentum, dampening=0.0, nesterov=False
    )


def learning_rate(optimizer: torch.optim.Optimizer) -> float:
    return float(optimizer.param_groups[0]["lr"])


def set_learning_rate(optimizer: torch.optim.Optimizer, lr: float) -> None:
    for group in optimizer.param_groups:
        group["lr"] = lr
