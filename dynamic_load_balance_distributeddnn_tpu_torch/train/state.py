"""The optimizer: SGD with momentum, learning rate set per epoch.

``torch.optim.SGD(momentum=0.9, dampening=0, nesterov=False)`` equals the JAX
package's ``optax.inject_hyperparams(optax.sgd)(momentum=0.9)``: optax's
trace starts at zero, so its first step's buffer is the gradient itself,
which is what torch's buffer is initialized to.

The port creates each momentum buffer at zero before the first step
(``train/steps.py`` ``prepare_step_state``), so the buffers keep their
addresses from the first step on and a captured CUDA graph can update them
in place (``train/supersteps.py``). That is bit-identical to torch's
clone-on-first-step, since ``0 * momentum + g`` is ``g``, and it is optax's
trace from zero.
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
