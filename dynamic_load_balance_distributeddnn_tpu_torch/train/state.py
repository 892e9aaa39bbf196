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


# ------------------------------------------------------------------ ZeRO-1


def zero1_param_count(params) -> int:
    """The raveled parameter count: the sum of the leaves' sizes."""
    return int(sum(p.numel() for p in params))


def zero1_padded_size(params, n_shards: int) -> int:
    """The flat parameter count padded up to a multiple of the shard count:
    the one padding convention of the flat buffers and the chunks."""
    n = max(int(n_shards), 1)
    return -(-zero1_param_count(params) // n) * n


def shard_optimizer_state(optimizer: torch.optim.SGD, params, n_shards: int,
                          rank: int) -> torch.Tensor:
    """This rank's chunk of SGD's momentum trace on the flat padded
    parameter vector (``params`` in the flat order, each raveled in its
    memory order, as ``train/combine.py``'s flat buffers are): the 1/n of
    the optimizer state a rank keeps under ``--shard_update``. Existing
    full buffers are carried into the chunk and dropped from the
    optimizer, so no rank holds the whole trace; without them the chunk
    starts at zero (optax's trace, torch's first step)."""
    params = list(params)
    padded = zero1_padded_size(params, n_shards)
    chunk = padded // max(int(n_shards), 1)
    dev = params[0].device
    flat = torch.zeros(padded, dtype=torch.float32, device=dev)
    off = 0
    for p in params:
        buf = optimizer.state.get(p, {}).pop("momentum_buffer", None)
        if buf is not None:
            torch.as_strided(flat, p.shape, p.stride(), off).copy_(buf)
        off += p.numel()
    return flat[rank * chunk:(rank + 1) * chunk].clone()
