"""Learning-rate schedule: the reference's "one-cycle policy" as the JAX
package implements it — constant base LR, then a linear decay over the last
30% of epochs down to 0.01x; disabled under ``-de``."""

from __future__ import annotations


def one_cycle_lr(
    base_lr: float,
    epoch: int,
    epoch_size: int,
    enabled: bool = True,
    disable_enhancements: bool = False,
) -> float:
    if not enabled or disable_enhancements:
        return base_lr
    start = 0.7 * epoch_size
    if epoch >= start:
        frac = (epoch - start) / (0.3 * epoch_size)
        return base_lr - 0.99 * base_lr * frac
    return base_lr
