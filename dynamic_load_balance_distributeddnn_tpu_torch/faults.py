"""Straggler injection (the JAX package's ``faults.py``, virtual mode only).

``virtual`` delivery multiplies or adds to the *measured* time vector fed to
the solver and never slows the card — the reference's sleeps are simulation
too. ``StaticStragglerInjector`` expresses the README recipe's contention
(the reference's ``-gpu 0,0,0,1``) as per-worker slowdown factors.

Not ported yet: ``compute`` delivery (real injected FLOPs, which needs
``ops/faultload.py synthetic_load``), the random ``LuckyFaultInjector``, the
time-varying schedules and preemption.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np


@dataclasses.dataclass
class EpochFaults:
    """Per-worker injection plan for one epoch."""

    virtual_seconds: np.ndarray   # [ws] seconds added to the time vector
    time_multipliers: np.ndarray  # [ws] multiplicative factors on measured time

    @classmethod
    def none(cls, ws: int) -> "EpochFaults":
        return cls(np.zeros(ws), np.ones(ws))


@dataclasses.dataclass
class FaultContext:
    """What the engine knows that injectors may need."""

    batch_sizes: np.ndarray  # [ws]


class FaultInjector:
    def epoch_faults(self, epoch: int, num_batches: int, ctx: FaultContext) -> EpochFaults:
        raise NotImplementedError


class NullInjector(FaultInjector):
    def __init__(self, world_size: int):
        self.ws = world_size

    def epoch_faults(self, epoch, num_batches, ctx):
        return EpochFaults.none(self.ws)


class StaticStragglerInjector(FaultInjector):
    """Fixed per-worker slowdown factors: factor f means the worker's
    per-example cost is f times the clean cost."""

    def __init__(self, factors: Sequence[float], mode: str = "virtual"):
        if mode != "virtual":
            raise NotImplementedError(
                f"fault mode {mode!r}: only 'virtual' delivery is ported"
            )
        self.factors = np.asarray(factors, dtype=np.float64)
        self.mode = mode

    def epoch_faults(self, epoch, num_batches, ctx):
        out = EpochFaults.none(len(self.factors))
        out.time_multipliers = self.factors.copy()
        return out
