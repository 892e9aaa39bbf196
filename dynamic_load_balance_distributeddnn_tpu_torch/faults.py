"""Straggler injection (the JAX package's ``faults.py``).

The reference's "fault tolerance test" (dbs.py:94-129) randomly slows
workers: each epoch, a worker that is not already waiting rolls luck against
``-ftc``; on a hit it loses U[5,10] extra seconds an epoch (spread over the
epoch's steps) for U[4,20] epochs. "Fault tolerance" means the balancer
routes data away from the straggler: graceful degradation, not failover.

Two delivery modes (``--fault_mode``):

- ``virtual``: the extra seconds are added to the *measured* time vector
  fed to the solver, or multiply it, and the card is never slowed; the
  reference's sleeps are simulation too.
- ``compute``: the extra time becomes real device work
  (``ops/faultload.py``), a number of synthetic-load iterations a step at a
  calibrated cost an iteration, so the wall genuinely moves. On one card
  every worker shares the device, so this is the only mode in which a
  straggler slows the card.

``StaticStragglerInjector`` expresses the README recipe's contention (the
reference's ``-gpu 0,0,0,1``) as per-worker slowdown factors;
``LuckyFaultInjector`` is the reference's random machine. Every injector
draws from explicit seeded generators (:func:`seeded_rngs`), never the
module-global ``random`` state, so a seed replays bit for bit and the draws
equal the JAX package's.

Not ported yet: the time-varying schedules (``--fault_schedule``) and
preemption.
"""

from __future__ import annotations

import dataclasses
import random
from typing import List, Optional, Sequence

import numpy as np


def seeded_rngs(seed: int, n: int) -> List[random.Random]:
    """One independent seeded ``random.Random`` stream per worker. The
    ``seed * 977 + r`` derivation is the JAX package's stream layout, so the
    same seed gives the same schedule in both packages."""
    return [random.Random(seed * 977 + r) for r in range(n)]


@dataclasses.dataclass
class EpochFaults:
    """Per-worker injection plan for one epoch."""

    virtual_seconds: np.ndarray      # [ws] seconds added to the time vector
    slow_iters_per_step: np.ndarray  # [ws] synthetic-load iterations a step
    time_multipliers: np.ndarray     # [ws] multiplicative factors on measured time

    @classmethod
    def none(cls, ws: int) -> "EpochFaults":
        return cls(np.zeros(ws), np.zeros(ws, dtype=np.int64), np.ones(ws))


@dataclasses.dataclass
class FaultContext:
    """What the engine knows that injectors may need: per-worker true batch
    sizes and the calibrated conversion rates of compute-mode delivery."""

    batch_sizes: np.ndarray                          # [ws]
    iter_cost_s: Optional[float] = None              # seconds a synthetic-load iteration
    per_example_cost_s: Optional[np.ndarray] = None  # [ws] clean seconds an example


class FaultInjector:
    def epoch_faults(self, epoch: int, num_batches: int, ctx: FaultContext) -> EpochFaults:
        raise NotImplementedError


class NullInjector(FaultInjector):
    def __init__(self, world_size: int):
        self.ws = world_size

    def epoch_faults(self, epoch, num_batches, ctx):
        return EpochFaults.none(self.ws)


class LuckyFaultInjector(FaultInjector):
    """The reference's random straggler machine (dbs.py:94-129)."""

    def __init__(
        self,
        world_size: int,
        chance: float,
        mode: str = "virtual",
        seed: int = 0,
        logger=None,
    ):
        self.ws = world_size
        self.chance = chance
        self.mode = mode
        self.logger = logger
        self._rngs = seeded_rngs(seed, world_size)
        self._waiting = [False] * world_size
        self._until = [0] * world_size
        self._wait_s = [0] * world_size

    def epoch_faults(self, epoch, num_batches, ctx):
        out = EpochFaults.none(self.ws)
        for r in range(self.ws):
            if self._waiting[r] and epoch > self._until[r]:
                self._waiting[r] = False
            if not self._waiting[r]:
                luck = self._rngs[r].random()
                if self.logger:
                    self.logger.info(
                        f"Worker {r} got a luck of {luck:.3f}, limit is {self.chance}"
                    )
                if luck < self.chance:
                    # U[5,10] extra seconds an epoch for U[4,20] epochs (dbs.py:120-122)
                    self._wait_s[r] = self._rngs[r].randint(5, 10)
                    self._until[r] = epoch + self._rngs[r].randint(4, 20)
                    self._waiting[r] = True
                    if self.logger:
                        self.logger.info(
                            f"Worker {r} starts to have a {self._wait_s[r]} seconds "
                            f"more waiting until epoch {self._until[r]}!"
                        )
            if self._waiting[r]:
                secs = float(self._wait_s[r])
                if self.mode == "compute" and ctx.iter_cost_s:
                    out.slow_iters_per_step[r] = max(
                        1, int(round(secs / max(num_batches, 1) / ctx.iter_cost_s))
                    )
                else:
                    out.virtual_seconds[r] = secs
        return out


class StaticStragglerInjector(FaultInjector):
    """Fixed per-worker slowdown factors: factor f means the worker's
    per-example cost is f times the clean cost. ``compute`` mode turns the
    extra cost into synthetic-load iterations a step once both conversion
    rates are known (none before: the first epoch anchors them)."""

    def __init__(self, factors: Sequence[float], mode: str = "virtual"):
        self.factors = np.asarray(factors, dtype=np.float64)
        self.mode = mode

    def epoch_faults(self, epoch, num_batches, ctx):
        out = EpochFaults.none(len(self.factors))
        if self.mode == "virtual":
            out.time_multipliers = self.factors.copy()
            return out
        if ctx.iter_cost_s and ctx.per_example_cost_s is not None:
            extra_s_per_step = (self.factors - 1.0) * ctx.per_example_cost_s * ctx.batch_sizes
            out.slow_iters_per_step = np.maximum(
                np.round(extra_s_per_step / ctx.iter_cost_s), 0
            ).astype(np.int64)
        return out
