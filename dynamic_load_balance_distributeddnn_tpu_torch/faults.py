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
``ScheduledStragglerInjector`` makes those factors follow a time-varying
schedule (``--fault_schedule``), the scenario window-cadence rebalancing
(``--rebalance window``) is for; ``LuckyFaultInjector`` is the reference's
random machine. Every injector draws from explicit seeded generators
(:func:`seeded_rngs`, the per-event streams of the scheduled injector),
never the module-global ``random`` state, so a seed replays bit for bit and
the draws equal the JAX package's.

Not ported yet: preemption (``PreemptionInjector``, ``--elastic``).
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


class ScheduledStragglerInjector(StaticStragglerInjector):
    """A time-varying straggler profile: each worker's slowdown factor
    follows a deterministic schedule over fractional epoch-time ``t``,
    ``factor_r(t) = 1 + (f_r - 1) * gain_r(t)``. Fleet-wide (scalar-gain)
    shapes:

    * ``sin``: gain ``0.5 * (1 - cos(2*pi*t/period))``, 0 -> 1 -> 0 each
      ``period`` epochs, so a straggler appears and goes away mid-epoch;
    * ``ramp``: gain rises linearly from 0 to 1 over ``period`` epochs and
      holds;
    * ``spike``: gain 1 for the first ``duty`` fraction of each period, 0
      otherwise;
    * ``diurnal``: a flattened daytime hump (the square root of the
      positive sine half-wave), then a flat night.

    Per-worker (vector-gain, seeded) shapes, whose victims change from
    event to event, drawn from one ``random.Random`` stream per event so a
    seed replays bit for bit whatever order ``t`` is asked in:

    * ``brownout``: once a period, a contiguous block of workers slows down
      together for a seeded sub-interval;
    * ``killstorm``: once a period, a seeded victim set slows down at
      staggered offsets for staggered durations.

    Two cadences of one schedule: :meth:`epoch_faults` gives the epoch's
    mean factors (all an epoch-cadence balancer can see), :meth:`faults_at`
    the factors at an instant (what the window loop re-stages compute-mode
    injection from and the online controller folds into its rates)."""

    SCALAR_SCHEDULES = ("sin", "ramp", "spike", "diurnal")
    WORKER_SCHEDULES = ("brownout", "killstorm")

    def __init__(
        self,
        factors: Sequence[float],
        mode: str = "virtual",
        schedule: str = "sin",
        period: float = 2.0,
        phase: float = 0.0,
        duty: float = 0.25,
        seed: int = 0,
    ):
        super().__init__(factors, mode)
        if schedule not in self.SCALAR_SCHEDULES + self.WORKER_SCHEDULES:
            raise ValueError(
                "schedule must be one of "
                + "/".join(self.SCALAR_SCHEDULES + self.WORKER_SCHEDULES)
            )
        if period <= 0:
            raise ValueError("period must be > 0 epochs")
        if not 0.0 < duty <= 1.0:
            raise ValueError("duty must be in (0, 1]")
        self.schedule = schedule
        self.period = float(period)
        self.phase = float(phase)
        self.duty = float(duty)
        self.seed = int(seed)

    def _event_rng(self, n: int) -> random.Random:
        """The stream of schedule event ``n`` (the period index), derived
        anew on every call: the schedule is a pure function of (seed, t)."""
        return random.Random(self.seed * 1_000_003 + n * 7919 + 13)

    def gain(self, t: float) -> float:
        """Scalar gain in [0, 1] at epoch-time ``t`` (the fleet-wide shapes;
        the per-worker ones go through :meth:`gain_vec`)."""
        x = (float(t) - self.phase) / self.period
        if self.schedule == "sin":
            return 0.5 * (1.0 - np.cos(2.0 * np.pi * x))
        if self.schedule == "ramp":
            return float(np.clip(x, 0.0, 1.0))
        frac = x - np.floor(x)
        if self.schedule == "spike":
            return 1.0 if frac < self.duty else 0.0
        if self.schedule == "diurnal":
            return float(np.sqrt(max(0.0, np.sin(2.0 * np.pi * frac))))
        raise ValueError(f"schedule {self.schedule!r} is per-worker; use gain_vec")

    def gain_vec(self, t: float) -> np.ndarray:
        """Per-worker gain in [0, 1] at epoch-time ``t``: the scalar shapes
        broadcast; brownout and killstorm draw their victims and
        sub-intervals from the event's stream."""
        ws = len(self.factors)
        if self.schedule in self.SCALAR_SCHEDULES:
            return np.full(ws, self.gain(t), dtype=np.float64)
        x = (float(t) - self.phase) / self.period
        n = int(np.floor(x))
        frac = x - np.floor(x)
        rng = self._event_rng(n)
        g = np.zeros(ws, dtype=np.float64)
        if self.schedule == "brownout":
            # a contiguous block of workers (one rack) for a seeded window
            k = rng.randint(2, max(2, ws // 2)) if ws > 1 else 1
            start = rng.randrange(ws)
            offset = rng.uniform(0.0, 0.5)
            duration = rng.uniform(0.2, 0.5)
            if offset <= frac < offset + duration:
                for i in range(k):
                    g[(start + i) % ws] = 1.0
            return g
        # killstorm: a seeded victim set with staggered edges
        n_victims = rng.randint(1, max(1, ws - 1)) if ws > 1 else 1
        victims = rng.sample(range(ws), n_victims)
        for v in victims:
            offset = rng.uniform(0.0, 0.6)
            duration = rng.uniform(0.1, 0.4)
            if offset <= frac < offset + duration:
                g[v] = 1.0
        return g

    def factors_at(self, t: float) -> np.ndarray:
        """Per-worker slowdown factors at epoch-time ``t``."""
        if self.schedule in self.SCALAR_SCHEDULES:
            # the scalar-broadcast expression, as the JAX package has it
            return 1.0 + (self.factors - 1.0) * self.gain(t)
        return 1.0 + (self.factors - 1.0) * self.gain_vec(t)

    def _mean_factors(self, epoch: float) -> np.ndarray:
        """The epoch's mean factors, over 64 midpoints."""
        ts = epoch + (np.arange(64) + 0.5) / 64.0
        if self.schedule in self.SCALAR_SCHEDULES:
            g = float(np.mean([self.gain(t) for t in ts]))
            return 1.0 + (self.factors - 1.0) * g
        g_vec = np.mean([self.gain_vec(t) for t in ts], axis=0)
        return 1.0 + (self.factors - 1.0) * g_vec

    def _to_faults(self, factors: np.ndarray, ctx: FaultContext) -> EpochFaults:
        ws = len(self.factors)
        out = EpochFaults.none(ws)
        if self.mode == "virtual":
            out.time_multipliers = np.asarray(factors, dtype=np.float64)
            return out
        if ctx.iter_cost_s and ctx.per_example_cost_s is not None:
            extra_s_per_step = (factors - 1.0) * ctx.per_example_cost_s * ctx.batch_sizes
            out.slow_iters_per_step = np.maximum(
                np.round(extra_s_per_step / ctx.iter_cost_s), 0
            ).astype(np.int64)
        return out

    def epoch_faults(self, epoch, num_batches, ctx):
        """Epoch cadence: the schedule's mean over the epoch."""
        return self._to_faults(self._mean_factors(float(epoch)), ctx)

    def faults_at(self, t: float, ctx: FaultContext) -> EpochFaults:
        """Window cadence: the faults at epoch-time ``t``."""
        return self._to_faults(self.factors_at(t), ctx)
