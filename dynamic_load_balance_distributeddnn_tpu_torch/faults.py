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

``PreemptionInjector`` extends the fault model past stragglers to worker
*loss* (``--elastic on``): kill, suspend and rejoin schedules, delivered
virtually (the engine's health checks see the worker as down: the elastic
recovery path, ``train/engine.py`` ``_recover``) or to real processes by
signal. Its ``chance`` mode draws from its own seeded generator, so a seed
gives the JAX package's schedule.
"""

from __future__ import annotations

import dataclasses
import random
from typing import Dict, List, Optional, Sequence, Set

import numpy as np

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer


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


@dataclasses.dataclass(frozen=True)
class PreemptionEvent:
    """One scheduled worker outage.

    ``down_at`` is in fractional epoch-time (1.5 = halfway through epoch 1),
    so outages land MID-epoch — the case the elastic recovery path must
    survive, not just the tidy boundary one. ``rejoin_epoch`` is the epoch
    BOUNDARY at which the worker offers to come back (readmission is
    boundary-only by design: plans are immutable within an epoch); None
    means it never returns. ``kind`` distinguishes a preemption that loses
    the process ("kill") from one that freezes it ("suspend") — virtually
    identical (the worker is unreachable either way), but real-process
    delivery sends SIGKILL vs SIGSTOP/SIGCONT."""

    worker: int
    down_at: float
    rejoin_epoch: Optional[int] = None
    kind: str = "kill"

    def __post_init__(self):
        if self.kind not in ("kill", "suspend"):
            raise ValueError("kind must be 'kill' or 'suspend'")
        if self.rejoin_epoch is not None and self.rejoin_epoch <= self.down_at:
            raise ValueError("rejoin_epoch must be after down_at")


class PreemptionInjector(FaultInjector):
    """Kill/suspend/rejoin schedules — the preemptible-fleet fault model.

    Two delivery modes, mirroring the straggler injectors' virtual/compute
    split:

    * **virtual** (default): the engine's health checks ask
      :meth:`down_workers` and see the scheduled workers as unreachable —
      deterministic, cheap, exactly what the recovery-path tests drive.
    * **real**: :meth:`attach_process` binds a worker to a live OS pid and
      :meth:`deliver` sends the due signals (SIGKILL for "kill", SIGSTOP /
      SIGCONT around a "suspend") — a harness of real worker processes preempts
      them with it (the JAX package's multi-host chaos tests).

    Schedules are either explicit (``schedule=[PreemptionEvent(...)]``) or
    drawn per epoch from ``chance`` using an explicit seeded generator —
    never module-global ``random`` — so a given ``--seed`` replays the same
    outages (the chaos round-trip tests are deterministic).

    ``base`` optionally composes a straggler injector underneath: a fleet
    can be slow AND losing workers; ``epoch_faults`` delegates to it, with
    downed workers' injected load zeroed (a dead worker injects nothing).
    """

    def __init__(
        self,
        world_size: int,
        schedule: Sequence[PreemptionEvent] = (),
        *,
        chance: float = 0.0,
        max_down_epochs: int = 3,
        seed: int = 0,
        rng: Optional[random.Random] = None,
        base: Optional[FaultInjector] = None,
        logger=None,
    ):
        self.ws = int(world_size)
        for ev in schedule:
            if not 0 <= ev.worker < world_size:
                raise ValueError(f"event worker {ev.worker} out of range")
        self._events: List[PreemptionEvent] = sorted(
            schedule, key=lambda e: e.down_at
        )
        self.chance = float(chance)
        self.max_down_epochs = int(max_down_epochs)
        self._rng = rng if rng is not None else random.Random(seed * 6151 + 17)
        self.base = base
        self.logger = logger
        self._rolled_epochs: Set[int] = set()
        self._pids: Dict[int, int] = {}
        self._respawns: Dict[int, object] = {}
        self._delivered: Set[tuple] = set()

    # ------------------------------------------------------------- schedule

    def _roll(self, epoch: int) -> None:
        """Random mode: draw this epoch's outages once (idempotent — the
        engine may re-run an epoch after a recovery; the schedule must not
        re-roll or the retry would chase fresh faults forever)."""
        if self.chance <= 0.0 or epoch in self._rolled_epochs:
            return
        self._rolled_epochs.add(epoch)
        down_now = self.down_workers(epoch + 1.0)
        for r in range(self.ws):
            if r in down_now:
                continue
            if self._rng.random() < self.chance:
                ev = PreemptionEvent(
                    worker=r,
                    down_at=epoch + self._rng.random(),
                    rejoin_epoch=epoch + 1 + self._rng.randint(
                        1, self.max_down_epochs
                    ),
                    kind="kill" if self._rng.random() < 0.5 else "suspend",
                )
                self._events.append(ev)
                if self.logger:
                    self.logger.info(
                        f"preemption scheduled: worker {ev.worker} "
                        f"{ev.kind} at t={ev.down_at:.2f}, rejoin at "
                        f"epoch {ev.rejoin_epoch}"
                    )
                get_tracer().instant(
                    "fault_scheduled", cat="fault",
                    args={
                        "worker": ev.worker,
                        "kind": ev.kind,
                        "down_at": round(ev.down_at, 4),
                        "rejoin_epoch": ev.rejoin_epoch,
                    },
                )

    def schedule(self) -> List[PreemptionEvent]:
        return list(self._events)

    def down_workers(self, t: float) -> Set[int]:
        """Workers scheduled down at epoch-time ``t`` (``down_at <= t`` and
        not yet past their rejoin boundary)."""
        out: Set[int] = set()
        for ev in self._events:
            if ev.down_at <= t and (
                ev.rejoin_epoch is None or t < ev.rejoin_epoch
            ):
                out.add(ev.worker)
        return out

    def rejoining(self, epoch: int) -> Set[int]:
        """Workers whose rejoin boundary is exactly ``epoch`` (the engine
        readmits them before planning that epoch)."""
        return {
            ev.worker
            for ev in self._events
            if ev.rejoin_epoch is not None and ev.rejoin_epoch == epoch
        }

    # ----------------------------------------------------- injector surface

    def epoch_faults(self, epoch, num_batches, ctx):
        self._roll(int(epoch))
        out = (
            self.base.epoch_faults(epoch, num_batches, ctx)
            if self.base is not None
            else EpochFaults.none(self.ws)
        )
        # a downed worker injects nothing — its load is GONE, not slow
        for r in self.down_workers(float(epoch) + 1.0):
            if r < len(out.virtual_seconds):
                out.virtual_seconds[r] = 0.0
                out.slow_iters_per_step[r] = 0
                out.time_multipliers[r] = 1.0
        return out

    # --------------------------------------------------- real-process mode

    def attach_process(self, worker: int, pid: int) -> None:
        """Bind a worker to a live OS process for real signal delivery."""
        self._pids[int(worker)] = int(pid)

    def attach_respawn(self, worker: int, spawn) -> None:
        """Bind a worker to a respawn callable: at a "kill"
        event's ``rejoin_epoch`` edge, :meth:`deliver` calls ``spawn()``
        once — the chaos-harness hook that turns a SIGKILLed process into a
        kill → shrink → rejoin → grow round-trip (the respawned process
        offers a rendezvous join; the survivors admit it at their next
        epoch boundary). ``spawn`` may return the new pid (or a Popen with
        a ``pid``), in which case the worker is re-attached for any later
        scheduled signals; idempotent per edge like every other delivery."""
        self._respawns[int(worker)] = spawn

    def deliver(self, t: float) -> List[tuple]:
        """Send every signal due by epoch-time ``t`` to attached processes
        (each edge delivered once): SIGKILL for "kill", SIGSTOP at a
        "suspend" edge, SIGCONT at its rejoin edge. Returns the delivered
        ``(worker, signal_name)`` edges — the harness asserts on them."""
        import signal

        sent: List[tuple] = []
        for ev in self._events:
            pid = self._pids.get(ev.worker)
            if pid is None:
                continue
            if ev.down_at <= t:
                key = (ev.worker, ev.down_at, "down")
                if key not in self._delivered:
                    self._delivered.add(key)
                    sig = signal.SIGKILL if ev.kind == "kill" else signal.SIGSTOP
                    try:
                        os_kill(pid, sig)
                        sent.append((ev.worker, sig.name))
                    except ProcessLookupError:
                        pass
            if (
                ev.kind == "suspend"
                and ev.rejoin_epoch is not None
                and ev.rejoin_epoch <= t
            ):
                key = (ev.worker, ev.rejoin_epoch, "rejoin")
                if key not in self._delivered:
                    self._delivered.add(key)
                    try:
                        os_kill(pid, signal.SIGCONT)
                        sent.append((ev.worker, "SIGCONT"))
                    except ProcessLookupError:
                        pass
            if (
                ev.kind == "kill"
                and ev.rejoin_epoch is not None
                and ev.rejoin_epoch <= t
                and ev.worker in self._respawns
            ):
                # a SIGKILLed PROCESS cannot SIGCONT back — its rejoin edge
                # is a RESPAWN (the spawned process offers a rendezvous
                # join and the fleet re-grows at the next epoch boundary)
                key = (ev.worker, ev.rejoin_epoch, "respawn")
                if key not in self._delivered:
                    self._delivered.add(key)
                    got = self._respawns[ev.worker]()
                    new_pid = getattr(got, "pid", got)
                    if isinstance(new_pid, int):
                        self._pids[ev.worker] = new_pid
                    sent.append((ev.worker, "RESPAWN"))
        if sent:
            # fleet-timeline instants: every REAL signal edge the
            # chaos harness delivers lands on the flight recorder, so a
            # postmortem shows the injection beside its consequences
            tracer = get_tracer()
            if tracer.enabled:
                for worker, signame in sent:
                    tracer.instant(
                        "fault_deliver", cat="fault",
                        args={
                            "worker": int(worker),
                            "signal": signame,
                            "t": round(float(t), 4),
                        },
                    )
        return sent


def os_kill(pid: int, sig) -> None:
    """``os.kill`` behind a seam the tests can monkeypatch (virtual harness
    runs must never signal arbitrary pids by accident)."""
    import os

    os.kill(pid, sig)
