"""Many-stream training engine: nested inverse-time DBS scheduling of
concurrent jobs over the slots of one card (the JAX package's
``runtime/scheduler.py``, copied).

A job is a VALUE, not a process: :class:`JobSpec` packages everything the
engine's plan→dispatch→record loop needs (config, data bundle, injector,
deterministic timing model) and :class:`MultiStreamEngine` multiplexes many
of them over a single :class:`DevicePool`, admitting and retiring tenants
at outer *window* boundaries (one inner epoch per live job per window).

Two nested solvers share one spine (balance/solver.py):

- **inner** — each tenant's own DBS loop partitions its *examples* over its
  allotted slots, bit-for-bit unchanged from the single-stream engine;
- **outer** — the scheduler partitions the *pool* over tenants from their
  measured per-example costs. The coupling is inverted relative to the
  inner problem: more slots SHORTEN a tenant's epoch where more examples
  LENGTHEN a worker's step, so the outer solve feeds the solver
  *reciprocal* epoch walls — ``rebalance(1/t, p, P)`` updates slot share
  r_j ∝ p_j·t_j, whose fixed point equalizes per-tenant epoch walls at
  d_j ∝ c_j·E_j (slot-seconds of demand). ``quantize_batches(·, 1, P)``
  then snaps shares to integer slot counts with every tenant kept ≥ 1 slot
  and the counts summing to the pool.

Slots on one card. A process of this port owns one device (``config.py``
refuses a ``-gpu`` map naming several), so a pool ordinal is a *slot* of
the engine's one device, as the reference's ``-gpu 0,0,0,1`` places logical
workers on shared cards. Which slot each rank of a tenant sits on is
:attr:`JobSpec.slots` (the JAX ``config.worker_device_ids`` of the same
tenant; None is the JAX default, rank r on slot ``r % P``). The pool decides
which ranks of each tenant are active; every active rank trains on the card.

Actuation rides the engine's planned-re-shard spine: a pool re-allocation
is the ``_maybe_readmit`` recipe (state→host, ``_reshard_world`` to the
new rank set, state written back in place, comm-residual fix, cost-anchor
carry), not a fault. The tenant's trainer is constructed at the window
boundary; its step graphs are captured at each key's first step
(``train/supersteps.py``), so a steady window captures nothing.

Concurrency: every tenant runs its epochs on its own ``_job_worker`` thread
and its own CUDA stream (the kernel wrappers launch on the thread's current
stream), so tenants overlap on the card; the scheduler thread's work for a
tenant (construction, a re-shard's state copies, the final save) runs on
that tenant's stream too, ordered against what the thread queued before.
An epoch holds ``train/supersteps.py``'s ``CAPTURE_GATE`` shared, so a
step-graph capture (which holds it exclusively) runs while no other tenant
works: in a window where a tenant captures a new key, its capture waits for
the other tenants' epochs. A tenant's launch counts are those of its
streams (``ops/kernels/runtime.py`` ``context``), exact up to 16 tenants:
streams come from PyTorch's pool of 32 a device, so beyond that two
tenants can share a stream and its counts. All cross-thread state is
guarded by ONE engine lock. The pool's ordinal→tenant map is stored under
``_mesh``: a re-allocation is a topology write, legal only while the pool
is quiesced between windows.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import JOURNAL_CAP
from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import (
    equilibrium_shares,
    initial_partition,
    integer_batch_split,
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.obs.registry import MetricsRegistry
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import retry_transient
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import CAPTURE_GATE

__all__ = ["JobSpec", "JobState", "DevicePool", "MultiStreamEngine"]


@dataclasses.dataclass(frozen=True)
class JobSpec:
    """One training job as a value.

    ``config`` describes the job's FULL-FLEET shape: ``world_size`` workers
    on the pool's slots by ``slots`` (one per rank, the JAX
    ``config.worker_device_ids`` of the tenant; None puts rank r on slot
    ``r % P``, the JAX default of ``device=None``). The canonical
    many-stream shape is one worker per slot: ``world_size == pool size``.
    The pool allots a subset of slots; the scheduler activates exactly the
    ranks living on them via the planned-re-shard spine, so a tenant's
    footprint can grow and shrink across windows without the job ever
    restarting. The config names the engine's card (``-gpu 0,0`` or the
    default).

    ``epochs`` caps the job at that many epochs (default: the config's
    ``epoch_size``); ``arrival_window`` delays admission until that outer
    window; ``max_devices`` bounds the tenant's allotment of slots (excess
    slots go to other tenants, or idle)."""

    job_id: str
    config: Config
    bundle: Optional[Any] = None
    injector: Optional[Any] = None
    timing_model: Optional[Callable] = None
    epochs: Optional[int] = None
    arrival_window: int = 0
    max_devices: Optional[int] = None
    slots: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.slots is not None and len(self.slots) != self.config.world_size:
            raise ValueError(
                f"job {self.job_id!r}: slots {list(self.slots)} name {len(self.slots)} "
                f"ranks but the config has world_size {self.config.world_size}"
            )

    def total_epochs(self) -> int:
        return self.config.epoch_size if self.epochs is None else int(self.epochs)


class JobState:
    """Mutable runtime record of one tenant. Every field written after
    admission is guarded by the owning engine's ``_lock`` (the worker
    thread and the scheduler loop both touch it)."""

    def __init__(self, spec: JobSpec):
        self.spec = spec
        self.status = "pending"  # pending→running→finishing→done | failed
        self.trainer = None
        self.stream: Optional[torch.cuda.Stream] = None  # the tenant's CUDA stream
        self.devices: Tuple[int, ...] = ()
        self.epochs_done = 0
        self.epoch_walls: List[float] = []
        self.wall_ema: Optional[float] = None
        self.last_wall_s: Optional[float] = None
        self.migrations = 0
        self.admitted_window: Optional[int] = None
        self.makespan_s: Optional[float] = None
        self.recorder = None
        self.retired = False
        self.error: Optional[BaseException] = None
        self.worker_thread: Optional[threading.Thread] = None
        self._go = False
        self._t_admit: Optional[float] = None

    def demand_s(self) -> Optional[float]:
        """Slot-seconds of work per epoch (wall × slots) — the
        allocation-invariant cost c_j·E_j the outer solve partitions on."""
        if self.wall_ema is None or not self.devices:
            return None
        return float(self.wall_ema) * len(self.devices)


class DevicePool:
    """Exclusive ordinal→tenant allocator over one pool of slots.

    The assignment map is deliberately stored under ``self._mesh``: a pool
    re-allocation IS a topology write. Every ``_mesh`` access holds
    ``self._lock``, and every write is additionally gated by
    :meth:`_quiesce_pool` — re-allocating while any tenant is inside a
    window is a hard error, not a race."""

    def __init__(self, n_devices: int):
        if n_devices < 1:
            raise ValueError("DevicePool needs at least one device")
        self._lock = threading.RLock()
        self._quiesced = True
        self._mesh: Dict[int, Optional[str]] = {
            d: None for d in range(int(n_devices))
        }

    @property
    def n_devices(self) -> int:
        with self._lock:
            return len(self._mesh)

    def allocation(self) -> Dict[str, Tuple[int, ...]]:
        """Current tenant→ordinals view (snapshot, sorted)."""
        with self._lock:
            out: Dict[str, List[int]] = {}
            for d, owner in self._mesh.items():
                if owner is not None:
                    out.setdefault(owner, []).append(d)
            return {job: tuple(sorted(ds)) for job, ds in out.items()}

    def devices_of(self, job_id: str) -> Tuple[int, ...]:
        return self.allocation().get(job_id, ())

    def free_devices(self) -> Tuple[int, ...]:
        with self._lock:
            return tuple(sorted(d for d, o in self._mesh.items() if o is None))

    def begin_window(self) -> None:
        """Tenants are (about to be) inside a window: topology writes are
        now illegal until :meth:`end_window`."""
        with self._lock:
            self._quiesced = False

    def end_window(self) -> None:
        with self._lock:
            self._quiesced = True

    def _quiesce_pool(self) -> None:
        """Topology-write gate: a re-allocation is legal only while no
        tenant is mid-window — the scheduler loop closes the window (every
        worker thread parked at the boundary barrier) before it
        re-partitions the pool."""
        if not self._quiesced:
            raise RuntimeError(
                "DevicePool: re-allocation attempted while a window is "
                "open — pool topology writes are only legal between windows"
            )

    def reallocate(
        self, counts: Dict[str, int]
    ) -> Dict[str, Tuple[int, ...]]:
        """Re-partition the pool to ``counts`` devices per tenant with
        minimal movement: each tenant keeps as many of its current ordinals
        as its new count allows before drawing from the freed set. Tenants
        absent from ``counts`` are evicted. Returns tenant→ordinals."""
        with self._lock:
            self._quiesce_pool()
            total = sum(int(c) for c in counts.values())
            if total > len(self._mesh):
                raise ValueError(
                    f"counts sum to {total} devices but the pool has "
                    f"{len(self._mesh)}"
                )
            if any(int(c) < 0 for c in counts.values()):
                raise ValueError("device counts must be non-negative")
            current: Dict[str, List[int]] = {}
            for d, owner in self._mesh.items():
                if owner is not None:
                    current.setdefault(owner, []).append(d)
            new_mesh: Dict[int, Optional[str]] = {d: None for d in self._mesh}
            assigned: Dict[str, List[int]] = {}
            for job, want in counts.items():
                keep = sorted(current.get(job, ()))[: int(want)]
                for d in keep:
                    new_mesh[d] = job
                assigned[job] = keep
            free = iter(sorted(d for d, o in new_mesh.items() if o is None))
            for job, want in counts.items():
                while len(assigned[job]) < int(want):
                    d = next(free)
                    new_mesh[d] = job
                    assigned[job].append(d)
            self._mesh = new_mesh
            return {job: tuple(sorted(ds)) for job, ds in assigned.items()}

    def release(self, job_id: str) -> None:
        """Retire a tenant: free its ordinals (window-boundary only)."""
        with self._lock:
            self._quiesce_pool()
            self._mesh = {
                d: (None if owner == job_id else owner)
                for d, owner in self._mesh.items()
            }


class MultiStreamEngine:
    """Multiplex many :class:`JobSpec` values over one pool of slots.

    The loop is window-lockstep: per outer window the scheduler (1) admits
    arrivals (trainer construction on the tenant's stream), (2) runs the
    outer inverse-time solve and actuates any re-partition through each
    affected tenant's planned-re-shard recipe, (3) releases every live
    tenant's worker thread for exactly one inner epoch — tenants run
    concurrently on disjoint slot subsets, each on its own CUDA stream —
    and barriers on the window, (4) retires finished tenants (per-job
    artifact save mirrors the single-stream ``run()`` tail) and frees their
    slots.

    ``device`` is the card every tenant trains on (``train/engine.py``
    ``resolve_device``: CUDA unless the caller passes ``"cpu"``, and a CUDA
    request without a card raises). ``n_devices`` is the pool's slot count,
    by default the JAX meaning: the local device count (1 on the CPU).

    Hysteresis keeps steady-state re-shards honest: with unchanged
    membership a proposed re-partition only actuates when the modeled
    makespan improvement clears ``outer_margin`` AND the per-run
    ``migration_budget`` is not exhausted; membership changes (admission /
    departure) always re-partition.

    ``wall_model`` (tests): callable(JobState) → synthetic epoch wall
    seconds, replacing the measured wall exactly like the inner loop's
    ``timing_model`` replaces probe walls."""

    #: EMA weight of the newest per-epoch wall in the tenant cost track
    WALL_ALPHA = 0.5

    def __init__(
        self,
        n_devices: Optional[int] = None,
        *,
        device="cuda",
        outer_margin: float = 0.1,
        migration_budget: Optional[int] = 8,
        wall_model: Optional[Callable[[JobState], float]] = None,
        logger=None,
        log_to_file: bool = False,
    ):
        from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import resolve_device

        self.device = resolve_device(device)
        if n_devices is None:
            n_devices = torch.cuda.device_count() if self.device.type == "cuda" else 1
        self.pool = DevicePool(n_devices)
        self.outer_margin = float(outer_margin)
        self.migration_budget = migration_budget
        self.wall_model = wall_model
        self.log_to_file = log_to_file
        self.logger = logger or logging.getLogger("graft.scheduler")
        self._lock = threading.RLock()
        self._cv = threading.Condition(self._lock)
        self._jobs: Dict[str, JobState] = {}
        self._window = 0
        self._window_done = 0
        self._stop = False
        self._migrations_spent = 0
        self._membership_dirty = False
        self.windows: List[Dict] = []
        # outer decision journal: EVERY per-window allocation verdict — hold
        # or migrate — with the inputs it was decided on (epoch-wall EMAs,
        # modeled gain, migration-budget state), in the same journal shape
        # as the inner controller's so `scope_cli decisions` covers BOTH
        # nested DBS loops
        self.evals = 0
        self.actuations = 0
        self.journal: deque = deque(maxlen=JOURNAL_CAP)
        self.journal_dropped = 0
        # the scheduler's own registry view: `obs.snapshot()["scheduler"]`
        # is the outer journal's live surface, the pool twin of the inner
        # controller's `["controller"]` section
        self.obs = MetricsRegistry().attach(scheduler=self)

    # ------------------------------------------------------------ submit

    def submit(self, spec: JobSpec) -> JobState:
        if spec.config.elastic == "on":
            raise ValueError(
                "pool tenants must run with elastic=off — the pool "
                "re-allocation IS the elasticity (planned re-shards at "
                "window boundaries)"
            )
        with self._lock:
            if spec.job_id in self._jobs:
                raise ValueError(f"duplicate job id {spec.job_id!r}")
            js = JobState(spec)
            self._jobs[spec.job_id] = js
            return js

    # --------------------------------------------------------------- run

    def run(self, raise_on_failure: bool = True) -> Dict[str, JobState]:
        """Multiplex every submitted job to completion; returns the job
        table. The caller thread is the scheduler."""
        t0 = time.monotonic()
        while True:
            with self._lock:
                jobs = list(self._jobs.values())
                status = {js.spec.job_id: js.status for js in jobs}
            pending = [js for js in jobs if status[js.spec.job_id] == "pending"]
            live = [js for js in jobs if status[js.spec.job_id] == "running"]
            stale = [
                js
                for js in jobs
                if status[js.spec.job_id] in ("finishing", "failed")
                and not js.retired
            ]
            if stale:
                # boundary departures (final epoch done / failed / admitted
                # with zero epochs): retire before the next allocation
                self._retire(stale)
                continue
            if not pending and not live:
                break
            changed = self._membership_dirty
            self._membership_dirty = False
            for js in pending:
                if (
                    js.spec.arrival_window <= self._window
                    and len(live) < self.pool.n_devices
                ):
                    self._admit(js)
                    if js.status == "running":
                        live.append(js)
                    changed = True
            if not live:
                # arrivals gated on a future window — advance time
                self._window += 1
                continue
            self._solve_and_actuate(live, membership_changed=changed)
            self._run_window(live)
            self._window += 1
        self.total_wall_s = time.monotonic() - t0
        failed = [js for js in self._jobs.values() if js.status == "failed"]
        if failed and raise_on_failure:
            raise RuntimeError(
                "job(s) failed: "
                + "; ".join(f"{js.spec.job_id}: {js.error!r}" for js in failed)
            ) from failed[0].error
        return dict(self._jobs)

    # ------------------------------------------------------------ streams

    @contextlib.contextmanager
    def _tenant_stream(self, js: JobState):
        """Run the block on the tenant's stream (nothing on the CPU): after
        the work this thread queued before it, and with the thread's own
        stream waiting for the block's work afterwards."""
        if js.stream is None:
            yield
            return
        cur = torch.cuda.current_stream(self.device)
        js.stream.wait_stream(cur)
        with torch.cuda.stream(js.stream):
            yield
        cur.wait_stream(js.stream)

    # --------------------------------------------------------- admission

    def _admit(self, js: JobState) -> None:
        """Construct the tenant's trainer on its own stream at the window
        boundary and start its worker thread. Reuses the engine verbatim:
        the single-stream ``run()`` preamble is ``_maybe_warm`` followed by
        ``run_epoch`` per epoch, and that is exactly the sequence a sole
        tenant sees — the bitwise-parity contract of
        tests/test_torch_scheduler.py rides on it."""
        from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

        spec = js.spec
        get_tracer().instant(
            "job_admitted",
            cat="scheduler",
            args={"job": spec.job_id, "window": int(self._window)},
        )
        self.logger.info(
            f"scheduler: admitting job {spec.job_id!r} at window "
            f"{self._window}"
        )
        with self._lock:
            js.stream = torch.cuda.Stream(self.device) if self.device.type == "cuda" else None
        with self._tenant_stream(js):
            tr = Trainer(
                spec.config,
                bundle=spec.bundle,
                injector=spec.injector,
                timing_model=spec.timing_model,
                device=self.device,
                log_to_file=self.log_to_file,
                job_id=spec.job_id,
            )
        # warm happens in _apply_allotment, AFTER the initial allotment is
        # known, as in the JAX package (Trainer._maybe_warm: the warm
        # service's captures hold CAPTURE_GATE exclusively, as every
        # capture does); no speculation after the job's last epoch
        tr._epochs_planned = spec.total_epochs()
        thread = None
        if spec.total_epochs() > 0:
            thread = threading.Thread(
                target=self._job_worker,
                args=(js,),
                name=f"graft-job-{spec.job_id}",
                daemon=True,
            )
        with self._lock:
            js.trainer = tr
            js.status = "running" if thread is not None else "finishing"
            js.admitted_window = self._window
            js._t_admit = time.monotonic()
            js.worker_thread = thread
        if thread is not None:
            thread.start()

    # ------------------------------------------------------- outer solve

    def _outer_counts(self, live: List[JobState]) -> Dict[str, int]:
        """Slot counts per tenant from the outer inverse-time solve.

        Measured tenants go through the solver spine with RECIPROCAL epoch
        walls — ``rebalance(1/t, p, P)`` is the share update r_j ∝ p_j·t_j
        whose fixed point equalizes tenant walls (see module docstring);
        tenants without a measured wall yet (fresh admissions) are seeded
        at the median demand, the outer twin of probe-seeded readmission.
        ``quantize_batches(·, bucket=1, global_batch=P)`` snaps to integer
        counts with every tenant ≥ 1 slot and the counts summing to P;
        per-spec ``max_devices`` caps are applied last (freed slots go to
        uncapped tenants, else idle)."""
        P = self.pool.n_devices
        n = len(live)
        if n > P:
            raise RuntimeError(
                f"{n} live jobs exceed the {P}-device pool"
            )
        with self._lock:
            walls = [js.wall_ema for js in live]
            cur = [max(len(js.devices), 1) for js in live]
        if all(w is not None and w > 0 for w in walls):
            t = np.asarray(walls, dtype=np.float64)
            p = np.asarray(cur, dtype=np.float64)
            p = p / p.sum()
            new_shares, _ = rebalance(1.0 / t, p, P)
            counts = integer_batch_split(new_shares, P)
        else:
            demands = [
                js.demand_s()
                for js in live
                if js.demand_s() is not None and js.demand_s() > 0
            ]
            seed = float(np.median(demands)) if demands else 1.0
            d = np.array(
                [
                    js.demand_s() if (js.demand_s() or 0) > 0 else seed
                    for js in live
                ],
                dtype=np.float64,
            )
            counts = integer_batch_split(d / d.sum(), P)
        counts = quantize_batches(counts, 1, P)
        out = {js.spec.job_id: int(c) for js, c in zip(live, counts)}
        # per-tenant caps: clip, then hand the excess to uncapped tenants
        # (largest first); slots nobody can take stay idle
        excess = 0
        for js in live:
            cap = js.spec.max_devices
            if cap is not None and out[js.spec.job_id] > cap:
                excess += out[js.spec.job_id] - int(cap)
                out[js.spec.job_id] = int(cap)
        while excess > 0:
            takers = [
                js
                for js in live
                if js.spec.max_devices is None
                or out[js.spec.job_id] < js.spec.max_devices
            ]
            if not takers:
                break
            tgt = min(takers, key=lambda js: out[js.spec.job_id])
            out[tgt.spec.job_id] += 1
            excess -= 1
        return out

    def _record_outer_decision(
        self,
        live: List[JobState],
        proposed: Dict[str, int],
        current: Dict[str, int],
        gain: Optional[float],
        *,
        switch: bool,
        reason: str,
        outcome: str,
        membership_changed: bool,
    ) -> None:
        """Journal one outer evaluation (the many-stream twin of the inner
        controller's ``_record_decision``) and mirror it as a graftscope
        ``pool_decision`` instant. Unlike the inner journal the outcome is
        known at record time — actuation happens inline, there is no
        warm-gate veto between verdict and execution."""
        with self._lock:
            walls = {
                js.spec.job_id: (
                    round(float(js.wall_ema), 6)
                    if js.wall_ema is not None
                    else None
                )
                for js in live
            }
            spent = int(self._migrations_spent)
        ev: Dict = {
            "eval": int(self.evals),
            "switch": bool(switch),
            "reason": reason,
            "outcome": outcome,
            "window": int(self._window),
            "membership_changed": bool(membership_changed),
            "wall_emas": walls,
            "cur_counts": {k: int(v) for k, v in current.items()},
            "proposed_counts": {k: int(v) for k, v in proposed.items()},
            "modeled_gain": round(float(gain), 6) if gain is not None else None,
            "outer_margin": self.outer_margin,
            "migration_budget": self.migration_budget,
            "migrations_spent": spent,
        }
        if len(self.journal) == self.journal.maxlen:
            self.journal_dropped += 1
        self.journal.append(ev)
        tracer = get_tracer()
        if tracer.enabled:
            args = dict(ev)
            if self.journal_dropped:
                args["journal_dropped"] = self.journal_dropped
            tracer.instant("pool_decision", cat="decision", args=args)

    def decision_journal(self) -> List[Dict]:
        """The outer journal as a JSON-safe list (oldest first)."""
        return [dict(ev) for ev in self.journal]

    def _solve_and_actuate(
        self, live: List[JobState], membership_changed: bool
    ) -> None:
        proposed = self._outer_counts(live)
        with self._lock:
            current = {js.spec.job_id: len(js.devices) for js in live}
        gain = self._modeled_gain(live, proposed)
        self.evals += 1
        record = lambda **kw: self._record_outer_decision(  # noqa: E731
            live, proposed, current, gain,
            membership_changed=membership_changed, **kw
        )
        if proposed == current:
            record(switch=False, reason="same-counts", outcome="hold")
            return
        if not membership_changed:
            if (
                self.migration_budget is not None
                and self._migrations_spent >= self.migration_budget
            ):
                record(
                    switch=False, reason="budget-exhausted", outcome="hold"
                )
                return
            if gain is None:
                # an unmeasured tenant means the gain model has no wall to
                # stand on: only membership changes may actuate
                record(
                    switch=False, reason="unmeasured-hold", outcome="hold"
                )
                return
            if gain <= self.outer_margin:
                record(switch=False, reason="below-margin", outcome="hold")
                return
        assigned = self.pool.reallocate(proposed)
        self.actuations += 1
        record(
            switch=True,
            reason="membership" if membership_changed else "migrate",
            outcome="committed",
        )
        get_tracer().instant(
            "pool_repartition",
            cat="scheduler",
            args={
                "window": int(self._window),
                "counts": {k: int(v) for k, v in proposed.items()},
            },
        )
        for js in live:
            self._apply_allotment(js, assigned[js.spec.job_id])

    def _modeled_gain(
        self, live: List[JobState], proposed: Dict[str, int]
    ) -> Optional[float]:
        """Relative drop of the modeled worst tenant wall under the
        proposed counts (demand_j / d_j wall model) — None when any tenant
        is unmeasured (then only membership changes actuate)."""
        with self._lock:
            demands = {js.spec.job_id: js.demand_s() for js in live}
            cur = {js.spec.job_id: max(len(js.devices), 1) for js in live}
        if any(d is None or d <= 0 for d in demands.values()):
            return None
        now = max(demands[j] / cur[j] for j in demands)
        then = max(demands[j] / max(proposed[j], 1) for j in demands)
        if now <= 0:
            return None
        return 1.0 - then / now

    # --------------------------------------------------------- actuation

    def _ranks_on(self, js: JobState, ordinals: Tuple[int, ...]) -> List[int]:
        """The job-config ranks living on the allotted pool slots
        (:attr:`JobSpec.slots`, or rank r on slot ``r % P``)."""
        cfg = js.trainer.cfg
        slots = js.spec.slots
        if slots is None:
            slots = [r % self.pool.n_devices for r in range(cfg.world_size)]
        active = [r for r in range(cfg.world_size) if slots[r] in set(ordinals)]
        if not active:
            raise RuntimeError(
                f"job {js.spec.job_id!r}: no worker of its config maps onto "
                f"allotted devices {list(ordinals)}"
            )
        return active

    def _apply_allotment(
        self, js: JobState, ordinals: Tuple[int, ...]
    ) -> None:
        """Point a tenant at its new slot subset — the planned-re-shard
        recipe of the engine's epoch-boundary readmission (``state → host →
        _reshard_world → state in place``, comm-residual fix, cost-anchor
        carry, re-warm), applied to a POOL decision instead of a fault, on
        the tenant's stream."""
        tr = js.trainer
        new_active = self._ranks_on(js, ordinals)
        with self._tenant_stream(js):
            if sorted(tr.active_ranks) == new_active:
                # allotment covers the tenant's whole footprint: the trainer
                # is untouched (the single-tenant bitwise-parity contract),
                # only warmed — the exact `run()` preamble sequence
                tr._maybe_warm()
                with self._lock:
                    js.devices = tuple(sorted(ordinals))
                return
            t0 = time.monotonic()
            with get_tracer().span("pool_reshard", cat="recover"):
                host_state = tr._state_to_host()
                prev_active = list(tr.active_ranks)
                prev_cost = tr.per_example_cost.copy()
                retry_transient(
                    lambda: tr._reshard_world(new_active),
                    logger=self.logger,
                    desc=f"pool re-shard ({js.spec.job_id})",
                )
                retry_transient(
                    lambda: tr._state_from_host(host_state),
                    logger=self.logger,
                    desc=f"state re-placement ({js.spec.job_id})",
                )
                tr._fix_comm_residual()
                tr._sync()
                # carry survivors' cost anchors to their compact slots; fill
                # newly-activated ranks from the survivor mean (the
                # readmission recipe's fallback — the next measured epoch
                # re-anchors them)
                cost = np.full(tr.world_size, np.nan)
                for i, r in enumerate(tr.active_ranks):
                    if r in prev_active:
                        cost[i] = prev_cost[prev_active.index(r)]
                if np.isfinite(prev_cost).any():
                    cost = np.where(
                        np.isfinite(cost), cost, float(np.nanmean(prev_cost))
                    )
                if np.isfinite(cost).all() and (cost > 0).all():
                    tr.per_example_cost = cost
                    tr.shares = equilibrium_shares(cost)
                    tr.node_times = np.maximum(cost * tr.shares, 1e-9)
                else:
                    tr.shares = initial_partition(tr.world_size)
                    tr.node_times = np.ones(tr.world_size, dtype=np.float64)
                # re-warm against the new world at the boundary
                tr._maybe_warm()
            dt = time.monotonic() - t0
        with self._lock:
            had = bool(js.devices)
            js.devices = tuple(sorted(ordinals))
            if had:
                js.migrations += 1
                self._migrations_spent += 1
        self.logger.info(
            f"scheduler: job {js.spec.job_id!r} -> devices "
            f"{sorted(ordinals)} ({len(new_active)} active ranks, "
            f"{dt:.3f}s re-shard)"
        )

    # ------------------------------------------------------ window drive

    def _run_window(self, live: List[JobState]) -> None:
        self.pool.begin_window()
        t0 = time.monotonic()
        with self._lock:
            self._window_done = 0
            for js in live:
                js._go = True
            self._cv.notify_all()
            while self._window_done < len(live):
                self._cv.wait()
        wall = time.monotonic() - t0
        self.pool.end_window()
        with self._lock:
            rec = {
                "window": int(self._window),
                "wall_s": float(wall),
                "jobs": {
                    js.spec.job_id: {
                        "devices": len(js.devices),
                        "epoch_wall_s": js.last_wall_s,
                        "epochs_done": js.epochs_done,
                        "status": js.status,
                    }
                    for js in live
                },
            }
        self.windows.append(rec)

    def _job_worker(self, js: JobState) -> None:
        """Per-tenant worker thread: park at the boundary barrier, run ONE
        inner epoch per released window on the tenant's stream, report the
        measured wall. The epoch runs under the tenant's graftscope job
        tag, so every span it emits attributes to this tenant
        (``scope_cli summarize --by-job``)."""
        tracer = get_tracer()
        tracer.set_job(js.spec.job_id)
        try:
            with self._tenant_stream(js):
                while True:
                    with self._lock:
                        while not js._go and not self._stop:
                            self._cv.wait()
                        if self._stop:
                            break
                        js._go = False
                        epoch = js.epochs_done
                        trainer = js.trainer
                    t0 = time.monotonic()
                    err: Optional[BaseException] = None
                    try:
                        # shared: another tenant's step-graph capture waits
                        # for this epoch, and this epoch's for the others'
                        with CAPTURE_GATE.shared():
                            trainer.run_epoch(epoch)
                    except BaseException as e:  # noqa: BLE001 — reported, re-raised at run()
                        err = e
                    wall = time.monotonic() - t0
                    with self._lock:
                        if err is not None:
                            js.status = "failed"
                            js.error = err
                        else:
                            js.epochs_done += 1
                            w = (
                                float(self.wall_model(js))
                                if self.wall_model is not None
                                else wall
                            )
                            js.last_wall_s = w
                            js.epoch_walls.append(w)
                            js.wall_ema = (
                                w
                                if js.wall_ema is None
                                else self.WALL_ALPHA * w
                                + (1.0 - self.WALL_ALPHA) * js.wall_ema
                            )
                            if js.epochs_done >= js.spec.total_epochs():
                                js.status = "finishing"
                        self._window_done += 1
                        self._cv.notify_all()
                        if js.status != "running":
                            break
        finally:
            tracer.set_job(None)

    # -------------------------------------------------------- retirement

    def _retire(self, live: List[JobState]) -> None:
        for js in live:
            with self._lock:
                st = js.status
                if st == "running" or js.retired:
                    continue
                js.retired = True
            if js.worker_thread is not None:
                js.worker_thread.join(timeout=60.0)
            if st == "finishing":
                self._finalize(js)
                with self._lock:
                    js.status = "done"
            self.pool.release(js.spec.job_id)
            with self._lock:
                js.devices = ()
                self._membership_dirty = True
            get_tracer().instant(
                "job_retired",
                cat="scheduler",
                args={
                    "job": js.spec.job_id,
                    "window": int(self._window),
                    "status": js.status,
                },
            )
            self.logger.info(
                f"scheduler: job {js.spec.job_id!r} retired "
                f"({js.status}, {js.epochs_done} epochs)"
            )

    def _finalize(self, js: JobState) -> None:
        """The single-stream ``run()`` tail, per tenant, on its stream:
        save the metrics artifact (proc 0) and the graftscope trace."""
        tr = js.trainer
        with self._lock:
            js.makespan_s = time.monotonic() - js._t_admit
            js.recorder = tr.recorder
        with self._tenant_stream(js):
            if tr.proc_id == 0:
                tr.recorder.save(tr.cfg.stat_dir, tr.cfg.base_filename())
            tr.save_trace()

    # ------------------------------------------------------------- stats

    def stats(self) -> Dict:
        """Aggregate pool utilization + per-tenant summary: window count,
        total scheduler wall, the idle share of the pool's SLOTS
        (``device_idle_fraction``: 1 − busy slot-seconds / pool capacity
        over the windows; on one card the slots share it, so this is not
        the card's idle share), per-job makespan and migration counts — the
        quantities the JAX package's multistream A/B reports."""
        cap = 0.0
        busy = 0.0
        for w in self.windows:
            cap += self.pool.n_devices * w["wall_s"]
            for j in w["jobs"].values():
                if j["epoch_wall_s"] is not None:
                    busy += j["devices"] * j["epoch_wall_s"]
        with self._lock:
            jobs = {
                js.spec.job_id: {
                    "status": js.status,
                    "epochs": js.epochs_done,
                    "makespan_s": js.makespan_s,
                    "migrations": js.migrations,
                    "mean_epoch_wall_s": (
                        float(np.mean(js.epoch_walls))
                        if js.epoch_walls
                        else None
                    ),
                }
                for js in self._jobs.values()
            }
        return {
            "windows": len(self.windows),
            "pool_devices": self.pool.n_devices,
            "window_wall_s": float(sum(w["wall_s"] for w in self.windows)),
            "device_idle_fraction": (
                float(1.0 - busy / cap) if cap > 0 else None
            ),
            "migrations": self._migrations_spent,
            "jobs": jobs,
        }

    def snapshot(self, include_journal: bool = False) -> Dict:
        """JSON-safe outer-controller observability, shaped like the inner
        controller's ``snapshot()`` (registry ``scheduler`` section)."""
        out = {
            "evals": self.evals,
            "actuations": self.actuations,
            "migrations_spent": int(self._migrations_spent),
            "migration_budget": self.migration_budget,
            "outer_margin": self.outer_margin,
            "pool_devices": self.pool.n_devices,
            "decisions": len(self.journal),
            "journal_dropped": self.journal_dropped,
            "last_decision": dict(self.journal[-1]) if self.journal else None,
        }
        if include_journal:
            out["journal"] = self.decision_journal()
        return out
