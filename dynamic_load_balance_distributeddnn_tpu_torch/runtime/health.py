"""Per-worker health: liveness and latency verdicts, and retries of
transient failures (the JAX package's ``runtime/health.py``, copied).

``--elastic on`` needs per-*logical*-worker verdicts the engine can act on
without dying: on a preemptible fleet a lost worker is the common case. The
DBS solver already routes data away from a slow worker; this module decides
that a worker is slow, suspect or gone, so the engine can run the same
re-solve over a changed fleet (``train/engine.py`` ``_recover``).

Three surfaces:

* :class:`WorkerHealth`, the verdict machine. The engine feeds it per-worker
  probe walls (``observe_latency``) and the preemption injector's outcomes
  (``report_alive`` / ``report_miss``). ``detect_misses`` consecutive misses
  confirm a loss (one missed signal is indistinguishable from jitter); a
  lost worker that signals again becomes ``RECOVERING`` and is readmitted
  at the next epoch boundary.
* :class:`ProcessHeartbeat`, heartbeat-file liveness for real processes:
  each process runs a beacon thread touching its own file, and anyone can
  ``scan`` the directory for stale peers. It reads the exit-reason tag a
  stall watchdog leaves behind (:func:`read_exit_reason`). Only the elastic
  tier across processes uses it, and this port runs that tier not yet.
* :func:`retry_transient`, bounded exponential backoff for the edges that
  can fail transiently while the fleet changes shape.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional

import numpy as np

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer

# The stall watchdog's exit tag (the JAX package's ``runtime/watchdog.py``):
# a process that aborts writes it into its heartbeat file.
_EXIT_TAG = "DBS_WATCHDOG_EXIT "

# Verdicts. Plain strings (not an Enum) so snapshots stay JSON-trivial.
ALIVE = "alive"
SUSPECT = "suspect"
LOST = "lost"
RECOVERING = "recovering"


def _verdict_event(worker: int, verdict: str, **extra) -> None:
    """Flight-recorder instant for a health-verdict transition:
    emitted only when a worker's verdict changes, so the fleet timeline
    shows the detection edges, not the per-window liveness chatter. One
    attribute check when tracing is off."""
    tracer = get_tracer()
    if not tracer.enabled:
        return
    args = {"worker": int(worker), "verdict": verdict}
    args.update(extra)
    tracer.instant("health_verdict", cat="health", args=args)


def read_exit_reason(hb_path: str) -> Optional[str]:
    """The exit-reason tag a stall watchdog left in ``hb_path``, or None
    (absent file, unreadable file, or a plain pulse file with no tag)."""
    try:
        with open(hb_path) as f:
            head = f.read(4096)
    except OSError:
        return None
    if head.startswith(_EXIT_TAG):
        return head[len(_EXIT_TAG):].strip()
    return None


class WorkerLost(RuntimeError):
    """Raised by the engine's health checks when worker loss is CONFIRMED
    (``detect_misses`` consecutive misses). Carries the lost ranks; the
    run loop catches it and enters the drain → re-solve → re-shard path."""

    def __init__(self, ranks: Iterable[int], message: str = ""):
        self.ranks = sorted(int(r) for r in ranks)
        super().__init__(
            message or f"worker(s) {self.ranks} confirmed lost"
        )


class WorkerHealth:
    """Per-worker liveness/latency verdict machine.

    ``detect_misses``: consecutive missed signals that confirm a loss.
    ``latency_factor``: a worker whose probe latency exceeds this multiple
    of the fleet median is marked SUSPECT — informational (the solver
    already absorbs slow workers by re-routing data; suspicion is the
    observable that says the degradation ladder's next rung is near).

    Not thread-safe by default writes; the engine drives it from the
    controller thread. ``scan`` integration for real processes goes through
    :class:`ProcessHeartbeat`, which IS thread-safe (beacon thread).
    """

    def __init__(
        self,
        world_size: int,
        detect_misses: int = 2,
        latency_factor: float = 8.0,
        logger=None,
    ):
        if world_size < 1:
            raise ValueError("world_size must be >= 1")
        if detect_misses < 1:
            raise ValueError("detect_misses must be >= 1")
        self.world_size = int(world_size)
        self.detect_misses = int(detect_misses)
        self.latency_factor = float(latency_factor)
        self.logger = logger
        self._status: List[str] = [ALIVE] * world_size
        self._misses = np.zeros(world_size, dtype=np.int64)
        self._latency = np.full(world_size, np.nan)  # EMA of probe walls
        # latency-derived suspicion is cleared only by a latency observation
        # back under threshold — NOT by a mere liveness signal (the engine's
        # per-window report_alive would otherwise erase the verdict within
        # one window and elastic_latency_factor would be observably inert)
        self._lat_suspect = [False] * world_size

    # ------------------------------------------------------------- signals

    def observe_latency(self, worker: int, seconds: float) -> None:
        """A measured per-worker probe wall: evidence of life, and the
        latency track behind the SUSPECT verdict."""
        w = int(worker)
        self.report_alive(w)
        prev = self._latency[w]
        self._latency[w] = (
            seconds if np.isnan(prev) else 0.5 * prev + 0.5 * seconds
        )
        med = float(np.nanmedian(self._latency))
        if med > 0 and np.isfinite(med) and self._latency[w] > self.latency_factor * med:
            if self._status[w] == ALIVE:
                self._status[w] = SUSPECT
                if self.logger:
                    self.logger.warning(
                        f"health: worker {w} latency {self._latency[w]:.3f}s "
                        f"is >{self.latency_factor:.0f}x the fleet median "
                        f"{med:.3f}s — SUSPECT (solver re-route territory)"
                    )
                _verdict_event(
                    w, SUSPECT, cause="latency",
                    latency_s=round(float(self._latency[w]), 6),
                    fleet_median_s=round(med, 6),
                )
            self._lat_suspect[w] = True
        elif self._lat_suspect[w]:
            # measured back under threshold: the latency verdict lifts
            self._lat_suspect[w] = False
            if self._status[w] == SUSPECT:
                self._status[w] = ALIVE
                _verdict_event(w, ALIVE, cause="latency-cleared")

    def report_alive(self, worker: int) -> None:
        """Any positive liveness signal. A LOST worker signalling again
        becomes RECOVERING (readmitted by the engine at an epoch boundary,
        never mid-epoch — plans are immutable within an epoch)."""
        w = int(worker)
        self._misses[w] = 0
        if self._status[w] == LOST:
            self._status[w] = RECOVERING
            if self.logger:
                self.logger.info(f"health: worker {w} signalling again — RECOVERING")
            _verdict_event(w, RECOVERING)
        elif self._status[w] == SUSPECT and not self._lat_suspect[w]:
            # miss-derived suspicion clears on any liveness signal;
            # latency-derived suspicion only clears via observe_latency
            self._status[w] = ALIVE
            _verdict_event(w, ALIVE, cause="signal")

    def report_miss(self, worker: int) -> bool:
        """One missed liveness signal. Returns True when this miss CONFIRMS
        the loss (crossed ``detect_misses``)."""
        w = int(worker)
        if self._status[w] == LOST:
            return False
        self._misses[w] += 1
        if self._misses[w] >= self.detect_misses:
            self._status[w] = LOST
            if self.logger:
                self.logger.warning(
                    f"health: worker {w} missed {int(self._misses[w])} "
                    "consecutive liveness checks — LOST"
                )
            _verdict_event(
                w, LOST, cause="misses", misses=int(self._misses[w])
            )
            return True
        if self._status[w] == ALIVE:
            self._status[w] = SUSPECT
            _verdict_event(w, SUSPECT, cause="miss")
        return False

    def mark_down(self, worker: int) -> None:
        """Administrative removal (the engine dropped the worker from the
        active fleet): further misses are expected and not news."""
        if self._status[int(worker)] != LOST:
            _verdict_event(int(worker), LOST, cause="mark_down")
        self._status[int(worker)] = LOST
        self._misses[int(worker)] = self.detect_misses

    def readmit(self, worker: int) -> None:
        """The engine re-added the worker to the active fleet."""
        w = int(worker)
        if self._status[w] != ALIVE:
            _verdict_event(w, ALIVE, cause="readmit")
        self._status[w] = ALIVE
        self._misses[w] = 0
        self._latency[w] = np.nan  # stale latency track: re-anchor on probes
        self._lat_suspect[w] = False

    # ------------------------------------------------------------ verdicts

    def status(self, worker: int) -> str:
        return self._status[int(worker)]

    def lost(self) -> List[int]:
        return [r for r, s in enumerate(self._status) if s == LOST]

    def recovering(self) -> List[int]:
        return [r for r, s in enumerate(self._status) if s == RECOVERING]

    def alive_count(self) -> int:
        return sum(1 for s in self._status if s in (ALIVE, SUSPECT))

    def snapshot(self) -> Dict:
        """JSON-safe view (MetricsRegistry surface)."""
        return {
            "status": list(self._status),
            "misses": [int(m) for m in self._misses],
            "latency_s": [
                None if np.isnan(v) else round(float(v), 6)
                for v in self._latency
            ],
            "alive": self.alive_count(),
        }


class ProcessHeartbeat:
    """Heartbeat-file liveness for real OS processes (multi-host tier).

    ``beacon(dir, ident)`` starts a daemon thread touching
    ``<dir>/<ident>.hb`` every ``period_s`` — process-level liveness (a
    SIGSTOPped or dead process stops all its threads, so the file goes
    stale). ``scan(dir)`` returns every peer's staleness age plus any
    exit-reason tag the stall watchdog wrote before aborting
    (runtime/watchdog.py) — a peer that hard-exited is distinguishable from
    one that silently froze.
    """

    SUFFIX = ".hb"

    def __init__(self, period_s: float = 1.0):
        self.period_s = float(period_s)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beacon(self, hb_dir: str, ident: str) -> str:
        """Start touching ``<hb_dir>/<ident>.hb``; returns the path."""
        os.makedirs(hb_dir, exist_ok=True)
        path = os.path.join(hb_dir, f"{ident}{self.SUFFIX}")
        with open(path, "a"):
            pass

        def _beat() -> None:
            while not self._stop.wait(self.period_s):
                try:
                    os.utime(path, None)
                except OSError:
                    pass

        self._thread = threading.Thread(
            target=_beat, daemon=True, name=f"hb-beacon-{ident}"
        )
        self._thread.start()
        return path

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.period_s)

    def watch(
        self,
        hb_dir: str,
        idents: Iterable[str],
        stale_s: float,
        on_stale: Callable[[str, Dict], None],
    ) -> threading.Thread:
        """Daemon scanner: polls ``scan(hb_dir)`` every ``period_s`` and
        fires ``on_stale(ident, info)`` ONCE per watched ident whose pulse
        goes stale (or that left a watchdog exit-reason tag). Runs on its
        own thread because the interesting case is precisely when the main
        thread is wedged in a collective against the dead peer."""
        idents = list(idents)
        fired: set = set()

        def _watch() -> None:
            while not self._stop.wait(self.period_s):
                found = self.scan(hb_dir)
                for ident in idents:
                    if ident in fired:
                        continue
                    info = found.get(ident)
                    if info is None:
                        continue
                    if self.is_stale(info, stale_s):
                        fired.add(ident)
                        try:
                            on_stale(ident, info)
                        except Exception:  # noqa: BLE001 — detection must outlive a bad callback
                            pass

        t = threading.Thread(target=_watch, daemon=True, name="hb-watch")
        t.start()
        return t

    @staticmethod
    def is_stale(info: Dict, stale_s: float) -> bool:
        """THE unreachable-peer verdict — one predicate shared by the
        watcher thread and the engine's window-boundary scan, so detection
        semantics cannot diverge between them: a pulse older than
        ``stale_s``, or any watchdog exit-reason tag (an aborted peer is
        unreachable no matter how fresh the tag write left the mtime)."""
        return info["age_s"] > stale_s or bool(info["exit_reason"])

    @staticmethod
    def stale_reason(info: Dict) -> str:
        return info["exit_reason"] or f"stale {info['age_s']:.1f}s"

    @classmethod
    def scan(cls, hb_dir: str) -> Dict[str, Dict]:
        """``{ident: {age_s, exit_reason}}`` for every heartbeat file in
        ``hb_dir``. ``exit_reason`` is the watchdog's tag (None for a file
        that is a plain mtime pulse)."""
        out: Dict[str, Dict] = {}
        try:
            names = os.listdir(hb_dir)
        except OSError:
            return out
        now = time.time()
        for name in names:
            if not name.endswith(cls.SUFFIX):
                continue
            path = os.path.join(hb_dir, name)
            try:
                age = now - os.path.getmtime(path)
            except OSError:
                continue
            out[name[: -len(cls.SUFFIX)]] = {
                "age_s": age,
                "exit_reason": read_exit_reason(path),
            }
        return out


def retry_transient(
    fn: Callable,
    *,
    retries: int = 3,
    base_s: float = 0.05,
    max_s: float = 2.0,
    logger=None,
    desc: str = "",
    tick: Optional[Callable] = None,
) -> object:
    """Run ``fn()`` with bounded exponential backoff on transient failure.

    The collective/compile edges of a fleet change can fail once and succeed
    on retry (a re-shard racing a dying runtime's teardown, a compile RPC
    interrupted by the same preemption that killed the worker). Backoff
    doubles from ``base_s`` up to ``max_s``; ``tick`` (the watchdog's
    ``heartbeat``) is called between attempts so a retry loop never reads as
    a stall. The LAST failure re-raises — retries armor transience, they
    must not convert a real error into silence."""
    attempt = 0
    while True:
        try:
            return fn()
        except Exception as e:  # noqa: BLE001 — transient surface is broad
            attempt += 1
            if attempt > retries:
                raise
            delay = min(base_s * (2 ** (attempt - 1)), max_s)
            if logger:
                logger.warning(
                    f"transient failure{f' in {desc}' if desc else ''} "
                    f"(attempt {attempt}/{retries}): {e!r} — retrying in "
                    f"{delay:.2f}s"
                )
            if tick is not None:
                tick()
            time.sleep(delay)
