"""Epoch-boundary re-rendezvous over the surviving processes (the JAX
package's ``runtime/rendezvous.py``, its host code copied and its runtime
code rewritten for ``torch.distributed``).

When a peer *process* of an ``--elastic on`` run is confirmed gone, the
survivors reach consensus on the survivor roster through the heartbeat-file
directory (propose -> agree), tear down the ``torch.distributed`` world and
bring up a smaller one on a fresh ``TCPStore`` (barrier -> establish). The
engine (``train/engine.py`` ``_mh_rerendezvous``) then rebuilds the data
axis, the combine and the step graphs over the survivors and re-runs the
interrupted epoch from the flushed checkpoint. A respawned process offers to
join and the fleet grows back the same way (:func:`join_elastic_world`).

**Copied as host code**, letter for letter where the protocol is concerned:
:class:`Agreement`, :class:`RendezvousError`, :class:`RendezvousTimeout`,
:func:`rendezvous_timeout_s` (``DBS_RDZV_TIMEOUT_S``), the :data:`PROTOCOL`
table, :func:`_write_json`, :func:`_read_json`, :func:`_pick_port`,
:func:`reset_rendezvous_dir`, the whole :class:`RendezvousStateMachine` but
the runtime half of ``establish``, and :func:`join_elastic_world`. The
protocol files, their names and the ``rdzv_*`` trace instants are the JAX
package's, so ``graftscope postmortem`` merges the spools of both packages'
runs alike.

**Rewritten for torch.distributed** (the JAX package drives XLA's
coordination service):

* :func:`elastic_initialize` brings up generation 0: process 0 hosts the
  ``TCPStore`` and, after :func:`reset_rendezvous_dir`, is the only writer of
  ``ack_g0.json``; every process then joins a gloo default group whose
  timeout is :func:`rendezvous_timeout_s`, so a collective against a frozen
  (SIGSTOPped) peer raises within that bound instead of the stock 600 s.
* :func:`retire_runtime` drops the live world: the data axis's subgroups,
  its NCCL gradient group and its pinned staging buffers
  (``DataMesh.retire``), then the default group (``destroy_process_group``,
  in a side thread bounded by the rendezvous timeout: a teardown that hangs
  raises :class:`RendezvousTimeout` instead of wedging the survivor). The
  retired group and store objects are held in :data:`_RETIRED`, as the JAX
  package leaks its retired clients: a peer still tearing down its own side
  never sees the store it dialled vanish.
* ``RendezvousStateMachine.establish``: the leader opens a ``TCPStore`` on
  the port it proposed (:func:`_pick_port`) and publishes the address in
  ``ack_g{gen}.json``; every member of the roster then calls
  ``init_process_group`` with ``rank=agreement.rank`` and ``world_size=
  len(roster)``.
* :func:`drain_collective_chain`: a gloo collective is synchronous, so a
  failed one leaves nothing in flight on the host; what can still be in
  flight is the rank's CUDA stream (the staging copies of a collective that
  died between the device-to-pinned copy and the copy back). The drain is a
  ``torch.cuda.synchronize`` of the rank's device in a side thread, bounded.
* :func:`quarantine_runtime` / :func:`local_canary_launch`: one local kernel
  launch, synchronized and checked, proves the CUDA context survived the
  failed collective before the new world trains on it. A CUDA context that
  took a sticky error cannot be rebuilt in-process, so the quarantine fails
  the rendezvous instead of retrying.
* ``reset_backend`` has no counterpart: torch keeps no process-wide backend
  cache keyed by the world shape; ``destroy_process_group`` forgets the old
  world and the next ``init_process_group`` reads the new one.
* ``_reset_orbax_barrier_counters`` has none: the port's checkpoints are
  plain files (``train/checkpoint.py``) with no barrier keys.

Coordinator death stays a non-goal, as in the JAX package: the generation-0
process 0 is the leader of every roster (the lowest surviving ident), and a
run whose process 0 dies is aborted and resumed from its checkpoint.

Every blocking phase is armored: bounded timeouts raise
:class:`RendezvousTimeout` tagged with the phase that died (the engine
degrades to abort-and-resume, ``_mh_rdzv_failed``), and the wait loops tick
the stall watchdog so a slow rendezvous never reads as a device hang.
"""

from __future__ import annotations

import dataclasses
import datetime
import glob
import json
import os
import re
import socket
import threading
import time
from typing import Callable, Dict, Iterable, List, Optional, Set, Tuple

import torch
import torch.distributed as dist

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import retry_transient
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.watchdog import heartbeat

# Retired runtime objects (the default groups and stores of previous fleet
# generations), held rather than freed: see the module docstring. Bounded:
# one group and one store per recovery, and recoveries are budgeted
# (cfg.elastic_max_recoveries).
_RETIRED: List[object] = []
# The live world this module brought up: its store (held so the server
# outlives the group on the leader) and whether it is an elastic one
_WORLD: Dict[str, object] = {"store": None, "elastic": False}

_POLL_S = 0.05
_TICK_EVERY_S = 1.0


def _env_timeout(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def rendezvous_timeout_s() -> float:
    """Per-phase rendezvous timeout (env ``DBS_RDZV_TIMEOUT_S``)."""
    return _env_timeout("DBS_RDZV_TIMEOUT_S", 120.0)


class RendezvousError(RuntimeError):
    """Rendezvous failed; ``phase`` names the phase that died. The engine
    degrades to the abort-and-resume ladder instead of hanging."""

    def __init__(self, phase: str, message: str = ""):
        self.phase = phase
        super().__init__(message or f"rendezvous failed in phase '{phase}'")


class RendezvousTimeout(RendezvousError):
    """A blocking rendezvous phase exceeded its hard timeout."""


@dataclasses.dataclass(frozen=True)
class Agreement:
    """The consensus a survivor set reached: who survives, which generation
    this is, where the new coordinator listens, and which epoch training
    resumes at."""

    gen: int
    roster: Tuple[int, ...]  # ORIGINAL process ids, sorted
    rank: int                # my process id in the NEW world
    address: str
    epoch: int

    @property
    def leader(self) -> bool:
        return self.rank == 0


# --------------------------------------------------------------------------
# Machine-readable protocol annotation (graftrdzv).
#
# This table IS the rendezvous automaton, declared next to the code that
# implements it. It must stay a PURE literal: `analysis/flow/proto.py`
# loads it with `ast.literal_eval` (no runtime import, no jax), extracts
# the same facts from the IR, and cross-checks the two — a writer added
# below without a row here (or vice versa) is a lint finding, not a code
# review hope. The small-scope model checker and the `graftscope
# conformance` replay both interpret this table, so the file-name
# patterns, phases and instants below are load-bearing, not documentation.
#
# File-name patterns use `{hole}` for interpolated fields; `proto.py`
# matches them against both the IR's f-string skeletons and real
# directory listings / trace payloads.
PROTOCOL = {
    "version": 1,
    # attribute/parameter tokens that name the shared protocol directory
    "dir_tokens": ("rdzv_dir", "hb_dir", "heartbeat_dir"),
    # every JSON protocol write goes through this atomic tmp+replace
    # helper; every JSON protocol read through this tolerant reader
    "atomic_writer": "_write_json",
    "tolerant_reader": "_read_json",
    # stale-state wipe at gen-0 bring-up (coordinator only, BEFORE ack_g0)
    "wipe": "reset_rendezvous_dir",
    # protocol files: name pattern, payload format, sanctioned writers
    # (qualnames local to this module), and what readers must tolerate
    "files": {
        "ack": {
            "pattern": "ack_g{gen}.json",
            "format": "json",
            "writers": ("elastic_initialize", "RendezvousStateMachine.establish"),
            "tolerate": "missing-or-torn",
        },
        "propose": {
            "pattern": "propose_g{gen}_r{rnd}_p{ident}.json",
            "format": "json",
            "writers": ("RendezvousStateMachine.agree",),
            "tolerate": "missing-or-torn",
        },
        "torn": {
            "pattern": "torn_g{gen}_p{ident}",
            "format": "marker",
            "writers": ("RendezvousStateMachine.establish",),
            "tolerate": "missing",
        },
        "loss": {
            "pattern": "loss_g{gen}_p{ident}.json",
            "format": "json",
            "writers": ("RendezvousStateMachine.claim_loss",),
            "tolerate": "missing-or-torn",
        },
        "join": {
            "pattern": "join_p{ident}.json",
            "format": "json",
            "writers": ("RendezvousStateMachine.offer_join",),
            "tolerate": "missing-or-torn",
        },
        "probe": {
            "pattern": "probe_g{gen}_p{ident}.json",
            "format": "json",
            "writers": ("RendezvousStateMachine.publish_probe",),
            "tolerate": "missing-or-torn",
        },
        "rebuild": {
            "pattern": "rebuild_g{gen}_a{attempt}_p{ident}.json",
            "format": "json",
            "writers": ("RendezvousStateMachine.rebuild_vote",),
            "tolerate": "missing-or-torn",
        },
        "done": {
            "pattern": "done_p{ident}",
            "format": "marker",
            "writers": ("RendezvousStateMachine.finalize",),
            "tolerate": "missing",
        },
    },
    # per-process phase automaton; a recovery walks these edges in order
    "phases": ("running", "agree", "teardown", "establish", "established"),
    "edges": (
        ("running", "agree", "detect-or-join"),
        ("agree", "teardown", "rdzv_agreed"),
        ("teardown", "establish", "rdzv_torn"),
        ("establish", "established", "rdzv_established"),
        ("established", "running", "resume"),
    ),
    # flight-recorder instants -> the phase that emits them ("*" = any)
    "instants": {
        "rdzv_init": "established",
        "rdzv_offer_join": "running",
        "rdzv_claim_loss": "running",
        "rdzv_agreed": "agree",
        "rdzv_torn": "teardown",
        "rdzv_established": "established",
        "rdzv_timeout": "*",
        "rdzv_drain_timeout": "teardown",
        "rdzv_quarantine_rebuild": "establish",
        "rdzv_rebuild_vote": "establish",
    },
    # engine recovery spine: callee tail -> phase index. G018 checks that
    # recovery paths never call a lower phase after a higher one
    # (flush -> agree -> drain/retire -> establish -> reshard -> restore).
    "recovery_order": {
        "flush_checkpoints": 0,
        "agree": 1,
        "drain_collective_chain": 2,
        "retire_runtime": 2,
        "establish": 3,
        "_reshard_world": 4,
        "_state_from_host": 5,
    },
    # tails that mark a function as a recovery path at all (the G018 gate:
    # ordering is only checked where the rendezvous spine is in play)
    "recovery_core": ("flush_checkpoints", "retire_runtime", "establish",
                      "_reshard_world"),
}


def _write_json(path: str, obj: Dict) -> None:
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)  # atomic: readers never see a partial file


def _read_json(path: str) -> Optional[Dict]:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _pick_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def elastic_world() -> bool:
    """Whether the live process group was brought up by this module
    (:func:`elastic_initialize` or an ``establish``): only such a world has
    the rendezvous channel a lost peer is survived through. A world made by
    ``parallel/mesh.py`` ``initialize_multihost`` (the cli's) detects a
    loss and aborts."""
    return bool(_WORLD["elastic"]) and dist.is_available() and dist.is_initialized()


def _make_store(address: str, world_size: int, is_master: bool, timeout_s: float):
    """A ``TCPStore`` at ``host:port``: the server on the leader, a client
    (connecting within ``timeout_s``) on the others."""
    host, port = address.rsplit(":", 1)
    return dist.TCPStore(host, int(port), int(world_size), is_master,
                         timeout=datetime.timedelta(seconds=max(timeout_s, 1.0)),
                         wait_for_workers=False)


def _init_world(store, rank: int, world_size: int, timeout_s: float) -> None:
    """The default gloo group over ``store``, its collectives bounded by
    ``timeout_s``; the group's store is held in :data:`_WORLD`."""
    dist.init_process_group("gloo", store=store, rank=int(rank), world_size=int(world_size),
                            timeout=datetime.timedelta(seconds=max(timeout_s, 1.0)))
    _WORLD["store"], _WORLD["elastic"] = store, True


def elastic_initialize(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    rdzv_dir: Optional[str] = None,
    timeout_s: Optional[float] = None,
) -> None:
    """Generation-0 bring-up of an ELASTIC multi-process run, the contract
    of ``parallel/mesh.py`` ``initialize_multihost`` with the world made so
    that a peer process's death is survivable: process 0 hosts the
    ``TCPStore`` at ``coordinator_address`` (``host:port``) and is the only
    writer of ``ack_g0.json`` (after wiping a reused directory's protocol
    files), and every process joins a gloo default group whose timeout is
    the rendezvous timeout. Workers that may need to re-rendezvous must
    start through here: a world made by the stock initializer detects a
    loss and aborts (the engine's ``_recover``)."""
    timeout_s = rendezvous_timeout_s() if timeout_s is None else timeout_s
    if dist.is_initialized():
        raise RuntimeError("distributed runtime already initialized")
    if process_id == 0:
        store = retry_transient(
            lambda: _make_store(coordinator_address, num_processes, True, timeout_s),
            retries=2, desc="gen-0 store bring-up", tick=heartbeat)
        if rdzv_dir:
            os.makedirs(rdzv_dir, exist_ok=True)
            # a REUSED directory (abort-and-resume restarts the fleet in
            # the same DBS_PEER_HB_DIR) still holds the dead run's protocol
            # files: the newest stale ack would win current_roster()'s
            # generation adoption, and that generation's loss claims would
            # mark freshly restarted peers down at the first boundary.
            # Clear them BEFORE publishing ack_g0 — peers read the directory
            # only after joining the group, which needs this store.
            reset_rendezvous_dir(rdzv_dir)
            _write_json(
                os.path.join(rdzv_dir, "ack_g0.json"),
                {
                    "address": coordinator_address,
                    "roster": list(range(num_processes)),
                    "epoch": 0,
                    "payload": {},
                },
            )
    else:
        store = _make_store(coordinator_address, num_processes, False, timeout_s)
    _init_world(store, process_id, num_processes, timeout_s)
    get_tracer().instant(
        "rdzv_init", cat="rdzv",
        args={"gen": 0, "processes": int(num_processes), "id": int(process_id)},
    )
    heartbeat()


def local_canary_launch(device) -> None:
    """One local launch on this rank's device, synchronized and checked:
    proves the device context is sound after a failed collective. It
    touches no peer (a collective here would pair with a peer's unrelated
    one). A no-op check of one addition on the CPU."""
    device = torch.device(device)
    x = torch.ones(8, device=device).add_(1.0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    if float(x.sum().item()) != 16.0:
        raise RuntimeError(f"canary launch on {device} returned {x.tolist()}")


def reset_rendezvous_dir(rdzv_dir: str) -> int:
    """Remove a PREVIOUS run's rendezvous protocol files from a reused
    directory (acks, loss claims, proposals, teardown/exit barriers, join
    offers) so a fresh generation-0 bring-up cannot adopt a dead run's
    generation or its loss verdicts. Beacon/marker files are left alone —
    live processes overwrite their own beacons at arm time. Returns the
    number of files removed. Only the gen-0 COORDINATOR may call this, and
    only before publishing ``ack_g0`` (peers first read the directory
    after joining the group its store serves)."""
    removed = 0
    for pat in (
        "ack_g*.json",
        "loss_g*.json",
        "propose_g*.json",
        "probe_g*.json",
        "torn_g*",
        "done_p*",
        "join_p*.json",
    ):
        for path in glob.glob(os.path.join(rdzv_dir, pat)):
            try:
                os.remove(path)
                removed += 1
            except OSError:
                pass
    return removed




def drain_collective_chain(
    device=None, timeout_s: Optional[float] = None, logger=None, tick: Callable = heartbeat
) -> bool:
    """Let the CURRENT (about-to-be-retired) world's in-flight device work
    resolve before the next world is built: a ``torch.cuda.synchronize`` of
    ``device`` in a side thread, bounded by ``DBS_RDZV_DRAIN_S`` (default
    12 s). A gloo collective is synchronous on the host, so what can still
    be in flight is the stream (a staged collective's copies); its error,
    if any, is the dead world's and is swallowed. Returns True if the
    stream drained inside the budget (always on the CPU)."""
    if timeout_s is None:
        timeout_s = _env_timeout("DBS_RDZV_DRAIN_S", 12.0)
    if device is None or torch.device(device).type != "cuda":
        return True
    done = threading.Event()

    def _drain() -> None:
        try:
            torch.cuda.synchronize(device)
        except Exception:  # noqa: BLE001 — the dead world's error, expected
            pass
        finally:
            done.set()

    # the drain is the incident timeline's second act (detection -> DRAIN ->
    # rebuild): span it so the postmortem stitcher can show how long the
    # dead world's in-flight work held the survivor up
    with get_tracer().span("rdzv_drain", cat="recover"):
        t = threading.Thread(target=_drain, daemon=True, name="rdzv-drain")
        t.start()
        deadline = time.monotonic() + timeout_s
        while not done.is_set():
            if time.monotonic() >= deadline:
                if logger is not None:
                    logger.warning(
                        f"rendezvous: the device stream did not drain in "
                        f"{timeout_s:.0f}s — proceeding (the quarantine canary "
                        "covers a late resolution)"
                    )
                get_tracer().instant(
                    "rdzv_drain_timeout", cat="rdzv",
                    args={"timeout_s": float(timeout_s)},
                )
                return False
            tick()
            done.wait(0.25)
    return True


def retire_runtime(mesh=None, timeout_s: Optional[float] = None,
                   tick: Callable = heartbeat) -> None:
    """Drop the live world: ``mesh``'s subgroups, NCCL group and pinned
    buffers (``DataMesh.retire``), then the default group, torn down in a
    side thread and waited on for at most the rendezvous timeout (a peer
    that died can leave a teardown waiting on queued work). The group and
    its store are held in :data:`_RETIRED`. After this the process holds no
    process group until :meth:`RendezvousStateMachine.establish` builds the
    next one; callers must have copied any state they need to the host.
    Raises :class:`RendezvousTimeout` (phase ``teardown``) when the
    teardown outlives its bound."""
    timeout_s = rendezvous_timeout_s() if timeout_s is None else timeout_s
    if mesh is not None:
        mesh.retire()
    if dist.is_initialized():
        _RETIRED.append(dist.group.WORLD)
        if _WORLD["store"] is not None:
            _RETIRED.append(_WORLD["store"])
        done = threading.Event()

        def _destroy() -> None:
            try:
                dist.destroy_process_group()
            except Exception:  # noqa: BLE001 — the dead world's error, expected
                pass
            finally:
                done.set()

        threading.Thread(target=_destroy, daemon=True, name="rdzv-teardown").start()
        deadline = time.monotonic() + timeout_s
        while not done.wait(0.05):
            if time.monotonic() >= deadline:
                get_tracer().instant("rdzv_timeout", cat="rdzv", args={"phase": "teardown"})
                raise RendezvousTimeout("teardown")
            tick()
    _WORLD["store"], _WORLD["elastic"] = None, False
    heartbeat()


def retired_count() -> int:
    """How many runtime objects previous generations retired
    (observability + tests)."""
    return len(_RETIRED)


def quarantine_runtime(device, logger=None, tick: Callable = heartbeat) -> None:
    """Check the re-established world's device before it trains:
    :func:`local_canary_launch` on ``device``. A context that took a
    sticky error in the failed collective cannot be rebuilt in-process, so
    a failing canary raises :class:`RendezvousError` (phase
    ``quarantine``) and the engine degrades to abort-and-resume."""
    tick()
    try:
        local_canary_launch(device)
    except Exception as e:  # noqa: BLE001 — any failure here is the verdict
        if logger is not None:
            logger.warning(f"rendezvous: the device failed its canary launch: {str(e)[:200]}")
        get_tracer().instant(
            "rdzv_quarantine_rebuild", cat="rdzv", args={"attempt": 1, "error": str(e)[:160]},
        )
        raise RendezvousError("quarantine", f"the device never launched cleanly: {e!r}")


class RendezvousStateMachine:
    """File-based propose -> agree -> barrier -> establish consensus over
    the heartbeat directory.

    One instance per process, identified by its ORIGINAL process id (the
    ident its heartbeat beacon file carries). All files live in
    ``rdzv_dir`` = the peer-heartbeat directory, so the failure detector
    and the recovery protocol share one channel:

    * ``propose_g{gen}_r{round}_p{id}.json`` — a survivor's roster view
      (+ the would-be leader's port pick and resume epoch);
    * ``torn_g{gen}_p{id}`` — "my old group is destroyed" (the barrier
      that orders every teardown before the new store exists);
    * ``ack_g{gen}.json`` — the leader's "store is up" (address + an
      opaque payload, e.g. the deterministically seeded controller
      vectors every process must adopt);
    * ``join_p{id}.json`` — a (re)spawned process offering to join at the
      next epoch boundary;
    * ``loss_g{gen}_p{id}.json`` — a survivor's published loss verdict, so
      detection is coherent across survivors whose beacon scans lag;
    * ``done_p{id}`` — clean-exit ordering (the coordinator process exits
      last: it hosts the stores).
    """

    def __init__(
        self,
        rdzv_dir: str,
        ident: int,
        gen: int = 0,
        logger=None,
        tick: Callable = heartbeat,
    ):
        self.rdzv_dir = rdzv_dir
        self.ident = int(ident)
        self.gen = int(gen)
        self.logger = logger
        self.tick = tick
        os.makedirs(rdzv_dir, exist_ok=True)

    # ------------------------------------------------------------- scanning

    def alive_procs(self, stale_s: Optional[float] = None) -> Set[int]:
        """Process ids with a fresh beacon and no watchdog exit tag (self
        included — its own beacon thread keeps it fresh)."""
        from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import (
            ProcessHeartbeat,
        )

        if stale_s is None:
            stale_s = _env_timeout("DBS_PEER_HB_STALE_S", 10.0)
        out: Set[int] = set()
        for ident, info in ProcessHeartbeat.scan(self.rdzv_dir).items():
            m = re.fullmatch(r"proc(\d+)", ident)
            if m and not ProcessHeartbeat.is_stale(info, stale_s):
                out.add(int(m.group(1)))
        out.add(self.ident)
        return out

    def offer_join(self) -> None:
        """(Re)spawned process: offer to join at the next epoch boundary.
        Idempotent; survivors pick it up via :meth:`pending_joins`."""
        _write_json(
            os.path.join(self.rdzv_dir, f"join_p{self.ident}.json"),
            {"ident": self.ident},
        )
        get_tracer().instant(
            "rdzv_offer_join", cat="rdzv", args={"ident": self.ident}
        )

    def pending_joins(self) -> Set[int]:
        out: Set[int] = set()
        for path in glob.glob(os.path.join(self.rdzv_dir, "join_p*.json")):
            info = _read_json(path)
            if info is not None:
                out.add(int(info["ident"]))
        return out

    def clear_join(self, ident: Optional[int] = None) -> None:
        ident = self.ident if ident is None else int(ident)
        try:
            os.remove(os.path.join(self.rdzv_dir, f"join_p{ident}.json"))
        except OSError:
            pass

    def current_roster(self) -> List[int]:
        """ORIGINAL process ids of the newest ESTABLISHED generation (the
        newest ack file), adopting that generation as :attr:`gen`. Empty
        when no ack exists — a world brought up by the stock initializer
        writes none; callers fall back to ``range(num_processes)``."""
        best: Optional[Dict] = None
        best_gen = -1
        for path in glob.glob(os.path.join(self.rdzv_dir, "ack_g*.json")):
            m = re.search(r"ack_g(\d+)\.json$", path)
            if not m or int(m.group(1)) <= best_gen:
                continue
            info = _read_json(path)
            if info is not None:
                best, best_gen = info, int(m.group(1))
        if best is None:
            return []
        self.gen = max(self.gen, best_gen)
        return [int(p) for p in best.get("roster", ())]

    # ----------------------------------------------------- loss coherence

    def claim_loss(self, dead: Iterable[int], epoch: int) -> None:
        """Publish this survivor's loss verdict so peers whose beacon scan
        lags adopt it at their next boundary instead of dispatching one
        more collective against the dead process."""
        dead = sorted(int(d) for d in dead)
        _write_json(
            os.path.join(self.rdzv_dir, f"loss_g{self.gen}_p{self.ident}.json"),
            {"dead": dead, "epoch": int(epoch)},
        )
        get_tracer().instant(
            "rdzv_claim_loss", cat="rdzv",
            args={"gen": self.gen, "dead": dead, "epoch": int(epoch)},
        )

    def claimed_losses(self) -> Set[int]:
        """Union of every survivor's published loss verdict for the CURRENT
        generation (older generations' claims are resolved history)."""
        out: Set[int] = set()
        pat = os.path.join(self.rdzv_dir, f"loss_g{self.gen}_p*.json")
        for path in glob.glob(pat):
            info = _read_json(path)
            if info is not None:
                out.update(int(d) for d in info.get("dead", ()))
        return out

    # ------------------------------------------------------- probe exchange

    def publish_probe(self, costs: Dict[int, float]) -> None:
        """Publish this process's measured per-worker compute costs
        (seconds/example, keyed by ORIGINAL worker rank) for the CURRENT
        generation — the grow-path share-seeding exchange: after
        a join rendezvous every member publishes what it measured locally
        and reads everyone else's, so survivors and the joiner all seed the
        SAME equilibrium share vector instead of guessing the joiner in at
        the survivor mean. Gen-tagged like every consensus file (a stale
        generation's costs must never seed a newer fleet) and atomic like
        every JSON write. An empty map is a valid publication: "I measured
        nothing" is itself the signal peers must not wait on."""
        _write_json(
            os.path.join(
                self.rdzv_dir, f"probe_g{self.gen}_p{self.ident}.json"
            ),
            {
                "ident": self.ident,
                "costs": {str(r): float(c) for r, c in costs.items()},
            },
        )

    def collect_probes(
        self, procs: Iterable[int], timeout_s: Optional[float] = None
    ) -> Optional[Dict[int, float]]:
        """Read every listed process's probe publication for the CURRENT
        generation, waiting (bounded, ``DBS_RDZV_PROBE_S``) for stragglers.
        Returns the merged rank -> cost map only when EVERY process's file
        arrived — a partial exchange returns None and the caller keeps its
        deterministic fallback seeding: all members must assemble the
        identical vector or none of them use the exchange."""
        if timeout_s is None:
            timeout_s = _env_timeout("DBS_RDZV_PROBE_S", 20.0)
        want = sorted(int(p) for p in procs)
        merged: Dict[int, float] = {}
        got: Set[int] = set()
        deadline = time.monotonic() + timeout_s
        last_tick = 0.0
        while True:
            for p in want:
                if p in got:
                    continue
                info = _read_json(
                    os.path.join(self.rdzv_dir, f"probe_g{self.gen}_p{p}.json")
                )
                if info is not None:
                    got.add(p)
                    for r, c in (info.get("costs") or {}).items():
                        merged[int(r)] = float(c)
            if len(got) == len(want):
                return merged
            now = time.monotonic()
            if now >= deadline:
                return None
            if now - last_tick >= _TICK_EVERY_S:
                last_tick = now
                self.tick()
            time.sleep(_POLL_S)

    # --------------------------------------------------- rebuild coherence

    def rebuild_vote(self, attempt: int, ok: bool) -> None:
        """Publish this survivor's verdict on rebuild round ``attempt`` of
        the CURRENT generation (the multi-survivor lift of the
        rebuild retry loop). The engine's post-establish world rebuild —
        quarantine canary, re-shard, state re-placement — retries locally
        when the new backend inherited the dead world's dispatch chain;
        with several survivors those retry counts used to be process-local,
        so one survivor could advance to the next attempt's collectives
        while a peer was still tearing its backend down. Votes make the
        round a unit: every survivor publishes ok/failed, and the round
        only stands when ALL of them succeeded."""
        _write_json(
            os.path.join(
                self.rdzv_dir,
                f"rebuild_g{self.gen}_a{int(attempt)}_p{self.ident}.json",
            ),
            {"ident": self.ident, "ok": bool(ok)},
        )
        get_tracer().instant(
            "rdzv_rebuild_vote", cat="rdzv",
            args={"gen": self.gen, "attempt": int(attempt), "ok": bool(ok)},
        )

    def rebuild_settled(
        self,
        procs: Iterable[int],
        attempt: int,
        timeout_s: Optional[float] = None,
    ) -> bool:
        """Collect every listed survivor's vote for rebuild round
        ``attempt``: True only when ALL voted ok (the callers may adopt the
        rebuilt world), False when any voted failed (every caller — the
        locally-successful ones included — tears down and retries the next
        round in lockstep). A survivor whose vote never lands within
        ``DBS_RDZV_REBUILD_S`` raises :class:`RendezvousTimeout` — it died
        or wedged mid-rebuild, and waiting longer just hides a second
        failure inside the first recovery."""
        if timeout_s is None:
            timeout_s = _env_timeout("DBS_RDZV_REBUILD_S", 60.0)
        want = sorted(int(p) for p in procs)
        votes: Dict[int, bool] = {}

        def _collected() -> bool:
            for p in want:
                if p in votes:
                    continue
                info = _read_json(
                    os.path.join(
                        self.rdzv_dir,
                        f"rebuild_g{self.gen}_a{int(attempt)}_p{p}.json",
                    )
                )
                if info is not None:
                    votes[p] = bool(info.get("ok"))
            return len(votes) == len(want)

        self._wait(_collected, timeout_s, f"rebuild-vote[{int(attempt)}]")
        return all(votes.values())

    # ----------------------------------------------------------- consensus

    def _disk_gen(self) -> int:
        gens = [0]
        for path in glob.glob(os.path.join(self.rdzv_dir, "ack_g*.json")):
            m = re.search(r"ack_g(\d+)\.json$", path)
            if m:
                gens.append(int(m.group(1)))
        return max(gens)

    def _wait(
        self, cond: Callable[[], bool], timeout_s: float, phase: str
    ) -> None:
        """Poll ``cond`` until true; tick the stall watchdog about once a
        second so the wait never reads as a device hang; hard-timeout into
        :class:`RendezvousTimeout` tagged with the phase."""
        deadline = time.monotonic() + timeout_s
        last_tick = 0.0
        while not cond():
            now = time.monotonic()
            if now >= deadline:
                get_tracer().instant(
                    "rdzv_timeout", cat="rdzv", args={"phase": phase}
                )
                raise RendezvousTimeout(phase)
            if now - last_tick >= _TICK_EVERY_S:
                last_tick = now
                self.tick()
            time.sleep(_POLL_S)

    def agree(
        self,
        alive_fn: Callable[[], Set[int]],
        epoch: int,
        timeout_s: Optional[float] = None,
    ) -> Agreement:
        """Roster consensus for the next generation: every member of the
        agreed roster posted an identical roster view. Divergent views
        (peers dying DURING the rendezvous, joiners racing in) converge by
        intersecting the posted views with the live beacon scan and
        advancing to a new proposal round; bounded rounds + a hard
        timeout, so a wedged peer degrades the rendezvous instead of
        hanging it."""
        timeout_s = rendezvous_timeout_s() if timeout_s is None else timeout_s
        tracer = get_tracer()
        with tracer.span("rdzv_agree", cat="recover"):
            gen = max(self.gen, self._disk_gen()) + 1
            my_port = _pick_port()
            deadline = time.monotonic() + timeout_s
            roster = sorted(alive_fn())
            for rnd in range(8):
                if self.ident not in roster or not roster:
                    raise RendezvousError(
                        "propose", f"evicted from roster {roster}"
                    )
                _write_json(
                    os.path.join(
                        self.rdzv_dir,
                        f"propose_g{gen}_r{rnd}_p{self.ident}.json",
                    ),
                    {"roster": roster, "port": my_port, "epoch": int(epoch)},
                )
                views: Dict[int, Dict] = {}
                advance = False
                last_tick = 0.0
                while True:
                    now = time.monotonic()
                    if now >= deadline:
                        missing = [p for p in roster if p not in views]
                        raise RendezvousTimeout(
                            f"propose[r{rnd}] waiting for proc(s) {missing}"
                        )
                    if now - last_tick >= _TICK_EVERY_S:
                        last_tick = now
                        self.tick()
                    for p in roster:
                        if p in views:
                            continue
                        got = _read_json(
                            os.path.join(
                                self.rdzv_dir,
                                f"propose_g{gen}_r{rnd}_p{p}.json",
                            )
                        )
                        if got is not None:
                            views[p] = got
                    if len(views) == len(roster):
                        rosters = {tuple(v["roster"]) for v in views.values()}
                        if len(rosters) == 1 and next(iter(rosters)) == tuple(
                            roster
                        ):
                            leader = roster[0]
                            agreed_epoch = max(
                                int(v["epoch"]) for v in views.values()
                            )
                            port = int(views[leader]["port"])
                            self.log(
                                f"rendezvous g{gen}: roster {roster} agreed "
                                f"(round {rnd}, leader proc{leader}, "
                                f"port {port}, epoch {agreed_epoch})"
                            )
                            tracer.instant(
                                "rdzv_agreed", cat="rdzv",
                                args={
                                    "gen": gen,
                                    "roster": list(roster),
                                    "round": rnd,
                                    "leader": leader,
                                    "epoch": agreed_epoch,
                                },
                            )
                            return Agreement(
                                gen=gen,
                                roster=tuple(roster),
                                rank=roster.index(self.ident),
                                address=f"localhost:{port}",
                                epoch=agreed_epoch,
                            )
                        advance = True
                    else:
                        # a peer we wait on may have died mid-rendezvous:
                        # refresh the live view and re-round without it
                        live = alive_fn()
                        if sorted(set(roster) & live) != roster:
                            advance = True
                    if advance:
                        merged: Set[int] = set(roster)
                        for v in views.values():
                            merged &= set(v["roster"])
                        merged &= alive_fn()
                        merged.add(self.ident)
                        roster = sorted(merged)
                        break
                    time.sleep(_POLL_S)
            raise RendezvousError("propose", "no roster consensus in 8 rounds")

    def establish(
        self,
        agreement: Agreement,
        payload: Optional[Dict] = None,
        timeout_s: Optional[float] = None,
    ) -> Dict:
        """Bring up the agreed world: barrier on every member's teardown
        (``torn`` files — every old group must be gone before any
        new-world traffic), the leader opens the new ``TCPStore`` and
        publishes the ack (+ ``payload``, the replicated-controller seed
        every process adopts), everyone joins the new default group at
        its rank. The caller must have called :func:`retire_runtime` (or
        never held a group: joiners). Returns the ack payload."""
        timeout_s = rendezvous_timeout_s() if timeout_s is None else timeout_s
        tracer = get_tracer()
        with tracer.span("rdzv_establish", cat="recover"):
            gen, roster = agreement.gen, list(agreement.roster)
            if dist.is_initialized():
                raise RuntimeError(
                    "establish() with a live process group — call "
                    "retire_runtime() first"
                )
            open(
                os.path.join(self.rdzv_dir, f"torn_g{gen}_p{self.ident}"), "w"
            ).close()
            tracer.instant(
                "rdzv_torn", cat="rdzv", args={"gen": gen, "ident": self.ident}
            )
            self._wait(
                lambda: all(
                    os.path.exists(
                        os.path.join(self.rdzv_dir, f"torn_g{gen}_p{p}")
                    )
                    for p in roster
                ),
                timeout_s,
                f"teardown barrier g{gen}",
            )
            ack_path = os.path.join(self.rdzv_dir, f"ack_g{gen}.json")
            try:
                if agreement.leader:
                    store = retry_transient(
                        lambda: _make_store(agreement.address, len(roster), True, timeout_s),
                        retries=2,
                        desc="rendezvous store bring-up",
                        tick=self.tick,
                    )
                    _write_json(
                        ack_path,
                        {
                            "address": agreement.address,
                            "roster": roster,
                            "epoch": agreement.epoch,
                            "payload": payload or {},
                        },
                    )
                    ack = _read_json(ack_path)
                else:
                    self._wait(
                        lambda: _read_json(ack_path) is not None,
                        timeout_s,
                        f"service ack g{gen}",
                    )
                    ack = _read_json(ack_path)
                    store = _make_store(ack["address"], len(roster), False, timeout_s)
                _init_world(store, agreement.rank, len(roster), timeout_s)
            except RendezvousError:
                raise
            except Exception as e:  # noqa: BLE001 — degrade, don't hang
                raise RendezvousError(
                    f"connect g{gen}", f"connect to {agreement.address}: {e!r}"
                )
            self.gen = gen
            self.tick()
            self.log(
                f"rendezvous g{gen}: world established over {roster} "
                f"(rank {agreement.rank}/{len(roster)} at {agreement.address})"
            )
            tracer.instant(
                "rdzv_established", cat="rdzv",
                args={
                    "gen": gen,
                    "roster": list(roster),
                    "rank": agreement.rank,
                    "address": agreement.address,
                },
            )
            return dict(ack.get("payload") or {}) if ack else {}

    # -------------------------------------------------------- exit protocol

    def finalize(self, timeout_s: float = 30.0) -> None:
        """Clean-exit ordering: every process drops a ``done`` file; the
        generation-0 COORDINATOR process (ident 0 — it hosts the store of
        every generation, retired ones included) waits for every
        still-live peer's done file plus a short grace before returning,
        so it is the last to exit and no peer sees its store close under
        a teardown."""
        open(os.path.join(self.rdzv_dir, f"done_p{self.ident}"), "w").close()
        if self.ident != 0:
            return
        peers = self.alive_procs() - {self.ident}
        try:
            self._wait(
                lambda: all(
                    os.path.exists(
                        os.path.join(self.rdzv_dir, f"done_p{p}")
                    )
                    for p in self.alive_procs() - {self.ident}
                ),
                timeout_s,
                "exit drain",
            )
        except RendezvousTimeout:
            self.log(f"exit drain timed out waiting for {sorted(peers)}")
        time.sleep(0.5)  # grace: peers' interpreters finish exiting

    def log(self, msg: str) -> None:
        if self.logger is not None:
            self.logger.info(msg)


def join_elastic_world(
    rdzv_dir: str,
    ident: int,
    timeout_s: Optional[float] = None,
    logger=None,
    tick: Callable = heartbeat,
) -> Tuple[RendezvousStateMachine, Agreement, Dict]:
    """A (re)spawned process joins the running fleet at the survivors' next
    epoch boundary: beacon first (the survivors' boundary scan must see a
    FRESH pulse or the roster intersection evicts us), offer the join, then
    enter the same propose → agree → barrier protocol the survivors run —
    their boundary-side :meth:`pending_joins` check is what starts the
    round, so the join timeout must cover at least one of their epochs
    (``DBS_RDZV_JOIN_TIMEOUT_S``, default 600s). The caller must NOT have a
    live process group yet; after this returns, ``torch.distributed`` holds
    the grown world and the caller builds its engine over it (restoring
    training state from the shared checkpoint directory). Returns
    ``(state_machine, agreement, ack payload)``."""
    if timeout_s is None:
        timeout_s = _env_timeout("DBS_RDZV_JOIN_TIMEOUT_S", 600.0)
    sm = RendezvousStateMachine(rdzv_dir, ident, logger=logger, tick=tick)
    sm.current_roster()  # adopt the live generation before proposing past it
    sm.offer_join()
    agreement = sm.agree(
        lambda: sm.alive_procs() - sm.claimed_losses(),
        epoch=0,
        timeout_s=timeout_s,
    )
    payload = sm.establish(agreement, timeout_s=timeout_s)
    sm.clear_join()
    return sm, agreement, payload
