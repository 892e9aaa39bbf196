"""The training engine: the DBS feedback loop, on one card or across ranks.

The JAX package's ``Trainer`` (``train/engine.py``), lean: one controller
drives every logical worker of its process, all on the process's one device
(the analogue of the reference's ``-gpu 0,0,0,0`` contention recipe).

    for epoch:
        adjust LR (one-cycle)                     _plan_epoch
        shares <- solver(node_times, shares)      _plan_epoch
        plan   <- partition dataset + batches     _plan_epoch
        faults <- injector; probe or not?         _plan_epoch (_should_probe)
        train one epoch                           _dispatch_epoch:
            packed: one step over the workers' concatenated batches
            elastic: per-worker steps, summed     _train_epoch_packed / _elastic
                in windows; --rebalance window    _run_elastic_windows
                may switch the rest of the epoch  _maybe_window_rebalance
                onto a new plan
        time each worker's step (probe)           _probe_workers
        validate                                  validate
        node_times <- compute * multipliers + injected   _record_epoch
        record the 9 metric series                _record_epoch

Paths (``--packed``): every worker of this port shares one card, so a
vision run takes the *packed* path (``auto``, as the JAX package does on one
chip) unless ``--packed off``, a per-worker gradient clip or another
elastic-only feature rules it out: each step concatenates the workers'
true-width batches and runs one forward and one backward, the elastic
combine's math in one launch sequence. The language model stays elastic.

Per-worker compute time on an asynchronous device is not a host clock
around a launched call, so the engine times a *probe*: one standalone
forward/backward of each worker's batch after ``torch.cuda.synchronize()``,
min over 3 repetitions, scaled by the worker's step count. The combine +
update is probed separately as ``sync_time`` and never enters the solver's
vector (PARITY contract 4). A ``timing_model`` replaces the probes with a
deterministic model, as in the JAX package.

Adaptive probes (``--probe_mode adaptive``, the default): the probes of
epochs 0-1 anchor a per-example cost per worker; later epochs skip them and
feed the solver modeled times (``_model_compute_times``) unless the anchor
is stale: ``probe_every`` epochs passed, the injection episode changed, or
two skipped epochs in a row ran ``probe_wall_tol`` slower than the probed
one (``_update_probe_schedule``). ``always`` probes every epoch.

Compute-mode injection (``--fault_mode compute``) turns a straggler's extra
time into synthetic-load iterations a step (``ops/faultload.py``); the
engine calibrates the cost an iteration inside a real step, by a paired
measurement (an injected probe's raw wall minus a clean one's), on the
first injection-free probed epoch (``_calibrate_iter_cost``).

Window-cadence rebalancing (``--rebalance window``, the JAX package's
``_run_elastic_windows``): the elastic epoch runs in the JAX package's
dispatch windows (``_elastic_ranges``). After every ``rebalance_every``
windows the online controller (``balance/controller.py``) folds the probe
anchors, the schedule's factors for the next window
(``ScheduledStragglerInjector.faults_at``) and the measured wall of the
windows since its last evaluation (on the card the time between two CUDA
events recorded at the evaluations, ``DeviceWindowTimer``; on the CPU the
host's wall after a synchronize less its launch time, ``HostOverheadMeter``,
as in the JAX package), and may switch the rest of
the epoch onto a new plan (``build_remainder_plan``) appended to the
segment table ``seg_plans``. Under compute-mode injection each window
re-stages the synthetic-load iterations at the schedule's value in
mid-window. Augmentation draws are seeded per window start, so a window's
draws depend on (seed, epoch, step) alone and a switch replays as a fresh
run on the remainder plan (``_replay_window_segment``). Packed epochs have no
window boundary: there the flag warns once and the run keeps epoch cadence.

Compute dtype (``--precision bfloat16``): every training forward (the
packed and elastic steps, the probes and the compute-mode calibration) runs
on bf16 copies of the f32 master weights and a bf16 batch (``_prep``), as the
JAX ``StepLibrary`` does with its ``compute_dtype``; the loss, the gradients,
the optimizer state and ``validate`` stay f32.

Supersteps (``--superstep``, the JAX package's one-device scan mode):
``auto`` and ``on`` give ``_elastic_mode() == "scan"``, every worker of this
port sharing one card. Each training step of the elastic and packed epochs
then goes through ``StepGraphs`` (``train/supersteps.py``): on the card it
is replayed from a CUDA graph captured once per step key, a window's
replays (the packed epoch's: the whole epoch's, as the JAX ``fused_epoch``)
inside one ``HostOverheadMeter.dispatch()``; on the CPU the same executor
runs the step eagerly from its static slots. The batches are gathered and
augmented eagerly in the same order as before, so the augmentation draws
do not move. ``off`` gives ``"step"``: the eager per-step loop, the parity
and host-overhead reference, on both paths. The probes and the in-step
calibration stay eager. Each epoch's captures, replays, capture seconds,
dispatches and host dispatch seconds go to ``_meta["supersteps"]``.

Checkpoints (``--ckpt_dir``, ``train/checkpoint.py``): ``run`` restores the
latest one before its first epoch (``_maybe_restore``: the parameters and
momentum buffers copied in place, the step counter, the generators' states
and the controller's shares, node times and wall totals), saves one after
every epoch (``_save_checkpoint``) and makes the last durable at the end.

Observability (``--trace``, ``--trace_spool``, ``--profile_dir``): each
epoch is a graftscope ``epoch`` span tiled by the phases ``plan_solve``,
``train``, ``validate`` and ``record``, with ``dispatch_window``,
``probe``, ``sync_probe``, ``warm`` (a step graph's warm-up and capture)
and ``checkpoint`` spans inside or beside them, as the JAX package names
them (``obs/trace.py``; ``save_trace`` writes the Chrome trace,
``--trace_spool`` streams it to a crash-durable spool). ``--profile_dir``
runs ``torch.profiler`` over the epochs and exports its Chrome trace there.
The first elastic or packed epoch counts one eager step's FLOPs
(``obs/flops.py`` ``step_flops``) outside its wall; every epoch then records
``flops_per_epoch`` and, on a card with a known peak, ``mfu_bf16_peak``.

Ranks (``--coordinator``/``--num_processes``/``--process_id``, one process
a device, ``parallel/mesh.py``): each process owns ``world_size / n_proc``
contiguous workers (``_setup_topology``) and replicates the plan and the
solver; the time vectors are gathered in rank order (``exchange_times``) and
the probe decision is the ranks' OR. Elastic epochs run in the JAX
package's window mode (``_run_rank_windows``): each step, the rank's
workers' forward/backward into ``.grad`` (a step graph's replay), then the
combine across ranks and the update, eagerly (``train/combine.py``). With
one worker a device the fused paths run (``_train_epoch_fused``: ``-dbs
false``, or ``--fused_dbs`` at the capacity width, with ``--grad_accum``,
``--compress_grads int8`` and ``--shard_update``). Validation is split by
chunks over the ranks (``_validate_sharded``); process 0 writes the series.
``--grad_comm hier`` (``_setup_grad_comm``, the JAX engine's tree
resolution, bandwidth probe, learned tree and wires) gives the combine a
topology tree over the ranks (``train/combine.py``), or falls back to the
flat combine with the JAX package's warning.

``--elastic on`` (the JAX package's two tiers): in one process a lost
worker is re-solved around from the epoch's snapshot and readmitted at a
boundary; across processes each process beacons under ``DBS_PEER_HB_DIR``,
a lost peer process (a stale beacon, or a collective failing against it)
is survived by the re-rendezvous of ``runtime/rendezvous.py``
(``_mh_rerendezvous``: agree, tear the ``torch.distributed`` world down,
establish a smaller one, rebuild the data axis and the combine, restore
the flushed checkpoint, re-run the epoch), and a respawned process grows
the fleet back at an epoch boundary. A world of the cli's stock
``initialize_multihost`` detects the loss and aborts with the JAX message.

The language-model trainer (``train/lm_engine.py``) subclasses this one and
overrides the data plane: ``SNAP_BATCHES``, ``_setup_data``,
``_setup_model``, ``_build_plan``, ``_worker_epoch``, ``_fused_epoch`` and
``validate``; every path above but the packed one runs it, across ranks too.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.balance import (
    HostOverheadMeter,
    TimeKeeper,
    equilibrium_shares,
    exchange_times,
    initial_partition,
    integer_batch_split,
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.timing import DeviceWindowTimer
from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import (
    OnlineRebalanceController,
    step_time,
)
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import (
    DatasetBundle,
    build_epoch_plan,
    build_remainder_plan,
    load_dataset,
)
from dynamic_load_balance_distributeddnn_tpu_torch.faults import (
    EpochFaults,
    FaultContext,
    FaultInjector,
    LuckyFaultInjector,
    NullInjector,
    ScheduledStragglerInjector,
    StaticStragglerInjector,
)
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    Dropout,
    init_flax_defaults,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs import (
    EPOCH_CAT,
    MetricsRecorder,
    MetricsRegistry,
    get_tracer,
    init_logger,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.flops import mfu, step_flops
from dynamic_load_balance_distributeddnn_tpu_torch.ops.augment import (
    augment_images,
    normalize_images,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.ops.losses import example_weights
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import (
    allgather_host,
    allgather_object,
    axis_size,
    barrier,
    broadcast_object,
    data_mesh,
    probe_link_bandwidth,
    process_count,
    process_index,
)
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import fold_in, prng_key
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.topology import (
    TopologyTree,
    WorkerTopology,
)
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.wire import (
    choose_wires,
    tree_hop_bytes,
    wire_payload_bytes,
)
from dynamic_load_balance_distributeddnn_tpu_torch.runtime import rendezvous as rdzv
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import (
    ProcessHeartbeat,
    WorkerHealth,
    WorkerLost,
    retry_transient,
)
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.watchdog import (
    heartbeat,
    register_exit_tag_path,
    tag_exit_reason,
    unregister_exit_tag_path,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.combine import RankCombine
from dynamic_load_balance_distributeddnn_tpu_torch.train.checkpoint import (
    flush_checkpoints,
    restore_checkpoint,
    save_checkpoint,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.schedule import one_cycle_lr
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import (
    learning_rate,
    make_optimizer,
    set_learning_rate,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
    accumulate_grads,
    combine_probe,
    elastic_step,
    fused_grads,
    packed_step,
    prepare_step_state,
    probe_grads,
    set_remat,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import StepGraphs

_EVAL_CHUNK = 1024
# the series a rank report carries
RANK_SERIES = ("train_loss", "val_loss", "accuracy", "partition", "sync_time", "comm_bytes_ici",
               "comm_bytes_dcn", "wallclock_time")
_RANK_SEED_STRIDE = 15485863  # a rank's generator seeds: the seed plus its multiple
_COMBINE_KEY = 0x5D1E  # the elastic combine's key root (JAX steps.py _sharded_combine_body)


def _gen0_roster(hb_dir: Optional[str]) -> List[int]:
    """The generation-0 roster an elastic world published (``ack_g0.json``
    under the heartbeat directory), or [] where there is none."""
    if not hb_dir:
        return []
    info = rdzv._read_json(os.path.join(hb_dir, "ack_g0.json")) or {}
    return [int(p) for p in info.get("roster", ())]


def resolve_device(device) -> torch.device:
    """The run's device: CUDA unless the caller asks for the CPU. A CUDA
    request without a card raises instead of falling back."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: this port runs on the card; pass "
                "device='cpu' to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}: use 'cuda' or 'cpu'")
    return dev


def rank_device(cfg: Config, device, proc_id: int, n_proc: int) -> torch.device:
    """This process's one device (:func:`resolve_device`): each process owns
    ``world_size / n_proc`` contiguous workers, ``proc_id``'s slice of the
    ``-gpu`` map, which must name one device, and the same local ordinal
    on every process."""
    if cfg.world_size % n_proc != 0:
        raise ValueError(f"world_size {cfg.world_size} must divide evenly across {n_proc} processes")
    ws_local = cfg.world_size // n_proc
    dev = torch.device(device)
    n_local = torch.cuda.device_count() if dev.type == "cuda" and torch.cuda.is_available() else 1
    ids_global = cfg.worker_device_ids(max(n_local, 1))
    used = sorted(set(ids_global[proc_id * ws_local:(proc_id + 1) * ws_local]))
    if len(used) != 1:
        raise NotImplementedError(
            f"-gpu {cfg.device}: this process's workers name devices {used}; a process "
            "of this port owns one device (launch one process a device with "
            "--coordinator/--num_processes/--process_id)"
        )
    for p in range(n_proc):
        slice_p = ids_global[p * ws_local:(p + 1) * ws_local]
        if sorted(set(slice_p)) != used:
            raise ValueError(
                "multi-host topology must be symmetric: every process must map its "
                f"workers onto the same local device ordinals (process 0 uses {used}, "
                f"process {p} would use {sorted(set(slice_p))}); adjust the device map"
            )
    if dev.type == "cuda" and dev.index is None and cfg.device is not None:
        dev = torch.device("cuda", used[0])
    return resolve_device(dev)


def rank_report_base(model, proc_id: int, mesh, device, recorder,
                     series=RANK_SERIES) -> Dict[str, object]:
    """The fields every trainer's rank report shares: the data axis, the
    kernels' launch counts, a SHA-256 of the parameters' bytes (equal on
    every rank when the ranks agree bit for bit), the collective walls, the
    paths, the run's ``series`` and the peak device memory."""
    import hashlib

    from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import runtime

    h = hashlib.sha256()
    for _, p in model.named_parameters():
        h.update(p.detach().to("cpu").contiguous().numpy().tobytes())
    data = recorder.data
    return {
        "rank": proc_id, "ranks": mesh.describe(), "device": str(device),
        "launches": dict(runtime.LAUNCHES), "param_sha256": h.hexdigest(),
        "collective": recorder.meta.get("collective"), "paths": recorder.meta.get("paths"),
        "series": {k: data.get(k) for k in series},
        "peak_bytes": (torch.cuda.max_memory_allocated(device)
                       if device.type == "cuda" else None),
    }


class Trainer:
    """Vision-model DBS trainer on one device."""

    SNAP_BATCHES = True  # snap batch sizes to bucket multiples (vision only)

    def __init__(
        self,
        cfg: Config,
        bundle: Optional[DatasetBundle] = None,
        injector: Optional[FaultInjector] = None,
        timing_model: Optional[Callable] = None,
        device="cuda",
        logger=None,
        log_to_file: bool = True,
    ):
        """``timing_model``: optional callable(plan) -> per-worker seconds,
        replacing the wall-clock probes with a deterministic model (tests)."""
        self._setup_topology(cfg, device)
        if self.device.type == "cuda" and not cfg.use_pallas:
            raise ValueError(
                "--use_pallas false: on the card this port always runs its "
                "CUDA kernels (the plain versions are for CPU tensors)"
            )
        self.cfg = cfg
        # the training forward's dtype: bf16 copies of the f32 master
        # weights under --precision bfloat16 (train/steps.py cast_compute)
        self.compute_dtype = torch.bfloat16 if cfg.precision == "bfloat16" else None
        self.timing_model = timing_model
        self.logger = logger or init_logger(cfg, rank=self.proc_id, to_file=log_to_file)
        self.world_size = cfg.world_size
        # graftscope: the engine owns the process-wide tracer's config, set
        # unconditionally so a trace="off" run never inherits an earlier
        # traced run's state in the same process
        self._trace = get_tracer().configure(
            cfg.trace, ring_size=cfg.trace_ring, annotations=cfg.trace_annotations
        )
        self._spool_writer = None
        if cfg.trace != "off" and cfg.trace_spool:
            self._attach_spool()
        self._setup_grad_comm()

        self._setup_data(bundle)
        self._setup_model()
        set_remat(self.model, cfg.remat)  # --remat: train/steps.py forward
        # the step executor of --superstep auto/on (train/supersteps.py); the
        # dropout generator is registered with every captured step
        self.supersteps = StepGraphs(self.device, generators=[self.dropout_gen],
                                     tracer=self._trace)
        self._superstep_keys: set = set()

        self.injector = injector if injector is not None else self._make_injector()
        self._needs_iter_cost = cfg.fault_mode == "compute" and not isinstance(
            self.injector, NullInjector
        )
        self.load = SyntheticLoad()

        self.recorder = MetricsRecorder()
        self.recorder.stamp_data_source(
            self.bundle if self.bundle is not None else getattr(self, "corpus", None)
        )
        self.recorder.meta["wall_excludes_probes"] = True
        self.recorder.meta["device"] = str(self.device)
        self.recorder.meta["ranks"] = self.mesh.describe()
        if self.n_proc > 1:
            self.logger.info(
                f"rank {self.proc_id} of {self.n_proc}: workers {self.rank_lo}.."
                f"{self.rank_lo + self.ws_local - 1} on {self.device}, collectives on "
                f"{self.mesh.backend}" + (" (staged through pinned host memory)"
                                          if self.mesh.staged else ""))
        if self.device.type == "cuda":
            self.recorder.meta["device_name"] = torch.cuda.get_device_name(self.device)
        if cfg.straggler:
            self.recorder.meta["straggler_factors"] = cfg.straggler_factors()
            self.recorder.meta["fault_mode"] = cfg.fault_mode
        self.shares = initial_partition(cfg.world_size)
        self.node_times = np.ones(cfg.world_size, dtype=np.float64)
        # clean seconds an example per worker, anchored by the probes
        self.per_example_cost = np.full(cfg.world_size, np.nan)
        # in-step seconds a synthetic-load iteration: the standalone
        # estimate, then the paired in-step calibration (compute mode)
        self._iter_cost_s: Optional[float] = None
        self._iter_cost_calibrated = False
        self.timekeeper = TimeKeeper(cfg.world_size)
        self.total_wallclock = 0.0
        self.total_probe_s = 0.0
        self._sync_per_step = 0.0  # last probed sync cost, reused on skips
        # the adaptive probe schedule (_should_probe, _update_probe_schedule)
        self._probe_this_epoch = True
        self._next_probe_epoch = 0
        self._probe_sig: Optional[tuple] = None
        self._probe_episode: Optional[tuple] = None
        self._probe_wall_ref: Optional[float] = None
        self._slow_streak = 0
        # window cadence (--rebalance window): the host's launch walls, the
        # controller (built on the first elastic epoch), its executed
        # switches, the recorder's per-epoch switch baseline, and the
        # multiplier-free compute vector its rates fall back on
        self._host_meter = HostOverheadMeter()
        self._rebalance_ctl: Optional[OnlineRebalanceController] = None
        self._rebalance_events: List[Dict] = []
        self._switches_last = 0
        self._window_rebalance_logged = False
        self._clean_compute_s: Optional[np.ndarray] = None
        self._clean_examples: Optional[np.ndarray] = None
        # the card's time between window evaluations (CUDA events)
        self._window_timer = DeviceWindowTimer(self.device)
        self._packed_epoch = False  # the path of the epoch running
        # optimizer steps taken (a checkpoint's step counter), FLOPs an
        # example (counted once, obs/flops.py), and the parameter count
        self.steps_done = 0
        self._flops_per_example: Optional[float] = None
        self._param_elems = int(sum(p.numel() for p in self.params))
        self._record_grad_comm()
        # --elastic: the active fleet. ``world_size`` is the runtime world
        # size, cfg.world_size until a confirmed loss shrinks it (a
        # readmission grows it back); ``active_ranks`` maps the compact
        # runtime ranks to the original ones, in which the injector and the
        # health verdicts speak
        self.active_ranks = list(range(cfg.world_size))
        self.health = WorkerHealth(cfg.world_size, detect_misses=cfg.elastic_detect_misses,
                                   latency_factor=cfg.elastic_latency_factor, logger=self.logger)
        self._recoveries = 0
        self._elastic_events: List[Dict] = []
        self._epoch_snap: Optional[Dict] = None
        self._detect_t0: Optional[float] = None
        # the epoch-time each loss was confirmed at: a recovery re-runs the
        # epoch, whose liveness rounds revisit times before the loss
        self._lost_t: Dict[int, float] = {}
        # across processes (the JAX package's second tier): the rendezvous
        # state machine (armed with the peer beacon when DBS_PEER_HB_DIR is
        # set and the world came up through rendezvous.elastic_initialize),
        # and the fleet in ORIGINAL process idents. ``proc_id``/``n_proc``
        # are the live world's and change across a re-rendezvous;
        # ``_orig_proc_id``/``_proc_roster``/``_n_proc0`` key the heartbeat
        # files, the workers' ownership and the protocol
        self._rdzv: Optional[rdzv.RendezvousStateMachine] = None
        self._hb_beacon = None
        self._hb_beacon_path: Optional[str] = None
        self._peer_watch: Optional[Callable] = None
        self._peer_scan_cache = None
        self._proc_roster = list(range(self.n_proc))
        if cfg.elastic == "on" and self.n_proc > 1:
            self._arm_peer_heartbeats()
        self.obs = MetricsRegistry(recorder=self.recorder, tracer=self._trace)
        self.obs.attach(host_meter=self._host_meter, health=self.health)
        self._can_use_packed(None)  # --packed on fails here where it cannot engage
        # the combine across ranks (train/combine.py): made here when the
        # run has several ranks, else on the first fused epoch
        self._rank_combine: Optional[RankCombine] = None
        self._probes_ran = False  # a replicated flag: every rank probes epoch 0
        self._fused_sync_per_step: Optional[float] = None
        if self.n_proc > 1:
            self._make_rank_combine()

    # -------------------------------------------------------------- set-up

    def _setup_topology(self, cfg: Config, device) -> None:
        """The JAX package's multi-process topology, one device a process:
        each process owns ``world_size / n_proc`` contiguous workers
        (``rank_lo`` on), placed by the ``-gpu`` map's slice on its one
        local device; the map must be symmetric (every process on the same
        local ordinal), and the data axis (``parallel/mesh.py``) spans the
        processes. The plan and the solver stay replicated: every rank
        solves the same vector."""
        self.n_proc = process_count()
        self.proc_id = process_index()
        if (cfg.num_processes > 0 or self.n_proc > 1) and cfg.num_processes != self.n_proc:
            # the config's refusals across processes read --num_processes
            raise ValueError(
                f"--num_processes {cfg.num_processes} but the process group holds {self.n_proc}"
            )
        # the elastic tier across processes (runtime/rendezvous.py) speaks
        # ORIGINAL process idents and the generation-0 fleet shape: a
        # respawned joiner carries its ident in DBS_MH_IDENT, and the
        # gen-0 process count (ack_g0.json) slices the workers among the
        # idents whatever the live world's size
        self._orig_proc_id = int(os.environ.get("DBS_MH_IDENT", self.proc_id))
        self._n_proc0 = self.n_proc
        if cfg.elastic == "on" and self.n_proc > 1 and rdzv.elastic_world():
            roster0 = _gen0_roster(os.environ.get("DBS_PEER_HB_DIR"))
            if roster0:
                self._n_proc0 = len(roster0)
        self.device = rank_device(cfg, device, self._orig_proc_id, self._n_proc0)
        self.ws_local = cfg.world_size // self._n_proc0
        self.rank_lo = self.proc_id * self.ws_local
        self.topology = WorkerTopology.build(self.ws_local, [self.device], [0] * self.ws_local)
        self.mesh = data_mesh(self.device)
        self.n_dev = axis_size(self.mesh)  # the data axis's devices, one a rank
        # each local worker's loss sum of the step (a step graph writes it)
        self._worker_loss = torch.zeros(self.ws_local, device=self.device)

    def _make_rank_combine(self) -> RankCombine:
        """The combine across ranks (``train/combine.py``): ``.grad`` moved
        into its flat buffer and, under ``--shard_update``, the momentum
        into this rank's chunk. Any captured step graph is dropped (it
        wrote the old ``.grad``)."""
        if self._rank_combine is None:
            cfg = self.cfg
            tree = None if self._topo_tree is None else (self._topo_tree.names,
                                                         self._topo_tree.sizes)
            self._rank_combine = RankCombine(self.mesh, self.model, self.optimizer, cfg.momentum,
                                             shard_update=cfg.shard_update,
                                             compress=cfg.compress_grads, tree=tree,
                                             wires=self._grad_comm_wires)
            if self.supersteps.superstep_cache_size():
                self.supersteps.clear()
            self.recorder.meta["combine"] = self._rank_combine.describe()
        return self._rank_combine

    def _setup_grad_comm(self) -> None:
        """``--grad_comm hier`` resolved, as the JAX engine does it:
        ``self.grad_comm`` is the combine that runs (``"flat"`` when the
        ranks do not factor into a tree, or when the bandwidth probe's gate
        or the learned tree says the tree gains nothing), ``_topo_tree`` its
        tree and ``_grad_comm_wires`` its hops' codecs. The JAX package runs
        the probe only in one process, so that no two processes take other
        verdicts; here every rank on one host runs it (its collectives are
        the world's) and every rank takes rank 0's numbers
        (``broadcast_object``), so the verdict, the learned tree and the
        ``auto`` wires are one on every rank. Across hosts the probe does
        not run and ``--grad_comm`` is trusted, as in the JAX package."""
        cfg = self.cfg
        self.grad_comm = "flat"
        self._topo_tree: Optional[TopologyTree] = None
        self._hier_hosts = 0
        self._grad_comm_wires: tuple = ()
        self._link_bw: Optional[Dict] = None
        if cfg.grad_comm == "hier":
            tree, learn = self._resolve_topology_tree()
            if tree is None:
                self.logger.warning(
                    f"grad_comm=hier: no topology-tree factorization of {self.n_dev} ranks "
                    f"(hier_levels={cfg.hier_levels!r}, hier_hosts={cfg.hier_hosts}, "
                    f"processes={self.n_proc}) — falling back to the flat combine")
            else:
                self.grad_comm, self._topo_tree, self._hier_hosts = "hier", tree, tree.sizes[0]
        if self.grad_comm == "hier":
            if not self.mesh.cross_host:
                self._probe_links()
                if learn:
                    self._learn_tree_from_probe()
            elif cfg.dcn_bandwidth_probe or learn:
                self.logger.warning(
                    "the bandwidth probe runs only when every rank is on one host — keeping "
                    "grad_comm=hier as configured")
            bw = self._link_bw
            if cfg.dcn_bandwidth_probe and self.grad_comm == "hier" and bw is not None \
                    and not bw["hier_wins"]:
                self.logger.warning(
                    f"grad_comm=hier: bandwidth probe measured the tree structure at "
                    f"{bw['hier_wall_s']:.4f}s vs {bw['flat_wall_s']:.4f}s for one flat sum "
                    f"(ratio {bw['wall_ratio']:.3f}, gate {cfg.dcn_probe_gate}) — falling back "
                    "to the flat combine")
                self._go_flat()
        self._grad_comm_wires = self._resolve_wires()

    def _go_flat(self) -> None:
        self.grad_comm, self._topo_tree, self._hier_hosts = "flat", None, 0

    def _probe_links(self) -> None:
        """The bandwidth probe of the current tree on every rank, rank 0's
        numbers kept on all (``parallel/mesh.py`` ``probe_link_bandwidth``)."""
        tree = self._topo_tree
        with self._trace.span("link_probe", cat="probe"):
            bw = probe_link_bandwidth(self.mesh, tree.names, tree.sizes,
                                      tracer=self._trace, gate_ratio=self.cfg.dcn_probe_gate)
        self._link_bw = broadcast_object(bw)
        self.logger.info(
            f"bandwidth probe over {list(tree.levels)}: level bytes/s "
            f"{[round(r) for r in self._link_bw['level_bytes_per_s']]}, tree "
            f"{self._link_bw['hier_wall_s']}s against flat {self._link_bw['flat_wall_s']}s "
            f"(ratio {self._link_bw['wall_ratio']}, hier_wins {self._link_bw['hier_wins']}, "
            f"rank 0's numbers)")

    def _resolve_topology_tree(self):
        """The JAX ``_resolve_topology_tree``: the declared tree
        (``--hier_levels``), else the host/device split of the ranks (their
        hosts, or ``--hier_hosts``). Returns ``(tree or None, learn)``,
        ``learn`` for a ``learned`` prefix."""
        cfg = self.cfg
        spec = cfg.hier_levels.strip()
        learn = False
        if spec == "learned" or spec.startswith("learned,"):
            learn = True
            spec = spec[len("learned"):].lstrip(",")
        tree = None
        if spec:
            tree = TopologyTree.declared(spec, self.n_dev)
            if tree is None:
                self.logger.warning(f"hier_levels={spec!r} does not factor {self.n_dev} ranks — "
                                    "trying the two-level host/device split")
        if tree is None:
            tree = TopologyTree.from_process_topology(self.mesh.hosts, requested=cfg.hier_hosts)
        return tree, learn

    def _learn_tree_from_probe(self) -> None:
        """The JAX ``_learn_tree_from_probe``: adjacent levels measured as
        one link class merge; a merge to one level runs flat; a new tree is
        probed again, so the rates match the final levels."""
        rates = (self._link_bw or {}).get("level_bytes_per_s")
        if not rates or len(rates) != len(self._topo_tree.levels):
            return
        merged = TopologyTree.learned(self._topo_tree, rates)
        if merged is None:
            self.logger.warning("hier_levels=learned: every level measured as the same link "
                                "class (symmetric fabric) — falling back to the flat combine")
            self._go_flat()
            return
        if merged.levels != self._topo_tree.levels:
            self.logger.info(f"hier_levels=learned: merged {self._topo_tree.levels} -> "
                             f"{merged.levels} from measured link rates")
            self._topo_tree, self._hier_hosts = merged, merged.sizes[0]
            self._probe_links()

    def _resolve_wires(self) -> tuple:
        """The JAX ``_resolve_wires``: one codec a level, outermost first,
        the innermost fp32: ``--grad_comm_wires`` (one a level), ``auto``
        (``choose_wires`` over the probe's level rates), else
        ``--grad_comm_wire`` on the outermost hop and fp32 below."""
        if self.grad_comm != "hier":
            return ()
        cfg = self.cfg
        sizes = self._topo_tree.sizes
        k = len(sizes)
        spec = cfg.grad_comm_wires.strip()
        if spec == "auto":
            rates = (self._link_bw or {}).get("level_bytes_per_s")
            if rates and len(rates) == k:
                wires = choose_wires(sizes, rates)
                self.logger.info(f"grad_comm_wires=auto: {dict(zip(self._topo_tree.names, wires))} "
                                 "from measured link rates")
                return wires
            self.logger.warning("grad_comm_wires=auto needs the bandwidth probe's per-level rates "
                                "(every rank on one host) — using the legacy default")
            spec = ""
        if spec:
            wires = tuple(w.strip() for w in spec.split(","))
            if len(wires) == k:
                return wires
            self.logger.warning(f"grad_comm_wires={spec!r} has {len(wires)} entries but the "
                                f"resolved tree has {k} levels — using the legacy default")
        return (cfg.grad_comm_wire,) + ("fp32",) * (k - 1)

    def _record_grad_comm(self) -> None:
        """Which combine the run's walls were measured under (the JAX
        recorder's ``grad_comm*`` and ``link_bandwidth``), and the modeled
        wall of one combine."""
        meta = self.recorder.meta
        meta["grad_comm"] = self.grad_comm
        if self.grad_comm == "hier":
            meta["grad_comm_wire"] = self.cfg.grad_comm_wire
            meta["grad_comm_hosts"] = self._hier_hosts
            meta["grad_comm_levels"] = [[n, int(s)] for n, s in self._topo_tree.levels]
            meta["grad_comm_wires"] = list(self._grad_comm_wires)
            meta["modeled_comm_step_s"] = self._modeled_comm_step_s()
        if self._link_bw is not None:
            meta["link_bandwidth"] = dict(self._link_bw)

    def _setup_data(self, bundle: Optional[DatasetBundle]) -> None:
        cfg = self.cfg
        if bundle is None:
            n_cap = cfg.n_train or (2048 if cfg.debug else None)
            n_test = 2048 if cfg.debug else None
            bundle = load_dataset(cfg.dataset, cfg.data_dir, n_train=n_cap, n_test=n_test)
        self.bundle = bundle
        self.n_train = len(bundle.train_x)
        if bundle.synthetic:
            self.logger.info(
                f"dataset {cfg.dataset}: files not found, using the synthetic stand-in"
            )
        # the whole uint8 dataset lives on the device; epochs gather by index
        dev = self.device
        self.train_x = torch.from_numpy(np.ascontiguousarray(bundle.train_x)).to(dev)
        self.train_y = torch.from_numpy(bundle.train_y.astype(np.int64)).to(dev)
        self.test_x = torch.from_numpy(np.ascontiguousarray(bundle.test_x)).to(dev)
        self.test_y = torch.from_numpy(bundle.test_y.astype(np.int64)).to(dev)

    def _setup_model(self) -> None:
        cfg = self.cfg
        model = build_model(
            cfg.model,
            num_classes=self.bundle.num_classes,
            in_channels=self.bundle.train_x.shape[-1],
        )
        init_flax_defaults(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self._use_seeded_dropout()
        self.params: List[torch.nn.Parameter] = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate, cfg.momentum)
        self.grad_clip = cfg.grad_clip
        self.augment = cfg.dataset in ("cifar10", "cifar100")
        self.aug_gen = torch.Generator(device=self.device)

    def _rank_seed(self, seed: int) -> int:
        """A generator seed of this rank: ``seed`` itself on rank 0 (so a
        one-process run keeps its draws), offset on the others so that two
        ranks do not draw the same masks and crops."""
        return seed + _RANK_SEED_STRIDE * self.proc_id

    def _use_seeded_dropout(self) -> None:
        """Point every dropout of the model at the trainer's generator."""
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(
            self._rank_seed(self.cfg.seed))
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_gen

    def _make_injector(self) -> FaultInjector:
        """The JAX package's order: a straggler profile following a schedule
        (``--fault_schedule``), else a static one, else the reference's
        random faults (``-ft``), else none."""
        cfg = self.cfg
        if cfg.straggler and cfg.fault_schedule != "none":
            return ScheduledStragglerInjector(
                cfg.straggler_factors(),
                mode=cfg.fault_mode,
                schedule=cfg.fault_schedule,
                period=cfg.fault_period,
                seed=cfg.seed,
            )
        if cfg.straggler:
            return StaticStragglerInjector(cfg.straggler_factors(), mode=cfg.fault_mode)
        if cfg.fault_tolerance:
            return LuckyFaultInjector(
                cfg.world_size, cfg.fault_tolerance_chance, mode=cfg.fault_mode,
                seed=cfg.seed, logger=self.logger,
            )
        return NullInjector(cfg.world_size)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _elastic_mode(self) -> str:
        """How the training steps execute (``--superstep``), with the JAX
        package's names: ``"scan"`` (``auto``/``on``, one process whose
        workers share its device: a window's steps run without the host
        between them, here as step graphs replayed by ``StepGraphs``),
        ``"window"`` (several ranks, or ZeRO-1 on the quantized wire: each
        step's combine is a collective the next step's gradients depend on,
        so every step runs its rank's forward/backward, replayed from a step
        graph, then the collective and the update eagerly,
        ``_run_rank_windows``) or ``"step"`` (``off``: the eager per-step
        loop, the parity and host-overhead reference)."""
        if self.cfg.superstep == "off":
            return "step"
        if (self.topology.single_group and self.n_proc == 1
                and not (self.cfg.shard_update and self.cfg.compress_grads)):
            return "scan"
        return "window"

    # ------------------------------------------------------------------ run

    def run(self, epochs: Optional[int] = None) -> MetricsRecorder:
        """The JAX ``run``: restore from ``--ckpt_dir`` before the first
        epoch, save after each, make the last durable at the end; each
        epoch through ``_run_epoch_elastic_world`` under ``--elastic on``;
        the epochs under ``torch.profiler`` with ``--profile_dir``; the
        metrics and the trace saved at the end."""
        cfg = self.cfg
        epochs = cfg.epoch_size if epochs is None else epochs
        self.logger.info(
            f"Starting: {cfg.model}/{cfg.dataset}, ws={cfg.world_size}, "
            f"B={cfg.batch_size}, device={self.device}, dbs={cfg.dynamic_batch_size}"
        )
        start_epoch = 0
        if cfg.ckpt_dir:
            start_epoch = self._maybe_restore()
        prof = self._start_profiler() if cfg.profile_dir else None
        try:
            for epoch in range(start_epoch, epochs):
                if cfg.elastic == "on":
                    self._run_epoch_elastic_world(epoch)
                else:
                    self.run_epoch(epoch)
                if cfg.ckpt_dir:
                    self._save_checkpoint(epoch)
        finally:
            if prof is not None:
                self._stop_profiler(prof)
            if cfg.ckpt_dir:
                flush_checkpoints(cfg.ckpt_dir)
        if self.proc_id == 0:  # one artifact a run, as the reference's rank 0 writes
            self.recorder.save(cfg.stat_dir, cfg.base_filename())
        self.save_trace()
        self.logger.info(
            f"Total wallclock: {self.total_wallclock:.3f}s"
            + (f" (+{self.total_probe_s:.3f}s probe)" if self.total_probe_s > 0 else "")
        )
        return self.recorder

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        """One epoch in the graftscope ``epoch`` span: every event emitted
        inside is stamped with this epoch, which is what the offline
        attribution (``obs/scope_cli.py summarize``) groups by."""
        tr = self._trace
        tr.set_epoch(epoch)
        try:
            with tr.span("epoch", cat=EPOCH_CAT):
                return self._run_epoch(epoch)
        finally:
            tr.set_epoch(None)

    def _run_epoch(self, epoch: int) -> Dict[str, float]:
        # the phases tile the epoch span: plan_solve -> train -> validate -> record
        tr = self._trace
        with tr.span("plan_solve"):
            plan, faults = self._plan_epoch(epoch)
        # the epoch-boundary liveness round: a loss outside the elastic
        # epoch's window checks (the packed and fused paths) is caught
        # before any of this epoch's work
        self._check_health(epoch, 0.0)
        t_epoch = time.perf_counter()
        with tr.span("train"):
            train_metrics = self._dispatch_epoch(plan, faults, epoch)
        # the wall excludes the probes and the one-time FLOP count, as the
        # JAX package's does
        probe_s = train_metrics["dbs_probe_cost"] + train_metrics.get("probe_overhead", 0.0)
        epoch_wall = time.perf_counter() - t_epoch - probe_s
        self.total_wallclock += epoch_wall
        self.total_probe_s += probe_s
        with tr.span("validate"):
            val_loss, accuracy = self.validate()
        with tr.span("record"):
            self._record_epoch(
                epoch, plan, faults, train_metrics, epoch_wall, probe_s, val_loss, accuracy
            )
        return {
            "epoch_wall": epoch_wall,
            "loss": train_metrics["loss"],
            "val_loss": val_loss,
            "accuracy": accuracy,
        }

    # ---------------------------------------------------- trace and profile

    def _attach_spool(self) -> None:
        """The flight recorder: stream the tracer's events into a
        crash-durable spool (``obs/spool.py``), one file a process, named
        by its rank and pid as the JAX package names it."""
        from dynamic_load_balance_distributeddnn_tpu_torch.obs.spool import SpoolWriter

        cfg = self.cfg
        # the original ident and the pid: a respawned joiner shares its
        # dead predecessor's ident but never writes into its file
        path = os.path.join(cfg.trace_spool, f"proc{self._orig_proc_id}.{os.getpid()}.spool")
        self._spool_writer = SpoolWriter(
            path, ident=self._orig_proc_id, flush_interval_s=cfg.trace_spool_flush_s,
            fsync=cfg.trace_spool_fsync
        )
        self._trace.attach_spool(self._spool_writer)
        self.logger.info(
            f"flight recorder: trace spooling to {path} (flush every "
            f"{cfg.trace_spool_flush_s}s" + (", fsync" if cfg.trace_spool_fsync else "") + ")"
        )
        # drain on collection even when run() never completes, without
        # pinning the trainer
        import weakref

        weakref.finalize(self, self._spool_writer.close)

    def close_spool(self):
        """Drain and close the flight-recorder spool (idempotent); returns
        the closed writer, or None. Callers that drive epochs without
        ``run()`` call this."""
        if self._spool_writer is None:
            return None
        sp = self._trace.detach_spool()
        self._spool_writer = None
        if sp is not None:
            self.logger.info(f"flight recorder: spool closed ({sp.path}, {sp.bytes_written} bytes)")
        return sp

    def save_trace(self) -> Optional[str]:
        """Write the graftscope trace (Chrome-trace JSON under
        ``--trace_dir``, the config-encoded name) when tracing is on, after
        closing the spool; returns its path."""
        if not self._trace.enabled:
            return None
        self.close_spool()
        path = os.path.join(self.cfg.trace_dir,
                            self.cfg.base_filename().format(self.proc_id) + ".trace.json")
        self._trace.save(path)
        self.logger.info(
            f"graftscope trace saved: {path} ({self._trace.event_count()} events; "
            "obs/scope_cli.py summarize for the per-phase epoch attribution)"
        )
        return path

    def _start_profiler(self):
        """``torch.profiler`` over the epochs (``--profile_dir``, the JAX
        package's ``jax.profiler.start_trace``): CPU activity, and CUDA
        activity on a card. A profiler that fails to start raises."""
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
        return prof

    def _stop_profiler(self, prof) -> str:
        """Stop the profiler and export its Chrome trace into
        ``--profile_dir``; returns the path."""
        self._sync()
        prof.__exit__(None, None, None)
        os.makedirs(self.cfg.profile_dir, exist_ok=True)
        path = os.path.join(self.cfg.profile_dir,
                            self.cfg.base_filename().format(0) + ".pt.trace.json")
        prof.export_chrome_trace(path)
        self.recorder.meta["profile_trace"] = path
        self.logger.info(f"profiler trace saved: {path}")
        return path

    # ----------------------------------------------------------- checkpoints

    def _generators(self) -> Dict[str, torch.Generator]:
        """The generators a checkpoint carries (the language model has no
        augmentation generator)."""
        gens = {"dropout_gen": self.dropout_gen, "aug_gen": getattr(self, "aug_gen", None)}
        return {k: g for k, g in gens.items() if g is not None}

    def _save_checkpoint(self, epoch: int) -> None:
        """Epoch ``epoch``'s checkpoint (``train/checkpoint.py``) with the
        JAX sidecar's controller state, stamped with the live fleet
        (``active_ranks``: the survivors after a loss); its blocking wall
        goes to ``_meta["checkpoint"]["save_s"]``. Across processes the save
        is collective: ZeRO-1's chunks, the hier residuals and each rank's
        generator states are gathered, rank 0 writes, and the ranks meet at
        a barrier after the write."""
        t0 = time.perf_counter()
        rc = self._rank_combine
        with self._trace.span("checkpoint", cat="checkpoint", args={"epoch": int(epoch)}):
            self._sync()
            ranks = None
            if self.n_proc > 1:
                ranks = {"generators": allgather_object(
                    {k: g.get_state() for k, g in self._generators().items()})}
                if rc is not None and rc.axes is not None:
                    ranks["residuals"] = [r.to("cpu") for r in rc.residual_rows()]
                if self._rdzv is not None:
                    # whose rows these are: a re-rendezvous renumbers the ranks
                    ranks["idents"] = list(self._proc_roster)
            save_checkpoint(
                self.cfg.ckpt_dir, epoch, self.model, self.optimizer,
                {
                    "shares": self.shares,
                    "node_times": self.node_times,
                    "total_wallclock": self.total_wallclock,
                    "total_probe_s": self.total_probe_s,
                    # the JAX key: the fleet the checkpoint was taken at,
                    # which a resume after a loss adopts
                    "active_ranks": list(self.active_ranks),
                },
                steps=self.steps_done,
                generators=self._generators(),
                # ZeRO-1 keeps the momentum in its chunks, not the optimizer
                momentum=(rc.momentum_by_name()
                          if rc is not None and rc.shard_update else None),
                ranks=ranks,
                write=self.proc_id == 0,
                barrier=barrier if self.n_proc > 1 else None,
            )
        self.recorder.meta.setdefault("checkpoint", {}).setdefault("save_s", []).append(
            time.perf_counter() - t0)

    def _maybe_restore(self) -> int:
        """Restore the latest checkpoint under ``--ckpt_dir``; returns the
        first epoch to run (0 when there is none). The JAX package's
        single-process branch: the controller's vectors when their length
        fits the fleet (else uniform, with a warning) and its wall totals;
        under ``--elastic on`` a checkpoint stamped with a smaller fleet
        (saved after a loss) is resumed at that fleet (``_reshard_world``).
        The parameters and momentum buffers are written in place (the
        buffers made first, ``prepare_step_state``), so their addresses do
        not move; a step graph captured before the restore is dropped; the
        generators' states are set last, where ``StepGraphs`` reads them.
        Across processes every rank reads the file and takes its own ZeRO-1
        chunk, residual rows and generator states.

        ``--elastic on`` across processes is the JAX package's multi-host
        branch: the live rendezvous roster, not the checkpoint's stamp, is
        the fleet (a respawned joiner restores a checkpoint its survivor
        saved at the reduced fleet); the controller's vectors come from the
        sidecar through ``_adopt_controller_vectors``; a joiner publishes
        its own workers' probed costs before the restore barrier (a
        ``barrier()`` the survivors' grow rendezvous meets) and seeds the
        shares from the exchange after it. The JAX package needs a ZeRO-1
        restore template re-padded to the saved fleet
        (``_zero1_restore_template``); this port's checkpoint holds the
        momentum gathered into the one-process layout by parameter name,
        whose padding depends on no rank count, and ``load_momentum``
        re-chunks it at the live rank count, so no template is needed."""
        cfg = self.cfg
        t0 = time.perf_counter()
        rc = self._rank_combine
        elastic_mh = cfg.elastic == "on" and self.n_proc > 1
        joiner = elastic_mh and self._rdzv is not None and os.environ.get("DBS_MH_IDENT") is not None
        if joiner:
            own = {}
            for r in self._ranks_of_proc(self._orig_proc_id):
                c = self._probe_local_cost(int(r))
                if c is not None:
                    own[int(r)] = float(c)
            self._publish_probe_costs(own)
        with self._trace.span("checkpoint", cat="checkpoint", args={"restore": True}):
            prepare_step_state(self.optimizer)
            restored = restore_checkpoint(
                cfg.ckpt_dir, self.model, self.optimizer,
                load_momentum=rc.load_momentum if rc is not None and rc.shard_update else None)
            if restored is None:
                return 0
            epoch, state, controller = restored
            if self.supersteps.superstep_cache_size():
                self.supersteps.clear()
            self.steps_done = state["steps"]
            gens = state["generators"]
            if elastic_mh:
                gens = self._own_rank_state(state, gens, joiner)
            elif self.n_proc > 1:
                ranks = state.get("ranks") or {}
                if len(ranks.get("generators", ())) != self.n_proc:
                    raise ValueError(f"checkpoint {cfg.ckpt_dir}/{epoch} holds no state of "
                                     f"{self.n_proc} ranks: resume with the ranks that saved it")
                gens = ranks["generators"][self.proc_id]
                if rc is not None and rc.axes is not None:
                    rc.load_residual_rows(ranks["residuals"])
            for name, g in self._generators().items():
                if name in gens:
                    g.set_state(gens[name])
        saved_active = controller.get("active_ranks")
        if elastic_mh:
            # the LIVE rendezvous roster is the fleet, not the stamp
            live = sorted(r for r in range(cfg.world_size)
                          if self._proc_of_rank(r) in set(self._proc_roster))
            if live != self.active_ranks:
                self._reshard_world(live)
                self._fix_comm_residual()
                for r in range(cfg.world_size):
                    if r not in self.active_ranks:
                        self.health.mark_down(r)
            base = ([int(r) for r in saved_active]
                    if saved_active and all(0 <= int(r) < cfg.world_size for r in saved_active)
                    else list(self.active_ranks))
            if "shares" in controller and len(controller["shares"]) == len(base):
                self._adopt_controller_vectors(base, controller["shares"],
                                               controller.get("node_times", controller["shares"]))
            elif "shares" in controller:
                # a stamp from another layout: the fresh uniform vectors,
                # as the one-process branch below resets them
                self.logger.warning(
                    f"Resume: sidecar vectors ({len(controller['shares'])} entries) do not "
                    f"match the stamped fleet ({len(base)}) — resetting to uniform")
            if joiner:
                barrier()  # the restore barrier: every probe file is on disk past it
                self._collect_probe_seed()
        elif (cfg.elastic == "on" and saved_active is not None
                and sorted(int(r) for r in saved_active) != self.active_ranks
                and all(0 <= int(r) < cfg.world_size for r in saved_active)):
            # resume after a loss: the checkpointed survivor fleet
            self._reshard_world(sorted(int(r) for r in saved_active))
            self._fix_comm_residual()
            for r in range(cfg.world_size):
                if r not in self.active_ranks:
                    self.health.mark_down(r)
            self.logger.info(f"Resume: adopted checkpointed survivor fleet {self.active_ranks} "
                             f"(world size {self.world_size})")
        if not elastic_mh:
            for key, fallback in (
                ("shares", lambda: initial_partition(self.world_size)),
                ("node_times", lambda: np.ones(self.world_size, dtype=np.float64)),
            ):
                if key in controller:
                    vec = np.asarray(controller[key], dtype=np.float64)
                    if len(vec) == self.world_size:
                        setattr(self, key, vec)
                    else:
                        self.logger.warning(
                            f"Resume: checkpointed {key} has length {len(vec)} but the "
                            f"fleet is {self.world_size} — resetting to uniform"
                        )
                        setattr(self, key, fallback())
        if "total_wallclock" in controller:
            self.total_wallclock = float(controller["total_wallclock"])
        if "total_probe_s" in controller:
            self.total_probe_s = float(controller["total_probe_s"])
        self.recorder.meta.setdefault("checkpoint", {})["restore_s"] = time.perf_counter() - t0
        self.recorder.meta["checkpoint"]["restored_epoch"] = int(epoch)
        self.logger.info(f"Resumed from checkpoint at epoch {epoch}" + (
            f" over the live fleet {self.active_ranks} (roster {self._proc_roster})"
            if elastic_mh else ""))
        return epoch + 1

    def _own_rank_state(self, state: Dict, gens: Dict, joiner: bool = False) -> Dict:
        """This process's generator states from a checkpoint of the elastic
        tier across processes, and its residual rows loaded: the row of its
        original ident where the save names the idents (``ranks
        ["idents"]``: a re-rendezvous renumbers the ranks), else the
        ``ranks`` row of its rank when the saving world had this one's
        size; the top-level generators (the writer's) on rank 0 of a world
        that saved none (a world of one process). A joiner whose ident the
        reduced fleet's save does not hold keeps its own states, with a
        warning; any other process the save does not hold raises. The
        residual rows load (``RankCombine.load_residual_rows``, which
        raises where they do not fit) when the saving fleet is the live
        one; another fleet's rows mean nothing here, so they restart at
        zero (``_fix_comm_residual``)."""
        ranks = state.get("ranks") or {}
        rows = ranks.get("generators") or []
        idents = ranks.get("idents")
        ident = self._orig_proc_id
        if idents is not None and ident in idents:
            row, same_fleet = idents.index(ident), list(idents) == list(self._proc_roster)
        elif idents is None and rows and len(rows) == self.n_proc:
            row, same_fleet = self.proc_id, True
        elif not ranks and self.proc_id == 0 and not joiner:
            self._fix_comm_residual()
            return gens
        elif joiner:
            self.logger.warning(f"Resume: the checkpoint holds no state of joining process "
                                f"{ident}: it keeps its own generator states")
            self._fix_comm_residual()
            return {}
        else:
            raise ValueError(f"checkpoint {self.cfg.ckpt_dir} holds no state of process {ident} "
                             f"(rank {self.proc_id} of {self.n_proc}): resume with the ranks "
                             "that saved it")
        rc = self._rank_combine
        if rc is not None and rc.axes is not None:
            if same_fleet and "residuals" in ranks:
                rc.load_residual_rows(ranks["residuals"], row)
            else:
                self._fix_comm_residual()
        return rows[row]

    # ------------------------------------------------------- elastic world

    # --elastic on, one process (the JAX package's first tier): worker loss
    # is detected by health checks at the epoch start and at every window
    # boundary, fed by the preemption injector's schedule; ``detect_misses``
    # consecutive misses confirm it (``WorkerLost``), and the run survives:
    # re-solve over the survivors, re-shard, restore the epoch-start
    # snapshot and re-run the epoch. A worker that signals again is
    # readmitted at the next epoch boundary with a probe-seeded share.
    #
    # Across processes (the second tier): each process beacons a heartbeat
    # file under DBS_PEER_HB_DIR and a watcher thread marks a stale peer
    # (``_arm_peer_heartbeats``); the health checks scan the peers
    # (``_scan_peer_heartbeats``), and a collective that fails against a
    # dead peer is attributed to the beacons' verdict
    # (``_attribute_collective_failure``). A lost peer process is survived
    # by a re-rendezvous over the survivors (``_mh_rerendezvous``: agree,
    # tear the torch.distributed world down, establish a smaller one,
    # rebuild the data axis and the combine, restore the flushed checkpoint
    # and re-run the epoch); a respawned process that offers to join grows
    # the fleet back the same way at an epoch boundary.

    def _arm_peer_heartbeats(self) -> None:
        """The detection and recovery channel across processes (the JAX
        ``_arm_peer_heartbeats``): this process beacons its own file under
        DBS_PEER_HB_DIR, a watcher thread fires on a stale peer (it runs
        while the main thread is blocked in a collective against that peer:
        it logs, emits ``peer_stale`` and drops the marker
        ``elastic_detected_<peer>_by_proc<ident>.json``), and the beacon is
        tagged when the stall watchdog aborts this process. The rendezvous
        state machine is armed only when the world came up through
        ``rendezvous.elastic_initialize``; a world of the cli's stock
        ``initialize_multihost`` detects a loss and aborts (``_recover``)."""
        hb_dir = os.environ.get("DBS_PEER_HB_DIR")
        if not hb_dir:
            return
        if rdzv.elastic_world():
            self._rdzv = rdzv.RendezvousStateMachine(hb_dir, self._orig_proc_id,
                                                     logger=self.logger)
            roster = self._rdzv.current_roster()
            if len(roster) == self.n_proc:
                self._proc_roster = roster
        self._hb_beacon = ProcessHeartbeat(
            period_s=float(os.environ.get("DBS_PEER_HB_PERIOD_S", "1.0")))
        beacon_path = self._hb_beacon.beacon(hb_dir, f"proc{self._orig_proc_id}")
        self._hb_beacon_path = beacon_path
        # a stall-watchdog abort must be readable by the PEERS too
        register_exit_tag_path(beacon_path)
        # tie the beacon and watcher threads and the tag registration to
        # THIS trainer's lifetime (finalize must not capture self)
        import weakref

        beacon = self._hb_beacon

        def _teardown() -> None:
            beacon.stop()
            unregister_exit_tag_path(beacon_path)

        weakref.finalize(self, _teardown)
        stale_s = float(os.environ.get("DBS_PEER_HB_STALE_S", "10.0"))
        peers = [f"proc{p}" for p in self._proc_roster if p != self._orig_proc_id]
        # the watcher holds the callback: it must not capture self either
        logger, proc_id, tracer = self.logger, self._orig_proc_id, self._trace

        def _on_stale(ident: str, info: dict) -> None:
            reason = ProcessHeartbeat.stale_reason(info)
            logger.warning(
                f"elastic: peer {ident} unreachable ({reason}) — survivors will "
                "re-rendezvous at the next boundary (a collective against the dead "
                "peer fails or times out first)")
            tracer.instant("peer_stale", cat="elastic", args={"peer": ident, "reason": reason})
            rdzv._write_json(os.path.join(hb_dir, f"elastic_detected_{ident}_by_proc{proc_id}.json"),
                             {"peer": ident, "reason": reason})

        self._hb_beacon.watch(hb_dir, peers, stale_s, _on_stale)
        # re-armable for a grown fleet: a rejoined peer needs a fresh watch
        self._peer_watch = lambda idents: beacon.watch(hb_dir, idents, stale_s, _on_stale)
        self.logger.info(f"elastic: process heartbeat beacon + peer watcher armed under {hb_dir}"
                         + ("" if self._rdzv is not None else
                            " (no rendezvous channel: this world was not made elastic)"))

    def _ranks_of_proc(self, p: int) -> range:
        """ORIGINAL worker ranks owned by ORIGINAL process ``p``: the gen-0
        contiguous slice, the same across re-rendezvous."""
        wsp = self.cfg.world_size // max(self._n_proc0, 1)
        return range(p * wsp, (p + 1) * wsp)

    def _proc_of_rank(self, r: int) -> int:
        return int(r) // (self.cfg.world_size // max(self._n_proc0, 1))

    def _scan_peer_heartbeats(self, force: bool = False) -> set:
        """Original ranks owned by peers whose heartbeat files went stale,
        plus those of peers another survivor already claimed lost for this
        generation (the rendezvous loss files); empty in one process.
        Throttled to the heartbeat period unless ``force`` (the
        collective-failure attribution needs a fresh verdict now)."""
        hb_dir = os.environ.get("DBS_PEER_HB_DIR")
        if not hb_dir or self.n_proc == 1:
            return set()
        period_s = float(os.environ.get("DBS_PEER_HB_PERIOD_S", "1.0"))
        now = time.perf_counter()
        cached = self._peer_scan_cache
        if not force and cached is not None and now - cached[0] < period_s:
            return cached[1]
        stale_s = float(os.environ.get("DBS_PEER_HB_STALE_S", "10.0"))
        down: set = set()
        scan = ProcessHeartbeat.scan(hb_dir)
        claimed = self._rdzv.claimed_losses() if self._rdzv is not None else set()
        for p in self._proc_roster:
            if p == self._orig_proc_id:
                continue
            if p in claimed:
                # another survivor's published verdict
                down.update(self._ranks_of_proc(p))
                continue
            info = scan.get(f"proc{p}")
            if info is not None and ProcessHeartbeat.is_stale(info, stale_s):
                self.logger.warning(f"elastic: peer process {p} unreachable "
                                    f"({ProcessHeartbeat.stale_reason(info)})")
                down.update(self._ranks_of_proc(p))
        self._peer_scan_cache = (now, down)
        return down

    def _check_health(self, epoch: int, frac: float = 0.0) -> None:
        """One liveness round over the active fleet at epoch-time ``epoch +
        frac``: a worker the injector schedules down, or owned by a stale
        peer process, accrues a miss, and ``detect_misses`` of them in a
        row raise :class:`WorkerLost`. A dropped worker no longer down
        (past its confirmed loss time: the re-run epoch revisits earlier
        times) signals again and becomes RECOVERING, for
        ``_maybe_readmit``."""
        if self.cfg.elastic != "on":
            return
        t = float(epoch) + min(max(frac, 0.0), 0.999)
        down_workers = getattr(self.injector, "down_workers", None)
        down = set(down_workers(t)) if down_workers is not None else set()
        down |= self._scan_peer_heartbeats()
        confirmed = []
        for r in self.active_ranks:
            if r in down:
                if self._detect_t0 is None:
                    self._detect_t0 = time.perf_counter()  # the first miss seen
                if self.health.report_miss(r):
                    confirmed.append(r)
                    self._lost_t[r] = t
            else:
                self.health.report_alive(r)
        for r in self.health.lost():
            if r not in down and r not in self.active_ranks and t >= self._lost_t.get(r, -1.0):
                self.health.report_alive(r)
        if not any(r in down for r in self.active_ranks) and not confirmed:
            self._detect_t0 = None
        if confirmed:
            raise WorkerLost(confirmed)

    def _run_epoch_elastic_world(self, epoch: int) -> Dict[str, float]:
        """One epoch under ``--elastic on``: readmit recovered workers at
        the boundary, snapshot the state, and on a confirmed loss recover
        and re-run the epoch over the survivors from the snapshot (no
        example is half-applied), at most ``elastic_max_recoveries`` times
        in a run. Across processes a peer dying mid-collective surfaces as
        the collective's error before any health check runs: it is
        attributed to the beacons' verdict (``_attribute_collective_failure``)
        and recovered from like a confirmed loss, or re-raised."""
        self._maybe_readmit(epoch)
        while True:
            self._snapshot_epoch_state()
            try:
                return self.run_epoch(epoch)
            except WorkerLost as e:
                self._check_budget()
                self._recover(e.ranks, epoch)
            except Exception as e:  # noqa: BLE001 — attributed or re-raised
                lost = self._attribute_collective_failure(e, epoch)
                if lost is None:
                    raise
                self._check_budget()
                self.logger.warning(f"elastic: dispatch failure attributed to lost worker(s) "
                                    f"{lost} — recovering")
                self._recover(lost, epoch)

    def _check_budget(self) -> None:
        """Inside the handler of a loss: re-raise it once
        ``elastic_max_recoveries`` recoveries ran."""
        if self._recoveries >= self.cfg.elastic_max_recoveries:
            self.logger.error(
                f"elastic: recovery budget exhausted ({self._recoveries}) — giving up")
            raise

    def _attribute_collective_failure(self, e: Exception, epoch: int) -> Optional[List[int]]:
        """A failure inside the epoch across processes is usually a
        collective dying with a peer (gloo raises on the closed socket, or
        times out against a frozen peer, before the beacon reads stale).
        Hold the epoch for up to the staleness window plus 3 s and let the
        beacons' and the claims' verdict decide: the lost ranks, or None
        (re-raise: a real error, not a fleet change)."""
        if self.cfg.elastic != "on" or self.n_proc == 1 or self._hb_beacon is None:
            return None
        if self._detect_t0 is None:
            self._detect_t0 = time.perf_counter()
        stale_s = float(os.environ.get("DBS_PEER_HB_STALE_S", "10.0"))
        self.logger.warning(
            f"elastic: epoch {epoch} dispatch failed ({e!r}) — waiting up to "
            f"{stale_s + 3.0:.0f}s for a peer-liveness verdict before treating it as fatal")
        deadline = time.monotonic() + stale_s + 3.0
        while time.monotonic() < deadline:
            down = self._scan_peer_heartbeats(force=True)
            lost = sorted(r for r in self.active_ranks if r in down)
            if lost:
                return lost
            heartbeat()  # the wait is deliberate, not a stall
            time.sleep(0.25)
        return None

    def _snapshot_epoch_state(self) -> None:
        """The epoch-start state a recovery restores: an owned host copy of
        the training state (``_state_to_host``) and the controller's
        vectors. Its wall goes to ``_meta["elastic_snapshot_s"]``."""
        t0 = time.perf_counter()
        self._epoch_snap = {
            "state": self._state_to_host(),
            "shares": self.shares.copy(),
            "node_times": self.node_times.copy(),
            "per_example_cost": self.per_example_cost.copy(),
            "active": list(self.active_ranks),
            "total_wallclock": self.total_wallclock,
            "total_probe_s": self.total_probe_s,
        }
        self.recorder.meta.setdefault("elastic_snapshot_s", []).append(time.perf_counter() - t0)

    def _state_to_host(self) -> Dict[str, object]:
        """Owned CPU copies of the parameters, the momentum (the optimizer's
        buffers, made first where absent, ``prepare_step_state``; or
        ZeRO-1's chunk), the step counter and the generators' states. The
        live tensors are not rebound: ``_state_from_host`` copies back into
        them, so a captured step graph keeps its addresses."""
        prepare_step_state(self.optimizer)
        self._sync()
        rc = self._rank_combine
        return {
            "params": [p.detach().to("cpu", copy=True) for p in self.params],
            "momentum": [None if (b := self.optimizer.state.get(p, {}).get("momentum_buffer"))
                         is None else b.detach().to("cpu", copy=True) for p in self.params],
            "chunk": (rc.mom.detach().to("cpu", copy=True)
                      if rc is not None and rc.shard_update else None),
            "steps": self.steps_done,
            "generators": {k: g.get_state() for k, g in self._generators().items()},
        }

    @torch.no_grad()
    def _state_from_host(self, snap: Dict[str, object]) -> None:
        """Write a host snapshot back in place (``Tensor.copy_``). ZeRO-1's
        chunk comes back as it was, or zero where the combine was made after
        the snapshot (it was made from zero momentum)."""
        prepare_step_state(self.optimizer)
        for p, v in zip(self.params, snap["params"]):
            p.copy_(v)
        for p, m in zip(self.params, snap["momentum"]):
            buf = self.optimizer.state.get(p, {}).get("momentum_buffer")
            if buf is not None:
                buf.copy_(m) if m is not None else buf.zero_()
        rc = self._rank_combine
        if rc is not None and rc.shard_update:
            rc.mom.copy_(snap["chunk"]) if snap["chunk"] is not None else rc.mom.zero_()
        self.steps_done = int(snap["steps"])
        for name, g in self._generators().items():
            g.set_state(snap["generators"][name])

    def _reshard_world(self, active: List[int], new_world: bool = False) -> None:
        """Point the engine at a new active fleet (the JAX ``_reshard_world``):
        the world size, the topology of this process's workers on its
        device, the time keeper, the window controller (rebuilt lazily) and
        the probes' cached sync cost are fleet-shaped and made anew; every
        step graph is dropped (its key holds the old workers' batches). In
        one process the combine stays flat: one process has one device.
        Across processes each surviving process keeps its own gen-0 slice of
        the workers (loss is process-granular), at the compact ranks the
        sorted fleet gives it; ``new_world`` (after a re-rendezvous
        established another ``torch.distributed`` world) also rebuilds the
        data axis over the new default group (``parallel/mesh.py``), the
        ``--grad_comm`` resolution and the combine (``train/combine.py``) at
        the new rank count; in a world of one process there is no combine
        and every ``.grad`` is released, as a fresh one-process trainer
        has it. The device stays the process's own (its gen-0 ident's slice
        of the ``-gpu`` map), whatever rank the new world gives it. The
        caller restores the state (``_state_from_host``)."""
        self.active_ranks = sorted(int(r) for r in active)
        self.world_size = len(self.active_ranks)
        if self.world_size < 1:
            raise RuntimeError("elastic: no surviving workers")
        if self._n_proc0 > 1:
            mine = [r for r in self.active_ranks if self._proc_of_rank(r) == self._orig_proc_id]
            if not mine:
                raise RuntimeError("elastic: this process owns no surviving workers")
            self.ws_local, self.rank_lo = len(mine), self.active_ranks.index(mine[0])
        else:
            self.ws_local, self.rank_lo = self.world_size, 0
        self.topology = WorkerTopology.build(self.ws_local, [self.device], [0] * self.ws_local)
        self._worker_loss = torch.zeros(self.ws_local, device=self.device)
        self.supersteps.clear()
        self._superstep_keys = set()
        self._sync_per_step = 0.0
        self._fused_sync_per_step = None
        self.timekeeper = TimeKeeper(self.world_size)
        self._clean_compute_s = self._clean_examples = None
        self._peer_scan_cache = None
        # the controller's rate track and step-time model are fleet-shaped:
        # a new fleet, a new account; its executed switches stay recorded
        self._rebalance_ctl = None
        self.obs.controller = None
        self._switches_last = 0
        if new_world:
            self.mesh = data_mesh(self.device)  # a collective of the new world
            self.n_dev = axis_size(self.mesh)
            self.recorder.meta["ranks"] = self.mesh.describe()
            self._setup_grad_comm()
            self._record_grad_comm()
            # a replicated flag: the joiners of a grown world start without it
            self._probes_ran = False
            self._rank_combine = None
            if self.n_proc > 1:
                self._make_rank_combine()
            else:
                for p in self.params:
                    p.grad = None
        elif self._rank_combine is not None:
            self._rank_combine.collective_s = []

    def _recover(self, lost: List[int], epoch: int) -> None:
        """A confirmed loss (the JAX ``_recover``). Across processes: the
        JAX package's two refusals (no rendezvous channel; a loss confined
        to this process's own workers), else ``_recover_multihost``. In one
        process: flush the checkpoints, re-solve over the survivors from
        the epoch's snapshot (their shares renormalized, their cost anchors
        kept), re-shard, restore the snapshot's state, and record the event
        with its seconds from the first miss to resumed training; the run
        loop then re-runs the epoch."""
        if self.n_proc > 1:
            if self._rdzv is None:
                raise RuntimeError(
                    f"elastic: worker(s) {lost} lost but no rendezvous "
                    "channel is armed (set DBS_PEER_HB_DIR and bring the "
                    "world up through rendezvous.elastic_initialize) — "
                    "aborting for resume-from-checkpoint (see README "
                    "'Fault tolerance')"
                )
            if all(self._proc_of_rank(r) == self._orig_proc_id for r in lost):
                # peers see a live beacon and no claim: none would join a
                # rendezvous for it
                raise RuntimeError(
                    f"elastic: worker(s) {sorted(lost)} on THIS process "
                    "confirmed lost in a multi-process world — a "
                    "single-process worker shrink cannot change the "
                    "global mesh and no peer would join a rendezvous for "
                    "it; aborting for resume-from-checkpoint"
                )
            return self._recover_multihost(lost, epoch)
        cfg = self.cfg
        t0 = self._detect_t0 or time.perf_counter()
        snap = self._epoch_snap
        with self._trace.span("recover", cat="recover"):
            self._trace.instant("worker_lost", cat="elastic",
                                args={"ranks": sorted(int(r) for r in lost), "epoch": int(epoch)})
            self.logger.warning(f"elastic: worker(s) {sorted(lost)} confirmed lost at epoch "
                                f"{epoch} — re-solving over survivors")
            if cfg.ckpt_dir:
                # durable before the fleet changes: a crash mid-recovery
                # leaves a consistent checkpoint behind
                flush_checkpoints(cfg.ckpt_dir)
            for r in lost:
                self.health.mark_down(r)
            prev_active = snap["active"] if snap else list(self.active_ranks)
            survivors = [r for r in prev_active if r not in set(lost)]
            keep = [i for i, r in enumerate(prev_active) if r not in set(lost)]
            retry_transient(lambda: self._reshard_world(survivors), logger=self.logger,
                            desc="survivor re-shard")
            src = snap if snap is not None else {
                "shares": self.shares, "node_times": self.node_times,
                "per_example_cost": self.per_example_cost}
            shares = np.asarray(src["shares"])[keep]
            self.shares = shares / max(shares.sum(), 1e-12)
            self.node_times = np.asarray(src["node_times"])[keep]
            self.per_example_cost = np.asarray(src["per_example_cost"])[keep]
            if snap is not None:
                self.total_wallclock = snap["total_wallclock"]
                self.total_probe_s = snap["total_probe_s"]
                self._state_from_host(snap["state"])
            self._fix_comm_residual()
            self._sync()
            self._recoveries += 1
            self._detect_t0 = None
            dt = time.perf_counter() - t0
            ev = {"epoch": int(epoch), "lost": sorted(int(r) for r in lost),
                  "world_size": int(self.world_size), "detect_to_resume_s": round(dt, 4)}
            self._elastic_events.append(ev)
            self.recorder.meta["elastic_events"] = self._elastic_events
            self._trace.instant("recovered", cat="elastic", args=dict(ev))
            self.logger.info(
                f"elastic: recovered over {self.world_size} survivors {self.active_ranks} in "
                f"{dt:.3f}s (detection to resumed training); epoch re-runs from the snapshot")

    def _fix_comm_residual(self) -> None:
        """Re-base the error-feedback residuals on the current combine after
        a fleet change (the JAX ``_fix_comm_residual``): the old fleet's
        rows mean nothing to another one, so they restart at zero. One
        process combines flat (``--grad_comm hier`` needs ranks), so this
        finds no residual there."""
        rc = self._rank_combine
        if rc is not None and rc.axes is not None:
            rc.residuals = [torch.zeros_like(r) for r in rc.residuals]

    def _adopt_controller_vectors(self, base_active, shares, node_times, cost=None) -> None:
        """Seed the compact controller vectors of the CURRENT active fleet
        from a PREVIOUS fleet's (the checkpoint's sidecar or the epoch
        snapshot): survivors keep their entries, newcomers take the
        survivors' mean, the shares renormalize. A pure function of the
        source vectors and the rosters, so every surviving process, and a
        freshly joined one reading the same sidecar, derives the same seed
        (the replicated controller across a fleet change)."""
        base = [int(r) for r in base_active]
        sel = {r: i for i, r in enumerate(base)}

        def fill(vec, fallback):
            src = np.asarray(vec, dtype=np.float64)
            out = np.full(self.world_size, np.nan)
            for i, r in enumerate(self.active_ranks):
                if r in sel and sel[r] < len(src):
                    out[i] = src[sel[r]]
            mean = np.nanmean(out) if np.isfinite(out).any() else fallback
            out[~np.isfinite(out)] = mean
            return out

        sh = fill(shares, 1.0 / max(self.world_size, 1))
        self.shares = sh / max(sh.sum(), 1e-12)
        self.node_times = np.maximum(fill(node_times, 1.0), 1e-9)
        if cost is not None:
            self.per_example_cost = fill(cost, np.nan)
        else:
            self.per_example_cost = np.full(self.world_size, np.nan)

    def _mh_rdzv_failed(self, e: Exception, epoch: int) -> None:
        """A rendezvous phase died (hard timeout, eviction, a failed
        connect or teardown): degrade to abort-and-resume, loudly. The
        beacon is tagged with the phase, so peers and the launcher read an
        abort rather than a silent freeze; the event lands in the
        recorder's meta; the raise unwinds the run."""
        phase = getattr(e, "phase", "unknown")
        msg = (
            f"elastic: multi-host re-rendezvous FAILED in phase "
            f"'{phase}' ({e}) — degrading to abort-and-resume-from-"
            "checkpoint"
        )
        self.logger.error(msg)
        self._trace.instant("rdzv_failed", cat="rdzv",
                            args={"phase": str(phase), "epoch": int(epoch)})
        if self._hb_beacon_path:
            tag_exit_reason(self._hb_beacon_path, f"rendezvous failed: {phase}")
        self._elastic_events.append({"epoch": int(epoch), "rdzv_failed_phase": str(phase)})
        self.recorder.meta["elastic_events"] = self._elastic_events
        raise RuntimeError(msg) from e

    def _recover_multihost(self, lost: List[int], epoch: int) -> None:
        """A confirmed PEER-PROCESS loss: publish the verdict (a peer whose
        beacon scan lags adopts it instead of dispatching another
        collective at the dead process), then re-rendezvous over the
        survivors."""
        if self.cfg.shard_update:
            # recorded exclusion, the JAX package's
            raise RuntimeError(
                f"elastic: worker(s) {sorted(lost)} lost but multi-host "
                "re-rendezvous does not compose with --shard_update yet — "
                "aborting for resume-from-checkpoint"
            )
        dead_procs = sorted({self._proc_of_rank(r) for r in lost} - {self._orig_proc_id})
        self.logger.warning(
            f"elastic: worker(s) {sorted(lost)} (peer process(es) {dead_procs}) confirmed lost "
            f"at epoch {epoch} — re-rendezvousing over survivors")
        self._trace.instant("peer_lost", cat="elastic",
                            args={"ranks": sorted(int(r) for r in lost),
                                  "procs": [int(p) for p in dead_procs], "epoch": int(epoch)})
        for r in lost:
            self.health.mark_down(r)
        self._rdzv.claim_loss(dead_procs, epoch)
        survivors = [r for r in self.active_ranks if r not in set(lost)]
        self._mh_rerendezvous(epoch, survivors, lost=sorted(lost))

    def _maybe_regrow_multihost(self, epoch: int) -> None:
        """The epoch-boundary grow: (re)spawned processes that offered to
        join (``join_p*.json`` and a fresh beacon) are admitted by the same
        rendezvous with them in the roster. Refused without ``--ckpt_dir``:
        the shared checkpoint is a joiner's only source of the replicated
        state.

        Every survivor must grow at the same boundary, or one enters the
        rendezvous while another enters the epoch's first collective and
        both wait out their timeouts. The JAX package lets each survivor
        read the directory at its own boundary, which races an offer that
        lands between two survivors' reads (seen with three processes);
        here process 0's reading is broadcast to the others, so the
        decision is one. A broadcast that fails (a peer died at the
        boundary) skips the grow: the epoch's first collective fails too
        and is attributed as any loss. After a grow the decision is taken
        again at the same boundary, by the grown world: a joiner's first
        boundary is that one, and its decision pairs with the survivors'."""
        while self._rdzv is not None and self._grow_once(epoch):
            pass

    def _grow_once(self, epoch: int) -> bool:
        """One grow decision at the boundary of ``epoch`` (see
        ``_maybe_regrow_multihost``); True when the fleet grew."""
        alive = self._rdzv.alive_procs()
        joins = sorted(p for p in self._rdzv.pending_joins()
                       if p in alive and p not in set(self._proc_roster))
        if self.n_proc > 1:
            try:
                joins = broadcast_object(joins)
            except Exception as e:  # noqa: BLE001 — attributed at the next collective
                self.logger.warning(f"elastic: the grow decision's broadcast failed ({e!r}) — "
                                    "no grow at this boundary")
                return False
        if not joins:
            return False
        if not self.cfg.ckpt_dir:
            self.logger.warning(
                f"elastic: process(es) {joins} offered to join at epoch {epoch} but no "
                "--ckpt_dir is configured — a joiner cannot adopt the replicated state; "
                "refusing the grow")
            return False
        self.logger.info(f"elastic: process(es) {joins} offering to join at epoch {epoch} — "
                         "re-rendezvousing to grow the fleet")
        active = sorted(set(self.active_ranks) | {r for p in joins for r in self._ranks_of_proc(p)})
        self._mh_rerendezvous(epoch, active, joining=joins)
        for p in joins:
            self._rdzv.clear_join(p)
        return True

    def _mh_rerendezvous(self, epoch: int, target_active: List[int], lost=(), joining=()) -> None:
        """The shrink/grow spine (the JAX ``_mh_rerendezvous``): flush ->
        agree -> drain and retire -> establish -> rebuild (re-shard over the
        new world, restore) -> re-seed. Every blocking phase is bounded
        (the state machine's timeouts, the teardown's), and a failed phase
        degrades through ``_mh_rdzv_failed``. Shrink restores the
        interrupted epoch's start (the flushed checkpoint of the epoch
        before, else the snapshot); grow runs at a boundary and restores
        the same checkpoint the joiner's engine restores. Nothing of the
        dead world's step survives: the graphs and the combine (its flat
        gradient buffer) are dropped before the teardown, and the
        parameters and momentum are overwritten from the restore source.
        The event records each phase's seconds (``phase_s``) and the wall
        clock at the resume (``resumed_unix``: a launcher that knows when
        the peer died reads the recovery a user sees from it;
        ``detect_to_resume_s`` starts at the first failed collective or
        stale beacon, after the loss)."""
        cfg = self.cfg
        t0 = self._detect_t0 or time.perf_counter()
        phase_s: Dict[str, float] = {}
        with self._trace.span("recover_mh", cat="recover"):
            # 1. the checkpoint durable
            if cfg.ckpt_dir:
                flush_checkpoints(cfg.ckpt_dir)
                heartbeat()
            # 2. the host-side source: the interrupted epoch's start, or
            # (grow, at a boundary) the live state
            snap = self._epoch_snap if not joining else None
            if snap is not None:
                host_state, prev_active = snap["state"], list(snap["active"])
                src = {"shares": snap["shares"], "node_times": snap["node_times"],
                       "cost": snap["per_example_cost"]}
                self.total_wallclock = snap["total_wallclock"]
                self.total_probe_s = snap["total_probe_s"]
            else:
                host_state, prev_active = self._state_to_host(), list(self.active_ranks)
                src = {"shares": self.shares.copy(), "node_times": self.node_times.copy(),
                       "cost": self.per_example_cost.copy()}
            # 3. roster consensus
            t = time.perf_counter()
            try:
                agreement = self._rdzv.agree(
                    lambda: self._rdzv.alive_procs() - self._rdzv.claimed_losses(), epoch)
            except rdzv.RendezvousError as e:
                self._mh_rdzv_failed(e, epoch)
            phase_s["agree"] = time.perf_counter() - t
            roster = list(agreement.roster)
            # the agreed roster is authoritative: drop the ranks of a process
            # that died during the rendezvous, admit one that raced its join
            active = [r for r in target_active if self._proc_of_rank(r) in set(roster)]
            for p in roster:
                if all(self._proc_of_rank(r) != p for r in active):
                    active.extend(self._ranks_of_proc(p))
            active = sorted(set(active))
            # 4. nothing of the dying world survives the teardown: its step
            # graphs, its combine (the flat gradient buffer a staged
            # collective may have half-written), its snapshot
            t = time.perf_counter()
            self.supersteps.clear()
            self._superstep_keys = set()
            self._rank_combine = None
            self._epoch_snap = None
            rdzv.drain_collective_chain(self.device, logger=self.logger, tick=heartbeat)
            try:
                rdzv.retire_runtime(self.mesh)
            except rdzv.RendezvousError as e:
                self._mh_rdzv_failed(e, epoch)
            phase_s["teardown"] = time.perf_counter() - t
            # 5. the new world (the payload is for joiners; survivors are
            # replicated-deterministic and ignore it)
            t = time.perf_counter()
            try:
                self._rdzv.establish(
                    agreement,
                    payload=({"epoch": int(agreement.epoch), "active": active}
                             if agreement.leader else None))
            except rdzv.RendezvousError as e:
                self._mh_rdzv_failed(e, epoch)
            phase_s["establish"] = time.perf_counter() - t
            self.n_proc = len(roster)
            self.proc_id = agreement.rank
            self._proc_roster = roster
            if joining:
                # the grow's probe exchange: this process's carried costs,
                # published before the restore barrier
                cost = np.asarray(src["cost"])
                self._publish_probe_costs({
                    r: float(cost[prev_active.index(r)])
                    for r in self._ranks_of_proc(self._orig_proc_id) if r in prev_active})
            # 6. rebuild over the new world and restore; with several
            # survivors the round is voted, so all adopt it or all abort
            t = time.perf_counter()
            try:
                rdzv.quarantine_runtime(self.device, logger=self.logger, tick=heartbeat)
            except rdzv.RendezvousError as e:
                self._mh_rdzv_failed(e, epoch)
            restored_from, ctl, rebuild_err = "epoch snapshot", None, None
            try:
                self._reshard_world(active, new_world=True)
                self._state_from_host(host_state)
                if cfg.ckpt_dir:
                    got = restore_checkpoint(cfg.ckpt_dir, self.model, self.optimizer)
                    if got is not None and int(got[0]) == epoch - 1:
                        ctl = got[2]
                        restored_from = f"checkpoint[{int(got[0])}]"
                        self.steps_done = int(got[1]["steps"])
                        gens = self._own_rank_state(got[1], got[1]["generators"])
                        for name, g in self._generators().items():
                            if name in gens:
                                g.set_state(gens[name])
                    elif got is not None:
                        self.logger.warning(
                            f"elastic: latest checkpoint is epoch {got[0]}, not {epoch - 1} — "
                            "resuming from the epoch-start snapshot instead")
                        self._state_from_host(host_state)
                self._fix_comm_residual()
                rdzv.local_canary_launch(self.device)
            except Exception as e:  # noqa: BLE001 — voted below, then degraded
                rebuild_err = e
            survivors = [p for p in roster if p not in set(joining)]
            if len(survivors) > 1:
                try:
                    self._rdzv.rebuild_vote(0, ok=rebuild_err is None)
                    if not self._rdzv.rebuild_settled(survivors, 0) and rebuild_err is None:
                        rebuild_err = rdzv.RendezvousError("world rebuild", "voted down by a peer")
                except rdzv.RendezvousError as e:
                    self._mh_rdzv_failed(e, epoch)
            if rebuild_err is not None:
                self._mh_rdzv_failed(rdzv.RendezvousError(
                    "world rebuild", f"never settled: {rebuild_err!r}"), epoch)
            # 7. controller seeding: the sidecar's vectors where the
            # checkpoint was the source (the same bytes on every process),
            # else the replicated snapshot's; restricted to the survivors
            # or mean-filled for joiners, the shares renormalized
            if (ctl and "shares" in ctl and ctl.get("active_ranks") is not None
                    and len(ctl["shares"]) == len(ctl["active_ranks"])):
                self._adopt_controller_vectors(ctl["active_ranks"], ctl["shares"],
                                               ctl.get("node_times", ctl["shares"]))
            else:
                self._adopt_controller_vectors(prev_active, src["shares"], src["node_times"],
                                               src["cost"])
            if joining:
                barrier()  # the restore barrier the joiners' _maybe_restore meets
                self._collect_probe_seed()
            for p in joining:
                for r in self._ranks_of_proc(p):
                    self.health.readmit(r)
            self._sync()
            phase_s["restore"] = time.perf_counter() - t
            heartbeat()  # the new world answered
            if joining and self._peer_watch is not None:
                self._peer_watch([f"proc{p}" for p in joining])
            self._recoveries += 1
            self._detect_t0 = None
            dt = time.perf_counter() - t0
            ev = {"epoch": int(epoch), "world_size": int(self.world_size),
                  "rdzv_gen": int(agreement.gen), "roster": [int(p) for p in roster],
                  "detect_to_resume_s": round(dt, 4), "restored_from": restored_from,
                  "phase_s": {k: round(v, 4) for k, v in phase_s.items()},
                  "resumed_unix": time.time()}
            if lost:
                ev["lost"] = [int(r) for r in lost]
            if joining:
                ev["readmitted"] = [int(r) for p in joining for r in self._ranks_of_proc(p)]
            self._elastic_events.append(ev)
            self.recorder.meta["elastic_events"] = self._elastic_events
            self._trace.instant("mh_recovered", cat="elastic", args=dict(ev))
            self.logger.info(
                f"elastic: re-rendezvous g{agreement.gen} complete — {self.world_size} workers "
                f"over {self.n_proc} process(es) {roster}, state from {restored_from}, "
                f"{dt:.3f}s detection to resumed training")

    def _maybe_readmit(self, epoch: int) -> None:
        """Readmission at the epoch boundary: workers whose rejoin boundary
        is ``epoch`` (the injector's schedule) or that signal again (health
        RECOVERING), and are not down at the boundary, re-enter the fleet.
        Each newcomer's cost an example comes from one standalone probe
        step (``_probe_readmitted``), or the others' mean; the shares seed
        at the solver's equilibrium of the costs (share ∝ 1 / cost) and the
        node times at cost × share, so the next rebalance starts at its
        fixed point. A fleet of several processes at generation 0 grows
        by process instead, through the rendezvous
        (``_maybe_regrow_multihost``), even once it shrank to one."""
        cfg = self.cfg
        if cfg.elastic != "on" or cfg.elastic_readmit != "epoch":
            return
        if self._rdzv is not None and self._n_proc0 > 1:
            self._maybe_regrow_multihost(epoch)
            return
        rejoin = set(self.health.recovering())
        rejoining = getattr(self.injector, "rejoining", None)
        if rejoining is not None:
            rejoin |= set(rejoining(epoch))
        if self._n_proc0 > 1:
            # a dead PEER's ranks re-enter by a process rejoin, never as
            # this process's local workers
            rejoin = {r for r in rejoin if self._proc_of_rank(r) in set(self._proc_roster)}
        down_workers = getattr(self.injector, "down_workers", None)
        down_now = set(down_workers(float(epoch))) if down_workers is not None else set()
        down_now |= self._scan_peer_heartbeats()
        cands = sorted(r for r in rejoin if r not in self.active_ranks and r not in down_now
                       and 0 <= r < cfg.world_size)
        if not cands:
            return
        with self._trace.span("readmit", cat="recover"):
            self._trace.instant("readmitted", cat="elastic",
                                args={"ranks": [int(r) for r in cands], "epoch": int(epoch)})
            self.logger.info(f"elastic: readmitting worker(s) {cands} at epoch {epoch}")
            if cfg.ckpt_dir:
                flush_checkpoints(cfg.ckpt_dir)
            host_state = self._state_to_host()
            prev_active = list(self.active_ranks)
            prev_cost = self.per_example_cost.copy()
            retry_transient(lambda: self._reshard_world(sorted(prev_active + cands)),
                            logger=self.logger, desc="readmission re-shard")
            self._state_from_host(host_state)
            self._fix_comm_residual()
            cost = np.full(self.world_size, np.nan)
            for i, r in enumerate(self.active_ranks):
                if r in prev_active:
                    cost[i] = prev_cost[prev_active.index(r)]
            fallback = float(np.nanmean(prev_cost)) if np.isfinite(prev_cost).any() else np.nan
            for r in cands:
                i = self.active_ranks.index(r)
                # the health slot first: readmit() resets the latency track
                # the probe feeds
                self.health.readmit(r)
                probed = self._probe_readmitted(i)
                cost[i] = probed if probed is not None else fallback
            self.per_example_cost = cost
            if np.isfinite(cost).all() and (cost > 0).all():
                self.shares = equilibrium_shares(cost)
                self.node_times = np.maximum(cost * self.shares, 1e-9)
            else:
                self.shares = initial_partition(self.world_size)
                self.node_times = np.ones(self.world_size, dtype=np.float64)
            ev = {"epoch": int(epoch), "readmitted": [int(r) for r in cands],
                  "world_size": int(self.world_size),
                  "seeded_shares": [round(float(s), 4) for s in self.shares]}
            self._elastic_events.append(ev)
            self.recorder.meta["elastic_events"] = self._elastic_events
            self.logger.info(f"elastic: fleet back to {self.world_size} workers "
                             f"{self.active_ranks}; probe-seeded shares "
                             f"{np.round(self.shares, 4).tolist()}")

    def _dummy_batch(self, b: int):
        """``b`` rows of the training set, normalised (no augmentation
        draw), weight ``1 / b`` each: a readmission probe's batch."""
        x = normalize_images(self.train_x[:b], self.bundle.mean, self.bundle.std)
        x = x if self.compute_dtype is None else x.to(self.compute_dtype)
        return x, self.train_y[:b], torch.full((x.shape[0],), 1.0 / x.shape[0], device=self.device)

    def _probe_readmitted(self, compact_rank: int) -> Optional[float]:
        """A readmitted worker's seconds an example from one standalone
        forward/backward on the card (``_probe_cost``), its latency fed to
        the health verdicts. None under a timing model (the caller seeds
        from the others' mean). A probe that fails raises: on the card it
        is a kernel's failure."""
        if self.timing_model is not None:
            return None
        dt, rows = self._probe_cost()
        self.health.observe_latency(self.active_ranks[compact_rank], dt)
        return max(dt, 1e-9) / rows  # an example: a column for the LM

    def _probe_cost(self) -> "tuple[float, int]":
        """One standalone forward/backward (a warm run, then the least of 2
        timed runs) of the equal split's batch, ``batch_size /
        world_size`` rows (at least ``bucket``): ``(seconds, rows)``. The
        dropout generator's state is put back, and nothing else of the
        training state is touched.

        The JAX package probes ``bucket`` rows. Every worker of this port
        shares one card, where a step of 16 rows is bound by its launches,
        not its rows: its cost an example read 5-8x the others' on an
        H100 and seeded a share of 0.05, which the inverse-time solver then
        held (the small batch kept its step slow; ``PERF.md`` §6)."""
        batch = self._dummy_batch(max(self.cfg.bucket, self.cfg.batch_size // self.world_size, 1))
        state = self.dropout_gen.get_state()
        try:
            probe_grads(self.model, self.params, batch, self.grad_clip, None, 0, self.compute_dtype)
            dt = float("inf")
            for _ in range(2):
                self._sync()
                t0 = time.perf_counter()
                probe_grads(self.model, self.params, batch, self.grad_clip, None, 0,
                            self.compute_dtype)
                self._sync()
                dt = min(dt, time.perf_counter() - t0)
        finally:
            self.dropout_gen.set_state(state)
        return dt, int(batch[0].shape[0])

    def _probe_local_cost(self, r: int) -> Optional[float]:
        """Seconds an example of this process's own original worker ``r``
        (the JAX ``_probe_local_cost``): one probe on this process's device,
        no collective. None under a timing model or for a rank this process
        does not own: the exchange then publishes nothing for it."""
        if self.timing_model is not None or self._proc_of_rank(r) != self._orig_proc_id:
            return None
        dt, rows = self._probe_cost()
        return max(dt, 1e-9) / rows

    def _publish_probe_costs(self, costs: Dict[int, float]) -> None:
        """This process's finite positive per-rank costs into the grow
        rendezvous's probe exchange (``RendezvousStateMachine
        .publish_probe``); an empty publication is deliberate: peers must
        not wait on a process that measured nothing."""
        if self._rdzv is None:
            return
        self._rdzv.publish_probe({int(r): float(c) for r, c in costs.items()
                                  if np.isfinite(c) and float(c) > 0.0})

    def _collect_probe_seed(self) -> bool:
        """The grow's share seeding (the JAX ``_collect_probe_seed``): every
        roster member's publication read, the shares seeded at the
        equilibrium of the union and the node times at cost × share; a pure
        function of the files, so survivors and joiners derive the same
        vectors. False (the sidecar's mean-fill seed stands, alike on every
        process) when a member's file misses the bounded window or a
        worker's cost stays unknown."""
        if self._rdzv is None:
            return False
        merged = self._rdzv.collect_probes(self._proc_roster)
        if merged is None:
            self.logger.warning("elastic: probe exchange incomplete — keeping the "
                                "survivor-mean seed for joined workers")
            return False
        cost = np.full(self.world_size, np.nan)
        for i, r in enumerate(self.active_ranks):
            c = merged.get(int(r))
            if c is not None and np.isfinite(c) and c > 0.0:
                cost[i] = c
        if not np.isfinite(cost).all():
            return False
        self.per_example_cost = cost
        self.shares = equilibrium_shares(cost)
        self.node_times = np.maximum(cost * self.shares, 1e-9)
        self.logger.info(f"elastic: probe exchange seeded equilibrium shares "
                         f"{np.round(self.shares, 4).tolist()} over "
                         f"{len(self._proc_roster)} process(es)")
        return True

    # ----------------------------------------------------------------- epoch

    def _plan_epoch(self, epoch: int):
        """LR schedule, solver rebalance with the capacity cap and bucket
        snapping, plan build and the epoch's faults (JAX ``_plan_epoch``)."""
        cfg = self.cfg
        lr = one_cycle_lr(
            cfg.learning_rate,
            epoch,
            cfg.epoch_size,
            enabled=cfg.one_cycle_policy,
            disable_enhancements=cfg.disable_enhancements,
        )
        if lr != learning_rate(self.optimizer):
            set_learning_rate(self.optimizer, lr)

        if cfg.dynamic_batch_size:
            max_share = min(1.0, cfg.capacity_factor / self.world_size)
            # the solver's own span inside plan_solve, as the JAX solver's
            with self._trace.span("rebalance", cat="solve"):
                self.shares, batch_sizes = rebalance(
                    self.node_times, self.shares, cfg.batch_size, max_share=max_share
                )
            if cfg.snap_to_bucket and self.SNAP_BATCHES:
                batch_sizes = quantize_batches(batch_sizes, cfg.bucket, cfg.batch_size)
                self.shares = batch_sizes.astype(np.float64) / batch_sizes.sum()
            self.logger.info(
                f"Epoch {epoch}: adjusted shares to {np.round(self.shares, 4).tolist()}"
            )
        else:
            batch_sizes = integer_batch_split(self.shares, cfg.batch_size)

        plan = self._build_plan(epoch, batch_sizes)
        self.logger.info(
            f"Epoch {epoch}: batch sizes {plan.batch_sizes.tolist()}, "
            f"steps {plan.num_steps}"
        )
        # the injector speaks the original ranks (its schedule outlives a
        # fleet change): the compact vectors scattered to it, its faults
        # read back at the active ranks
        ctx = FaultContext(
            batch_sizes=self._scatter_full(plan.batch_sizes.astype(np.float64)),
            iter_cost_s=(
                (self._iter_cost_s or self.load.calibrate_iter_cost(self.device))
                if self._needs_iter_cost
                else None
            ),
            per_example_cost_s=(
                self._scatter_full(self.per_example_cost)
                if np.isfinite(self.per_example_cost).all() else None
            ),
        )
        faults = self._faults_active(self.injector.epoch_faults(epoch, plan.num_steps, ctx))
        self._probe_this_epoch = self._should_probe(epoch, plan, faults)
        return plan, faults

    def _scatter_full(self, vec: np.ndarray) -> np.ndarray:
        """A compact vector over the active fleet as one over the original
        ranks (zeros at lost workers); the identity on a whole fleet."""
        if len(self.active_ranks) == self.cfg.world_size:
            return vec
        full = np.zeros(self.cfg.world_size, dtype=np.float64)
        full[self.active_ranks] = np.asarray(vec, dtype=np.float64)
        return full

    def _faults_active(self, faults: EpochFaults) -> EpochFaults:
        """The injector's faults over the original ranks, read at the
        active ones; the identity on a whole fleet."""
        if len(self.active_ranks) == self.cfg.world_size:
            return faults
        sel = np.asarray(self.active_ranks)
        return EpochFaults(
            virtual_seconds=faults.virtual_seconds[sel],
            slow_iters_per_step=faults.slow_iters_per_step[sel],
            time_multipliers=faults.time_multipliers[sel],
        )

    def _build_plan(self, epoch: int, batch_sizes: np.ndarray):
        cfg = self.cfg
        return build_epoch_plan(
            self.n_train,
            self.shares,
            batch_sizes,
            cfg.batch_size,
            epoch,
            seed=cfg.seed,
            bucket=cfg.bucket,
        )

    # ------------------------------------------------------ probe scheduling

    def _epoch_signature(self, plan, faults: EpochFaults) -> tuple:
        """What the wall-reference comparison must hold fixed: the plan's
        batch layout and the realized injection arrays."""
        return (
            tuple(int(b) for b in plan.batch_sizes),
            tuple(int(s) for s in faults.slow_iters_per_step),
            tuple(float(m) for m in faults.time_multipliers),
            tuple(float(v) for v in faults.virtual_seconds),
        )

    def _episode_state(self, plan, faults: EpochFaults):
        """Plan-normalized injection state for the episode-change trigger.
        Compute-mode iterations scale with each worker's batch, so raw
        iterations alone would read every rebalance as a new episode; the
        per-example iteration ratio does not move with the plan."""
        raw = np.asarray(faults.slow_iters_per_step, dtype=np.float64)
        ratio = raw / np.maximum(np.asarray(plan.batch_sizes, dtype=np.float64), 1.0)
        return (
            ratio,
            raw,
            np.asarray(faults.time_multipliers, dtype=np.float64),
            np.asarray(faults.virtual_seconds, dtype=np.float64),
        )

    def _episode_changed(self, plan, faults: EpochFaults) -> bool:
        if self._probe_episode is None:
            return False
        ratio, raw, mult, virt = self._episode_state(plan, faults)
        r0, w0, m0, v0 = self._probe_episode
        if not np.array_equal(mult, m0) or not np.allclose(virt, v0, rtol=0.05, atol=1e-9):
            return True
        # a real episode change moves both views of the injected load, a
        # rebalance only one (batch-scaled injectors keep the ratio, the
        # wall-seconds ones the raw iterations); 25% hysteresis absorbs
        # rounding, and +eps makes an on/off transition trip both
        ratio_moved = np.abs(ratio - r0) > 0.25 * r0 + 1e-9
        raw_moved = np.abs(raw - w0) > 0.25 * w0 + 1e-9
        return bool(np.any(ratio_moved & raw_moved))

    def _should_probe(self, epoch: int, plan, faults: EpochFaults) -> bool:
        """The probe decision (``--probe_mode``): always with a timing model
        or under ``always``; under ``adaptive`` on epochs 0-1, then only
        while an anchor is missing, on an injection-episode change, or once
        ``_next_probe_epoch`` is reached (``_update_probe_schedule``)."""
        cfg = self.cfg
        if self.timing_model is not None:
            return True  # deterministic model, no probe cost (tests)
        if not (cfg.dynamic_batch_size or self._needs_iter_cost):
            return False
        if cfg.probe_mode == "always" or epoch < 2:
            return True
        lo, hi = self.rank_lo, self.rank_lo + self.ws_local
        if not np.isfinite(self.per_example_cost[lo:hi]).all():
            want = True
        elif self._needs_iter_cost and self._iter_cost_s is None:
            want = True
        elif self._episode_changed(plan, faults):
            want = True  # the injection episode changed: re-anchor on reality
        else:
            want = epoch >= self._next_probe_epoch
        if self.n_proc > 1:
            # the probes end in a collective, so every rank must probe the
            # same epochs: the local terms (the wall trigger, the iteration
            # cost) may differ, so OR the ranks' votes
            votes = exchange_times(np.array([1.0 if want else 0.0]))
            want = bool(np.any(np.asarray(votes) > 0.5))
        return want

    def _model_compute_times(self, plan, faults: EpochFaults) -> None:
        """A probe-free epoch: each worker's modeled compute, the anchored
        clean cost an example times its batch, plus the calibrated injected
        load, times its steps (the linear model the solver itself assumes)."""
        iter_cost = self._iter_cost_s or 0.0
        for r in range(self.world_size):
            w_plan = plan.workers[r]
            clean = float(self.per_example_cost[r]) * w_plan.batch_size
            inj = (
                iter_cost * float(faults.slow_iters_per_step[r])
                if self._needs_iter_cost
                else 0.0
            )
            self.timekeeper.add_compute(r, (clean + inj) * w_plan.steps)

    def _realized_injection_profile(self, plan, faults: EpochFaults):
        """Per-worker realized injected:clean compute multipliers in compute
        mode, ``(clean_r + iter_cost * slow_r) / clean_r``, from the paired
        in-step iteration cost and the clean anchor: the profile the run
        actually injected, beside the nominal one. None until both anchors
        exist."""
        if not np.isfinite(self.per_example_cost).all() or self._iter_cost_s is None:
            return None
        prof = np.ones(self.world_size, dtype=np.float64)
        for r in range(self.world_size):
            clean = float(self.per_example_cost[r]) * max(plan.workers[r].batch_size, 1)
            if clean <= 0:
                return None
            prof[r] = (clean + self._iter_cost_s * float(faults.slow_iters_per_step[r])) / clean
        return [round(float(p), 4) for p in prof]

    def _update_probe_schedule(
        self, epoch: int, plan, faults: EpochFaults, epoch_wall: float,
    ) -> None:
        cfg = self.cfg
        sig = self._epoch_signature(plan, faults)
        if self._probe_this_epoch:
            self._probe_sig = sig
            self._probe_episode = self._episode_state(plan, faults)
            self._probe_wall_ref = epoch_wall  # the wall excludes the probes
            self._next_probe_epoch = epoch + max(cfg.probe_every, 1)
            self._slow_streak = 0
        elif self._probe_wall_ref and sig != self._probe_sig:
            # the plan changed on a skipped epoch: re-base the reference on
            # this epoch's wall, or the slowdown trigger would be inert
            # until the next probe_every anchor
            self._probe_sig = sig
            self._probe_wall_ref = epoch_wall
            self._slow_streak = 0
        elif self._probe_wall_ref and sig == self._probe_sig:
            if epoch_wall > (1.0 + cfg.probe_wall_tol) * self._probe_wall_ref:
                # only a persistent slowdown (two epochs in a row) forces a
                # re-probe; one slow epoch is indistinguishable from jitter
                self._slow_streak += 1
                if self._slow_streak >= 2:
                    self._next_probe_epoch = epoch + 1
            else:
                self._slow_streak = 0

    # ---------------------------------------------------------- train epoch

    @property
    def _cap_packed(self) -> int:
        """The packed step's width bound, the JAX package's: with bucket
        snapping every plan's widths are bucket multiples summing to at
        most ``ceil(B / bucket) * bucket``; without it per-worker padding
        may pass B, so the bound is ``B + ws * bucket``; with the balancer
        off, the uniform split's padded width."""
        cfg = self.cfg
        B, ws, bucket = cfg.batch_size, self.world_size, cfg.bucket
        if not cfg.dynamic_batch_size:
            per_batch = -(-B // ws)
            return ws * (-(-per_batch // bucket) * bucket)
        if cfg.snap_to_bucket and self.SNAP_BATCHES and B // bucket >= ws:
            return -(-B // bucket) * bucket
        return B + ws * bucket

    def _can_use_packed(self, plan) -> bool:
        """Packed epochs apply to a vision run (every worker of this port
        shares one card) with no per-worker clip and none of the elastic-only
        features, when the plan's bucketed widths fit ``_cap_packed``.
        ``--packed on`` raises where they cannot engage, ``off`` never
        engages."""
        cfg = self.cfg
        if cfg.packed == "off":
            return False
        ok = (
            self.n_dev == 1
            and self.n_proc == 1
            and self.bundle is not None
            and cfg.grad_clip == 0
            and not cfg.compress_grads
            and cfg.grad_accum <= 1
        )
        fits = plan is None or sum(w.padded_batch for w in plan.workers) <= self._cap_packed
        if cfg.packed == "on" and not (ok and fits):
            if ok and not fits:
                raise ValueError(
                    f"packed=on: plan widths {[w.padded_batch for w in plan.workers]} "
                    f"sum past the packed scan width {self._cap_packed}"
                )
            raise ValueError(
                "packed=on needs a single-device vision topology and no "
                "grad_clip/compress_grads/grad_accum"
            )
        return ok and fits

    def _can_use_fused(self, plan) -> bool:
        """The fused path (the JAX ``_can_use_fused``): the balancer off, a
        uniform plan, one worker a device and a device a worker, no timing
        model and no compute-mode injection (which needs per-worker
        probes)."""
        return (
            not self.cfg.dynamic_batch_size
            and plan.is_uniform()
            and self.topology.one_worker_per_device
            and self.n_dev == self.world_size
            and self.timing_model is None
            and not self._needs_iter_cost
        )

    def _can_use_fused_dbs(self, plan) -> bool:
        """The fused-DBS path (``--fused_dbs``): every worker padded to the
        capacity width ``_cap_b``, one worker a device."""
        return (
            self.cfg.fused_dbs
            and self.cfg.dynamic_batch_size
            and self.topology.one_worker_per_device
            and self.n_dev == self.world_size
        )

    @property
    def _cap_b(self) -> int:
        """The fused-DBS width a worker: the largest bucketed batch the
        balancer can assign (``max_share`` of the global batch; the language
        model's columns)."""
        cfg = self.cfg
        max_share = min(1.0, cfg.capacity_factor / self.world_size)
        return -(-int(np.ceil(max_share * cfg.batch_size)) // cfg.bucket) * cfg.bucket

    def _dispatch_epoch(self, plan, faults: EpochFaults, epoch: int) -> Dict[str, float]:
        """Path selection (the JAX order: fused, fused-DBS, packed, elastic)
        and the epoch's training (probes included)."""
        cfg = self.cfg
        fused, fused_dbs = self._can_use_fused(plan), self._can_use_fused_dbs(plan)
        if (cfg.grad_accum > 1 or (cfg.compress_grads and not cfg.shard_update)) and not (
                fused or fused_dbs):
            raise RuntimeError(
                "grad_accum/compress_grads require a fused path (one worker per device); "
                "this plan fell back to the elastic path"
            )
        packed = not (fused or fused_dbs) and self._can_use_packed(plan)
        if (fused or fused_dbs or packed) and cfg.rebalance == "window" \
                and not self._window_rebalance_logged:
            self._window_rebalance_logged = True
            self.logger.warning(
                "rebalance=window needs the elastic path but this run selected "
                "packed epochs — running at epoch cadence (pass --packed off to "
                "force the elastic path)"
            )
        path = ("fused" if fused else "fused_dbs" if fused_dbs else "packed" if packed
                else "elastic")
        self._packed_epoch = packed
        before = self.supersteps.stats()
        if fused or fused_dbs:
            out = self._train_epoch_fused(plan, faults, epoch, dbs_probe=fused_dbs)
        elif packed:
            out = self._train_epoch_packed(plan, faults, epoch)
        else:
            out = self._train_epoch_elastic(plan, faults, epoch)
        self.recorder.meta.setdefault("paths", []).append(path)
        self._record_supersteps(epoch, plan, faults, path, before)
        return out

    def _record_supersteps(self, epoch: int, plan, faults: EpochFaults, path: str,
                           before: Dict[str, float]) -> None:
        """The epoch's executor counts (captures, capture seconds, replays,
        eager runs from the slots, keys and the keys it added), its steps
        and dispatch windows (the elastic epoch's ``_elastic_ranges``; the
        packed epoch is one), its batch sizes and which workers carry an
        injected load, and the host meter's dispatches and launch seconds,
        in ``_meta["supersteps"]``; warns, as the JAX package does, if the
        prepared variants exceed the keys dispatched."""
        now = self.supersteps.stats()
        if path == "packed":
            windows = 1
        elif path == "elastic":
            windows = len(self._elastic_ranges(plan.num_steps))
        else:  # the fused paths: stream_chunk_steps windows
            windows = len(self._chunk_ranges(plan.num_steps))
        rec = {"epoch": int(epoch), "path": path, "mode": self._elastic_mode(),
               "steps": int(plan.num_steps), "windows": windows,
               "batch_sizes": [int(b) for b in plan.batch_sizes],
               "injected": [int(n > 0) for n in faults.slow_iters_per_step]}
        rec.update({k: now[k] - before[k] for k in ("captures", "capture_s", "replays", "eager_runs")})
        rec["keys"], rec["new_keys"] = now["keys"], now["keys"] - before["keys"]
        rec["dispatches"] = self._host_meter.dispatches
        rec["host_dispatch_s"] = self._host_meter.dispatch_s
        self.recorder.meta.setdefault("supersteps", []).append(rec)
        if now["keys"] > len(self._superstep_keys):
            self.logger.warning(
                f"Epoch {epoch}: {now['keys']} prepared step variants exceed "
                f"the {len(self._superstep_keys)} dispatched keys"
            )

    # ------------------------------------------------------------ supersteps

    def _step_key(self, path: str, batches, counts) -> tuple:
        """A step graph's key (``train/supersteps.py``): the path, each
        batch's shape (None: no real rows), the compute dtype, the clip,
        which batches carry an injected load, and the learning rate."""
        return (
            path,
            tuple(None if b is None else tuple(b[0].shape) for b in batches),
            str(self.compute_dtype),
            float(self.grad_clip),
            tuple(int(n) > 0 for n in counts),
            learning_rate(self.optimizer),
        )

    def _superstep(self, path: str, batches, counts, body, warmup) -> None:
        """One training step through ``StepGraphs``; a worker without a
        batch carries no load."""
        counts = [0 if b is None else int(n) for b, n in zip(batches, counts)]
        key = self._step_key(path, batches, counts)
        self._superstep_keys.add(key)
        self.supersteps.run(key, batches, counts, body, warmup)

    def _elastic_body(self):
        """The captured elastic step: ``elastic_step``, its loss sum added
        into the executor's accumulator."""
        acc = self.supersteps.loss

        def body(batches, slow):
            s = elastic_step(self.model, self.optimizer, batches, self.grad_clip, self.load, slow,
                             self.compute_dtype)
            if s is not None:
                acc.add_(s)

        return body

    def _packed_body(self):
        acc = self.supersteps.loss

        def body(batches, slow):
            acc.add_(packed_step(self.model, self.optimizer, batches[0], self.load, slow[0],
                                 self.compute_dtype))

        return body

    def _warmup(self, clip: float):
        """A step's warm-up before its capture: the step state prepared
        (``prepare_step_state``), then each batch's forward and backward
        with its clip and load, as the probes run them, no update."""

        def warm(batches, slow):
            prepare_step_state(self.optimizer)
            for b, n in zip(batches, slow):
                if b is not None:
                    probe_grads(self.model, self.params, b, clip, self.load, n, self.compute_dtype)

        return warm

    def _worker_rows(self, plan, rank: int):
        """Worker ``rank``'s epoch on the host: example indices and weights
        ``[steps, padded_batch]`` and the real rows a step (a prefix)."""
        idx, mask = plan.epoch_indices(rank)
        w = np.stack(
            [
                example_weights(
                    mask[s],
                    total_true=int(plan.batch_sizes.sum()),
                    worker_count=int(mask[s].sum()),
                    world_size=self.world_size,
                    uniform_worker_weight=self.cfg.disable_enhancements,
                )
                for s in range(mask.shape[0])
            ]
        )
        return idx, w, mask.sum(axis=1).tolist()

    def _worker_epoch(self, plan, rank: int):
        """Worker ``rank``'s batch supplier for the epoch: a function of the
        step returning ``(batch, count)``, ``batch`` an ``(x, y, w)`` on the
        device or None for a step with no real data, and ``count`` the
        entries with positive weight (the train loss's denominator)."""
        idx, w, n_real = self._worker_rows(plan, rank)
        idx = torch.from_numpy(idx).to(self.device)
        w = torch.from_numpy(w).to(self.device)

        def step(s: int):
            n = n_real[s]
            if n == 0:
                return None, 0  # all-padding step: weight 0, skipped
            rows = idx[s, :n]
            return (self._prep(self.train_x[rows]), self.train_y[rows], w[s, :n]), n

        return step

    def _prep(self, x_u8: torch.Tensor) -> torch.Tensor:
        """A training batch: augmented or normalised, then cast to the
        compute dtype (``--precision bfloat16``) as the JAX ``local_grads``
        casts it."""
        mean, std = self.bundle.mean, self.bundle.std
        if self.augment:
            x = augment_images(x_u8, mean, std, generator=self.aug_gen)
        else:
            x = normalize_images(x_u8, mean, std)
        return x if self.compute_dtype is None else x.to(self.compute_dtype)

    def _chunk_ranges(self, num_steps: int):
        """``stream_chunk_steps``-sized windows (0: one window)."""
        chunk = self.cfg.stream_chunk_steps
        if chunk <= 0 or num_steps <= chunk:
            return [(0, num_steps)]
        return [(s, min(s + chunk, num_steps)) for s in range(0, num_steps, chunk)]

    def _elastic_ranges(self, num_steps: int):
        """The elastic epoch's windows, the ones the JAX package cuts on one
        device: ``stream_chunk_steps``-sized chunks (0: one), each cut at
        ``superstep_window`` steps in scan mode (``_elastic_mode``)."""
        ranges = self._chunk_ranges(num_steps)
        if self._elastic_mode() != "scan":
            return ranges
        win = int(self.cfg.superstep_window)  # >= 1, config.py checks it
        return [(s, min(s + win, s1)) for s0, s1 in ranges for s in range(s0, s1, win)]

    @staticmethod
    def _seg_for_step(seg_plans, s: int):
        """``(plan, start)`` of the segment holding epoch step ``s``:
        segments are ``(start, plan)`` in increasing order, and the plan's
        own step index is ``s - start``."""
        pl, off = seg_plans[0][1], seg_plans[0][0]
        for start, p in seg_plans:
            if s >= start:
                pl, off = p, start
        return pl, off

    def _aug_seed(self, epoch: int, step: int) -> int:
        """The augmentation seed of the window starting at epoch step
        ``step``: the epoch's seed (the packed path's) for the first."""
        return self._rank_seed(self.cfg.seed * 7919 + epoch + 104729 * step)

    def _train_epoch_elastic(self, plan, faults: EpochFaults, epoch: int) -> Dict[str, float]:
        self.timekeeper.reset()
        self.model.train()
        meter = self._host_meter
        meter.reset()
        if self.n_proc > 1 or self._elastic_mode() == "window":
            first, loss_sum, count, rows = self._run_rank_windows(plan, faults, epoch)
            out = self._finish_epoch(plan, faults, epoch, loss_sum, count, lambda: first, rows)
            out["host_dispatch_s"] = meter.dispatch_s
            out["host_put_s"] = meter.put_s
            out["host_overhead_per_step_s"] = meter.per_step(plan.num_steps)
            return out
        acc = {"loss": torch.zeros((), device=self.device), "count": 0}
        # the whole epoch under the boundary plan, until the controller
        # appends a remainder segment at a switch
        seg_plans = [(0, plan)]
        first = self._run_elastic_windows(
            plan, seg_plans, self._elastic_ranges(plan.num_steps), faults, epoch, acc,
            controller=self._window_controller(),
        )
        self._sync()
        out = self._finish_epoch(plan, faults, epoch, acc["loss"], acc["count"], lambda: first,
                                 acc.get("rows", 0))
        out["host_dispatch_s"] = meter.dispatch_s
        out["host_put_s"] = meter.put_s
        out["host_overhead_per_step_s"] = meter.per_step(plan.num_steps)
        return out

    def _run_elastic_windows(self, plan, seg_plans, ranges, faults: EpochFaults, epoch: int,
                             acc, controller=None):
        """The elastic window loop: each window's plan comes from
        ``seg_plans`` (a switch appends to it), each step is one
        ``elastic_step`` over the workers' batches, its launch calls timed
        by the host meter (in scan mode a window's steps go through
        ``StepGraphs`` under one dispatch); the controller runs after every
        ``rebalance_every`` windows. Adds each step's loss sum and real-row
        count into ``acc``; returns the first step's batches (the probes
        reuse them). Shared by the epoch and the switch-parity replay."""
        cfg = self.cfg
        meter = self._host_meter
        slow = [int(v) for v in faults.slow_iters_per_step]
        time_varying = (
            getattr(self.injector, "faults_at", None) is not None and self._needs_iter_cost
        )
        suppliers: Dict[int, list] = {}  # segment start -> the workers' batch suppliers
        eval_state = {"t": time.perf_counter(), "step": 0}
        first = None
        scan = self._elastic_mode() == "scan"
        if scan:
            # the graphs add into the executor's accumulator: continue acc's sum
            self.supersteps.loss.copy_(acc["loss"])
            body, warm = self._elastic_body(), self._warmup(self.grad_clip)

        def gather(s: int):
            batches = []
            for supply in suppliers[off]:
                b, n = supply(s - off)
                batches.append(b)
                acc["count"] += n
                if b is not None:
                    acc["rows"] = acc.get("rows", 0) + int(b[0].shape[0])
            return batches

        for i, (w0, w1) in enumerate(ranges):
            # liveness at every window boundary: a loss mid-epoch is found
            # within detect_misses windows and the epoch re-run over the
            # survivors (_run_epoch_elastic_world)
            self._check_health(epoch, w0 / max(plan.num_steps, 1))
            pl, off = self._seg_for_step(seg_plans, w0)
            if off not in suppliers:
                suppliers[off] = [self._worker_epoch(pl, r) for r in range(self.world_size)]
            if time_varying:
                # the injected load follows the schedule at window
                # granularity: its value in mid-window, at this segment's split
                t_mid = float(epoch) + (w0 + w1) / (2.0 * max(plan.num_steps, 1))
                wf = self._window_faults_at(t_mid, pl)
                if wf is not None:
                    slow = [int(v) for v in wf.slow_iters_per_step]
            if self.augment:
                self.aug_gen.manual_seed(self._aug_seed(epoch, w0))
            # one span a window (not a step), as the JAX package's
            with self._trace.span("dispatch_window", cat="dispatch"):
                if scan:
                    with meter.dispatch():  # the window's steps: one dispatch
                        for s in range(w0, w1):
                            batches = gather(s)
                            self._superstep("elastic", batches, slow, body, warm)
                            if first is None:
                                first = batches
                else:
                    for s in range(w0, w1):
                        with meter.dispatch():
                            batches = gather(s)
                            step_loss = elastic_step(
                                self.model, self.optimizer, batches, self.grad_clip, self.load,
                                slow, self.compute_dtype,
                            )
                            if step_loss is not None:
                                acc["loss"] += step_loss
                        if first is None:
                            first = batches
            self.steps_done += w1 - w0
            if controller is not None and (i + 1) % cfg.rebalance_every == 0:
                self._maybe_window_rebalance(
                    controller, plan, seg_plans, ranges, i, epoch, eval_state, suppliers
                )
        if scan:
            acc["loss"].copy_(self.supersteps.loss)
        return first

    # ------------------------------------------------------- ranks (window)

    def _local_workers(self) -> range:
        return range(self.rank_lo, self.rank_lo + self.ws_local)

    def _rank_step_graphs(self, path: str, batches, counts, body, warm) -> None:
        """A rank's forward/backward of one step: replayed from its step
        graph unless ``--superstep off`` (eager); the update stays outside
        (a collective sits between them). The key holds no learning rate:
        the captured part has no update."""
        if self.cfg.superstep == "off":
            body(batches, [int(n) for n in counts])
            return
        counts = [0 if b is None else int(n) for b, n in zip(batches, counts)]
        key = self._step_key(path, batches, counts)[:-1] + (self.cfg.grad_accum,)
        self._superstep_keys.add(key)
        self.supersteps.run(key, batches, counts, body, warm)

    def _rank_body(self):
        """The rank's elastic forward/backward (``accumulate_grads``), each
        local worker's loss sum into ``_worker_loss``."""
        slot = self._worker_loss

        def body(batches, slow):
            accumulate_grads(self.model, self.optimizer, batches, self.grad_clip, self.load, slow,
                             self.compute_dtype, losses=slot)

        return body

    def _fused_body(self):
        """The rank's fused forward/backward (``fused_grads``: its
        ``--grad_accum`` micro-batches), its loss sum into ``_worker_loss``."""
        slot = self._worker_loss

        def body(batches, slow):
            slot[0].copy_(fused_grads(self.model, self.optimizer, batches[0], self.cfg.grad_accum,
                                      self.grad_clip, self.load, slow[0], self.compute_dtype))

        return body

    def _combine_step(self, key) -> None:
        """The step's combine across ranks and the update
        (``RankCombine.step``), then the step counter."""
        with self._trace.span("combine", cat="comm"):
            self._rank_combine.step(learning_rate(self.optimizer), key)
        self.steps_done += 1

    def _run_rank_windows(self, plan, faults: EpochFaults, epoch: int):
        """The elastic epoch across ranks (the JAX package's window mode):
        each step, this rank's workers run forward/backward into ``.grad``
        (``_rank_step_graphs``), then the combine sums ``.grad`` over the
        ranks and updates (``_combine_step``, key ``fold_in(fold_in(
        PRNGKey(0x5D1E), rank), step)``). Returns the first step's batches
        (the probes', ``None`` for other ranks' workers), the epoch's loss
        sum and real rows over every rank (``_gather_losses``) and this
        rank's rows."""
        self._make_rank_combine()
        self._window_controller()  # across processes: the JAX fallback's warning
        meter = self._host_meter
        local = list(self._local_workers())
        slow = [int(faults.slow_iters_per_step[r]) for r in local]
        suppliers = [self._worker_epoch(plan, r) for r in local]
        table = torch.zeros((plan.num_steps, self.ws_local), device=self.device)
        body, warm = self._rank_body(), self._warmup(self.grad_clip)
        root = fold_in(prng_key(_COMBINE_KEY), self.mesh.rank)
        count = rows = 0
        first = None
        for w0, w1 in self._elastic_ranges(plan.num_steps):
            self._check_health(epoch, w0 / max(plan.num_steps, 1))
            if self.augment:
                self.aug_gen.manual_seed(self._aug_seed(epoch, w0))
            with self._trace.span("dispatch_window", cat="dispatch"):
                for s in range(w0, w1):
                    batches = []
                    for supply in suppliers:
                        b, n = supply(s)
                        batches.append(b)
                        count += n
                        rows += 0 if b is None else int(b[0].shape[0])
                    with meter.dispatch():
                        self._rank_step_graphs("elastic", batches, slow, body, warm)
                        table[s].copy_(self._worker_loss)
                    self._combine_step(fold_in(root, self.steps_done))
                    if first is None:
                        first = [None] * self.world_size
                        for r, b in zip(local, batches):
                            first[r] = b
        loss_sum, count = self._gather_losses(table, count)
        return first, loss_sum, count, rows

    def _gather_losses(self, table: torch.Tensor, count: int):
        """The epoch's loss sum and real-row count over every rank. Each
        rank's ``[steps, ws_local]`` table of its workers' step sums is
        gathered, and the sums are added in the one-process order (each
        step's workers in order, then the steps, in f32), so an epoch
        whose steps draw nothing reads the one-process loss bit for bit."""
        tab = table.detach().to("cpu", torch.float64).numpy()
        got = allgather_host(np.concatenate([tab.reshape(-1), [float(count)]]))
        per = got.reshape(self.n_proc, -1)
        full = np.concatenate([p[:-1].reshape(tab.shape) for p in per], axis=1).astype(np.float32)
        acc = np.float32(0.0)
        for row in full:
            t = np.float32(0.0)
            for v in row:
                t = np.float32(t + v)
            acc = np.float32(acc + t)
        return float(acc), int(per[:, -1].sum())

    def _replay_window_segment(self, base_plan, rplan, s_offset: int, epoch: int,
                               faults: EpochFaults, acc=None):
        """Run only the remainder segment ``rplan`` of an epoch, from step
        ``s_offset`` of ``base_plan``, from the current state: the fresh-run
        leg of the switch-parity contract, through the same window loop,
        windows and per-window seeds as a switch inside the epoch. Adds into
        ``acc`` when given (a prefix's, so the epoch's loss sums in one
        order); returns the (loss sum, real-row count)."""
        ranges = [w for w in self._elastic_ranges(base_plan.num_steps) if w[0] >= s_offset]
        if acc is None:
            acc = {"loss": torch.zeros((), device=self.device), "count": 0}
        self.model.train()
        self._run_elastic_windows(base_plan, [(s_offset, rplan)], ranges, faults, epoch, acc)
        self._sync()
        return float(acc["loss"]), acc["count"]

    # ------------------------------------------------- window-cadence control

    def _comm_bytes_per_step(self) -> "tuple[float, float]":
        """(ICI bytes, DCN bytes) of one combine, a device (the JAX
        package's formula with the port's element size,
        ``parallel/wire.py`` ``wire_payload_bytes``). Flat: the gradient at
        4 bytes an element, or ``--compress_grads int8``'s wire, counted
        "across hosts" only when the ranks span hosts. Hier: every hop of
        ``parallel/wire.py`` ``tree_hop_bytes`` but the top one is the ICI
        class; the top hop's chunk, on the outermost wire, the DCN class."""
        cfg = self.cfg
        elems = self._param_elems
        if self.grad_comm == "hier":
            hops = tree_hop_bytes(elems, self._topo_tree.sizes, self._grad_comm_wires)
            return float(sum(b for _, b in hops[:-1])), float(hops[-1][1])
        per_elem = wire_payload_bytes("int8", self.n_dev) if cfg.compress_grads == "int8" else 4
        b = float(elems * per_elem)
        return b, (b if self.mesh.cross_host else 0.0)

    def _record_collective(self, epoch: int) -> None:
        """The epoch's combine walls (``RankCombine.collective_s``) in
        ``_meta["collective"]``: steps, total, mean and max seconds."""
        rc = self._rank_combine
        if rc is None or not rc.collective_s:
            return
        walls = rc.collective_s
        self.recorder.meta.setdefault("collective", []).append({
            "epoch": int(epoch), "steps": len(walls), "total_s": float(sum(walls)),
            "mean_s": float(sum(walls) / len(walls)), "max_s": float(max(walls)),
        })
        rc.collective_s = []

    def _modeled_comm_step_s(self) -> float:
        """The modeled wall of one combine over the bandwidth probe's
        measured level rates (the JAX package's): each hop's bytes
        (``tree_hop_bytes``, as :meth:`_comm_bytes_per_step` counts them)
        over its level's rate, summed (the hops run one after another). 0.0
        without a tree or without measured rates (the compute-only model)."""
        if self.grad_comm != "hier" or self._topo_tree is None:
            return 0.0
        rates = (self._link_bw or {}).get("level_bytes_per_s")
        sizes, wires = self._topo_tree.sizes, self._grad_comm_wires
        if not rates or len(rates) != len(sizes) or len(wires) != len(sizes):
            return 0.0
        r = [float(x) if x and float(x) > 0 else 0.0 for x in rates]
        if any(x <= 0.0 for x in r):
            return 0.0
        hops = tree_hop_bytes(self._param_elems, sizes, wires)
        return float(sum(b / r[level] for level, b in hops))

    def _window_controller(self) -> Optional[OnlineRebalanceController]:
        """The online controller under ``--rebalance window`` (built once;
        its rate track and ledgers persist across epochs), else None. Across
        processes it is None after the JAX package's warning, once: a switch
        decided on each rank's own walls could differ between ranks and
        desynchronize their collectives, so the run keeps epoch cadence."""
        cfg = self.cfg
        if cfg.rebalance != "window" or not cfg.dynamic_batch_size:
            return None
        if self.n_proc > 1:
            if not self._window_rebalance_logged:
                self._window_rebalance_logged = True
                self.logger.warning(
                    "rebalance=window is single-process only — falling back to epoch cadence"
                )
            return None
        if self._rebalance_ctl is None:
            self._rebalance_ctl = OnlineRebalanceController(
                self.world_size,
                cfg.batch_size,
                [list(range(self.world_size))],  # every worker shares one card
                bucket=cfg.bucket if (cfg.snap_to_bucket and self.SNAP_BATCHES) else 0,
                max_share=min(1.0, cfg.capacity_factor / self.world_size),
                hysteresis=cfg.rebalance_hysteresis,
                margin=cfg.rebalance_margin,
                budget_frac=cfg.rebalance_budget_frac,
                rate_alpha=cfg.rebalance_rate_alpha,
                logger=self.logger,
            )
            self.obs.attach(controller=self._rebalance_ctl)
        self._rebalance_ctl.comm_step_s = self._modeled_comm_step_s()
        return self._rebalance_ctl

    def _window_rates(self) -> Optional[np.ndarray]:
        """Injection-free seconds an example per worker for the controller:
        the probe anchors where they exist, else the last epoch's
        multiplier-free compute over the example counts of the plan it was
        measured under. None before any signal exists (epoch 0): the caller
        then evaluates on unit rates and folds nothing into the EMA."""
        c = self.per_example_cost.copy()
        if np.isfinite(c).all() and (c > 0).all():
            return np.maximum(c, 1e-12)
        clean, examples = self._clean_compute_s, self._clean_examples
        if (
            clean is not None
            and examples is not None
            and len(clean) == self.world_size
            and len(examples) == self.world_size
            and (clean > 0).all()
        ):
            return np.maximum(clean / np.maximum(examples, 1.0), 1e-12)
        return None

    def _window_ctx(self, pl) -> FaultContext:
        """The fault context at the current segment's batch sizes (after a
        switch the injected load follows the new split)."""
        return FaultContext(
            batch_sizes=self._scatter_full(pl.batch_sizes.astype(np.float64)),
            iter_cost_s=self._iter_cost_s if self._needs_iter_cost else None,
            per_example_cost_s=(
                self._scatter_full(self.per_example_cost)
                if np.isfinite(self.per_example_cost).all() else None
            ),
        )

    def _window_faults_at(self, t: float, pl) -> Optional[EpochFaults]:
        """The injector's faults at epoch-time ``t`` over the active fleet;
        None for an injector with no time-varying view."""
        fa = getattr(self.injector, "faults_at", None)
        if fa is None:
            return None
        return self._faults_active(fa(t, self._window_ctx(pl)))

    def _effective_rates(self, rates: np.ndarray, wf: Optional[EpochFaults],
                         batches: np.ndarray) -> np.ndarray:
        """The base rates under the window's faults: virtual multipliers
        scale them, compute-mode iterations add their cost an example at
        the current split."""
        eff = np.asarray(rates, dtype=np.float64).copy()
        if wf is None:
            return eff
        eff = eff * np.asarray(wf.time_multipliers, dtype=np.float64)
        if self._needs_iter_cost and self._iter_cost_s:
            extra = self._iter_cost_s * np.asarray(wf.slow_iters_per_step, dtype=np.float64)
            eff = eff + extra / np.maximum(np.asarray(batches, dtype=np.float64), 1.0)
        return eff

    def _maybe_window_rebalance(self, ctl, plan, seg_plans, ranges, i: int, epoch: int,
                                eval_state, suppliers) -> None:
        """One controller evaluation at the boundary after window ``i``:
        fold the signal, propose, and on a switch re-slice the windows from
        ``i + 2`` on under the new plan. The JAX package's double-buffered
        transfer pipeline has already staged window ``i + 1`` when its
        controller runs (``next_unlaunched``); this loop is synchronous but
        keeps that horizon, so its switches land on the same steps. The
        measured switch cost covers the whole span from the evaluation's
        start to the applied switch (the synchronize, the signal, the solve,
        the re-slice and the new segment's rows), the host price a switch
        pays."""
        j = i + 2
        if j >= len(ranges):
            return  # no window left to act on
        s_switch = ranges[j][0]
        remaining = plan.num_steps - s_switch
        if remaining <= 0:
            return
        t_eval0 = time.perf_counter()
        sync_s = 0.0
        cur_pl, cur_off = self._seg_for_step(seg_plans, s_switch)
        cur_batches = np.asarray(cur_pl.batch_sizes, dtype=np.int64)
        base = self._window_rates()
        if base is not None:
            ctl.observe_rates(base)
        t_next = float(epoch) + (ranges[j][0] + ranges[j][1]) / (2.0 * max(plan.num_steps, 1))
        wf = self._window_faults_at(t_next, cur_pl)
        rates = ctl.rates if ctl.rates is not None else np.ones(self.world_size)
        eff = self._effective_rates(rates, wf, cur_batches)
        measured = modeled = None
        if self.timing_model is None:
            # wall feedback: the wall of the steps since the last
            # evaluation (_window_wall) against the prediction stored at
            # that evaluation for the same steps
            if self._window_timer.active:
                self._window_timer.mark()
            t_sync = time.perf_counter()
            self._sync()
            now = time.perf_counter()
            sync_s = now - t_sync
            host_s, _, _ = self._host_meter.mark_window()
            done = ranges[i][1] - eval_state["step"]
            if eval_state["step"] > 0 and done > 0 and eval_state.get("pred_step"):
                wall = self._window_wall(now, eval_state["t"], host_s)
                measured, modeled = max(wall, 1e-9), eval_state["pred_step"] * done
                ctl.observe_wall(measured, modeled)
            eval_state["t"] = now
            eval_state["step"] = ranges[i][1]
        ctl.eval_context = {"epoch": int(epoch), "window": int(j)}
        dec = ctl.propose(eff, cur_batches, remaining)
        if dec.switch:
            rplan = build_remainder_plan(
                cur_pl, s_switch - cur_off, dec.candidate_batches, bucket=self.cfg.bucket
            )
            seg_plans.append((s_switch, rplan))
            suppliers[s_switch] = [self._worker_epoch(rplan, r) for r in range(self.world_size)]
            self.shares = np.asarray(dec.candidate_shares, dtype=np.float64)
            ev = ctl.commit(
                dec, time.perf_counter() - t_eval0,
                epoch=int(epoch), window=int(j), step=int(s_switch),
            )
            self._rebalance_events.append(ev)
            self.recorder.meta["rebalance_events"] = self._rebalance_events
        if self.timing_model is None:
            # the prediction for the stretch about to run, under the plan
            # that governs it: the next evaluation's feedback reference
            nxt_pl, _ = self._seg_for_step(seg_plans, ranges[j][0])
            eval_state["pred_step"] = step_time(
                eff, np.asarray(nxt_pl.batch_sizes, dtype=np.float64), ctl.groups
            )
        self.recorder.meta.setdefault("rebalance_evals", []).append({
            "epoch": int(epoch), "window": int(j), "switch": bool(dec.switch),
            "wall_s": time.perf_counter() - t_eval0, "sync_s": sync_s,
            # the feedback this evaluation folded (None: none yet this
            # epoch) and the controller's scale after it
            "measured_s": measured, "modeled_s": modeled, "wall_scale": float(ctl.wall_scale),
        })

    def _window_wall(self, now: float, since: float, host_s: float) -> float:
        """The measured wall of the windows since the last evaluation. On
        the card: the card's own time between the two evaluations' CUDA
        events (``DeviceWindowTimer``); there a launch call blocks while the
        queue is full, so the host's launch time is device time and must not
        be subtracted. On the CPU: the JAX formula, the host's wall from
        ``since`` to ``now`` (after a synchronize) less its launch seconds
        ``host_s`` over the windows."""
        if self._window_timer.active:
            return self._window_timer.seconds()
        return now - since - host_s

    def _train_epoch_packed(self, plan, faults: EpochFaults, epoch: int) -> Dict[str, float]:
        """One step a plan step over the workers' concatenated real rows
        (worker order, each worker's weights as on the elastic path), the
        workers' injected load summed, then the same per-worker probes on
        each worker's rows of the epoch's first step."""
        cfg = self.cfg
        self.timekeeper.reset()
        self.model.train()
        if self.augment:
            self.aug_gen.manual_seed(cfg.seed * 7919 + epoch)
        rows = [self._worker_rows(plan, r) for r in range(self.world_size)]
        steps = range(plan.num_steps)
        idx = np.concatenate([i[s, : n[s]] for s in steps for i, _, n in rows])
        w = np.concatenate([ww[s, : n[s]] for s in steps for _, ww, n in rows])
        offs = np.cumsum([0] + [sum(n[s] for _, _, n in rows) for s in steps]).tolist()
        idx = torch.from_numpy(idx).to(self.device)
        w = torch.from_numpy(w).to(self.device)
        slow = int(faults.slow_iters_per_step.sum())
        meter = self._host_meter
        meter.reset()

        def batch(s: int):
            sel = idx[offs[s] : offs[s + 1]]
            return (self._prep(self.train_x[sel]), self.train_y[sel], w[offs[s] : offs[s + 1]])

        if self._elastic_mode() == "scan":
            # the epoch's steps through StepGraphs in one dispatch, as the
            # JAX package's packed epoch is one scan
            self.supersteps.loss.zero_()
            body, warm = self._packed_body(), self._warmup(0.0)
            with meter.dispatch():
                for s in steps:
                    self._superstep("packed", [batch(s)], [slow], body, warm)
            loss_sum = self.supersteps.loss.clone()
        else:
            loss_sum = torch.zeros((), device=self.device)
            for s in steps:
                with meter.dispatch():
                    loss_sum += packed_step(self.model, self.optimizer, batch(s), self.load, slow,
                                            self.compute_dtype)
        self.steps_done += plan.num_steps
        self._sync()

        def first():
            return [self._worker_epoch(plan, r)(0)[0] for r in range(self.world_size)]

        out = self._finish_epoch(plan, faults, epoch, loss_sum, offs[-1], first, offs[-1])
        out["host_dispatch_s"] = meter.dispatch_s
        return out

    def _train_epoch_fused(self, plan, faults: EpochFaults, epoch: int,
                           dbs_probe: bool = False) -> Dict[str, float]:
        """The fused path (the JAX ``_train_epoch_fused``, its non-packed
        branches): this rank's one worker runs every step at one width, its
        bucketed batch (``dbs_probe``: the fused-DBS capacity ``_cap_b``,
        zero-weight rows past the real ones, so one step graph serves every
        plan), in ``--grad_accum`` micro-batches (``fused_grads``), then the
        combine (key ``fold_in(fold_in(fold_in(PRNGKey(0), seed * 31 +
        epoch), rank), step)``, folded with ``0x7FFF`` for ZeRO-1). The
        collective's cost is probed once (``_probe_fused_sync``); under
        ``dbs_probe`` the balancer's per-worker signal comes from the same
        probes as the elastic path's, at the true widths."""
        cfg = self.cfg
        self.timekeeper.reset()
        self.model.train()
        self._make_rank_combine()
        meter = self._host_meter
        meter.reset()
        r = self.rank_lo  # one worker a device
        width, batch, n_real = self._fused_epoch(plan, r, dbs_probe)
        slow = [int(faults.slow_iters_per_step[r])]
        table = torch.zeros((plan.num_steps, 1), device=self.device)
        body, warm = self._fused_body(), self._warmup(self.grad_clip)
        root = fold_in(fold_in(prng_key(0), cfg.seed * 31 + epoch), self.mesh.rank)
        first_padded = None
        for w0, w1 in self._chunk_ranges(plan.num_steps):
            if self.augment:
                self.aug_gen.manual_seed(self._aug_seed(epoch, w0))
            with self._trace.span("dispatch_window", cat="dispatch"):
                for s in range(w0, w1):
                    b = batch(s)
                    first_padded = first_padded or b
                    with meter.dispatch():
                        self._rank_step_graphs("fused", [b], slow, body, warm)
                        table[s].copy_(self._worker_loss)
                    rng = fold_in(root, self.steps_done)
                    hop = cfg.shard_update or self.grad_comm == "hier"
                    self._combine_step(fold_in(rng, 0x7FFF) if hop else rng)
        loss_sum, count = self._gather_losses(table, int(sum(n_real)))
        probe_overhead = 0.0
        if self._fused_sync_per_step is None:
            t0 = time.perf_counter()
            with self._trace.span("sync_probe", cat="probe"):
                self._fused_sync_per_step = self._probe_fused_sync(first_padded, slow[0])
            probe_overhead = time.perf_counter() - t0

        def first():
            out = [None] * self.world_size
            out[r] = self._worker_epoch(plan, r)(0)[0]
            return out

        out = self._finish_epoch(plan, faults, epoch, loss_sum, count, first,
                                 plan.num_steps * width)
        out["sync_time"] = self._fused_sync_per_step * plan.num_steps
        out["probe_overhead"] += probe_overhead
        out["host_dispatch_s"] = meter.dispatch_s
        return out

    def _fused_epoch(self, plan, r: int, dbs_probe: bool):
        """Worker ``r``'s epoch on the fused path: ``(width, batch, counts)``,
        ``width`` its rows a step (its bucketed batch, or under ``dbs_probe``
        the capacity ``_cap_b``), ``batch(s)`` step ``s``'s ``(x, y, w)`` on
        the device at that width (zero-weight rows past the real ones) and
        ``counts`` the real rows a step. The language model's trainer gives
        its token windows here (``train/lm_engine.py``)."""
        idx, w, n_real = self._worker_rows(plan, r)
        width = self._cap_b if dbs_probe else idx.shape[1]
        if width > idx.shape[1]:
            pad = ((0, 0), (0, width - idx.shape[1]))
            idx, w = np.pad(idx, pad), np.pad(w, pad)
        idx_t = torch.from_numpy(idx).to(self.device)
        w_t = torch.from_numpy(w).to(self.device)

        def batch(s: int):
            return self._prep(self.train_x[idx_t[s]]), self.train_y[idx_t[s]], w_t[s]

        return width, batch, n_real

    def _probe_fused_sync(self, batch, slow: int, reps: int = 3) -> float:
        """The fused step's collective cost: one full step's twin (the
        step's forward/backward, replayed from its graph into ``.grad``,
        then the collectives and the update into new tensors) against its
        comm-free twin; if the difference drowns in timer noise, the
        standalone collective of a gradient-sized buffer. Every rank runs
        all three, so the collectives match across ranks. The parameters
        and the momentum are not written, the dropout generator's state is
        put back (a resumed run probes in another epoch than the whole run
        and must draw the same masks); ``.grad`` is the step's scratch,
        zeroed by the next step."""
        rc = self._rank_combine
        lr = learning_rate(self.optimizer)
        body, warm = self._fused_body(), self._warmup(self.grad_clip)

        def step(with_comm: bool):
            self._rank_step_graphs("fused", [batch], [slow], body, warm)
            rc.probe(rc.grads.flat, lr, with_comm)

        def timed(fn) -> float:
            fn()  # warm
            best = float("inf")
            for _ in range(reps):
                self._sync()
                t0 = time.perf_counter()
                fn()
                self._sync()
                best = min(best, time.perf_counter() - t0)
            return best

        state = self.dropout_gen.get_state()
        try:
            t_full = timed(lambda: step(True))
            t_local = timed(lambda: step(False))
            t_psum = timed(rc.probe_psum)
        finally:
            self.dropout_gen.set_state(state)
        self._release_cache()
        delta = t_full - t_local
        return float(delta) if delta > 0.0 else float(t_psum)

    def _release_cache(self) -> None:
        """Ranks that share a card: hand the probes' cached blocks back to
        the card, where the other rank's allocator can take them."""
        if self.device.type == "cuda" and self.n_proc > 1:
            torch.cuda.empty_cache()

    def _finish_epoch(self, plan, faults: EpochFaults, epoch: int, loss_sum, count: int,
                      first_batches, rows: int) -> Dict[str, float]:
        """The balancer's signal after the epoch's steps: the probes when
        this epoch takes them (on ``first_batches()``), or the timing
        model; the virtual injected seconds; the one-time FLOP count
        (``_count_flops``); the epoch's train metrics, with the rows its
        steps ran (``padded_examples``: the port runs every worker at its
        true width, so its padded examples are its examples)."""
        cfg = self.cfg
        dbs_probe_cost = 0.0
        batches = None
        if (
            self.timing_model is None
            and self._probe_this_epoch
            and (cfg.dynamic_batch_size or self._needs_iter_cost)
        ):
            t0 = time.perf_counter()
            batches = first_batches()
            with self._trace.span("probe", cat="probe"):
                self._sync_per_step = self._probe_workers(plan, batches, faults, epoch)
            self._release_cache()
            dbs_probe_cost = time.perf_counter() - t0
            self._probes_ran = True
        if self.timing_model is not None:
            modeled = np.asarray(self.timing_model(plan), dtype=np.float64)
            for r in range(self.world_size):
                self.timekeeper.add_compute(r, modeled[r])
        for r in range(self.world_size):
            self.timekeeper.add_injected(r, float(faults.virtual_seconds[r]))
        probe_overhead = 0.0
        if self._flops_per_example is None:
            t0 = time.perf_counter()
            self._count_flops(batches if batches is not None else first_batches())
            probe_overhead = time.perf_counter() - t0
        return {
            "loss": float(loss_sum) / max(count, 1),
            "sync_time": self._sync_per_step * plan.num_steps,
            "dbs_probe_cost": dbs_probe_cost,
            # the one-time FLOP count, kept out of the wall as the JAX
            # package keeps its flops_probe_overhead
            "probe_overhead": probe_overhead,
            "padded_examples": float(rows),
        }

    def _count_flops(self, batches) -> None:
        """FLOPs an example, counted once (``obs/flops.py`` ``step_flops``):
        one eager forward and backward of the first worker with rows, its
        clip included and no load, after the epoch's steps, so never inside
        a step graph's capture, and outside the epoch wall. The gradients
        are returned, not applied, and the dropout generator's state is put
        back, so no training state moves."""
        b = next((b for b in batches if b is not None), None)
        if b is None:
            return
        state = self.dropout_gen.get_state()
        try:
            f = step_flops(lambda: probe_grads(self.model, self.params, b, self.grad_clip,
                                               None, 0, self.compute_dtype))
        finally:
            self.dropout_gen.set_state(state)
        self._sync()
        self._flops_per_example = f / max(int(b[0].shape[0]), 1) if f else -1.0
        self.recorder.meta["flops_per_example"] = self._flops_per_example

    def _probe_workers(self, plan, batches, faults: EpochFaults, epoch: int,
                       reps: int = 3) -> float:
        """Time each worker's forward/backward and its injected load
        standalone (min over ``reps``, each after a device synchronize)
        into the time keeper, keep the per-example cost anchors, calibrate
        the in-step iteration cost where it is due, then time one combine +
        update, returned as the per-step sync time. No probe touches
        ``.grad``, the parameters or the optimizer state.

        The anchors, as the JAX package keeps them: a worker's first
        measurement seeds its clean cost an example; on that first epoch a
        second, warm pass re-anchors every worker without injection; later
        uninjected probes drift it by 0.7 / 0.3; injected probes never
        touch it, and until the calibration has run they track the
        iteration cost from a paired clean probe."""
        model, params, clip, load = self.model, self.params, self.grad_clip, self.load
        dtype = self.compute_dtype  # the probe times the step training runs
        slow = [int(n) for n in faults.slow_iters_per_step]
        for r, b in enumerate(batches):  # untimed warm pass
            if b is not None:
                probe_grads(model, params, b, clip, load, slow[r], dtype)
        self._sync()
        # the host's launch + synchronize round trip, which is not device
        # compute; floored at 20% of the raw wall as in the JAX package
        ovh = 0.0
        if self.cfg.probe_overhead_correction:
            z = torch.zeros((), device=self.device)
            ovh = float("inf")
            for _ in range(3):
                t0 = time.perf_counter()
                z.add_(1.0)
                self._sync()
                ovh = min(ovh, time.perf_counter() - t0)

        def timed(b, n_slow: int):
            """(corrected wall, raw wall, gradients) of one probe. Paired
            measurements difference the raw walls: the 0.2 floor binds on
            the short leg only, so corrected walls would not cancel."""
            dt, g = float("inf"), None
            for _ in range(reps):
                self._sync()
                t0 = time.perf_counter()
                g = probe_grads(model, params, b, clip, load, n_slow, dtype)
                self._sync()
                dt = min(dt, time.perf_counter() - t0)
            return max(dt - ovh, 0.2 * dt), dt, g

        init_epoch = bool(np.isnan(self.per_example_cost[self.rank_lo:self.rank_lo + self.ws_local]).any())
        grads, per_example = [], [0.0] * self.world_size
        for r, b in enumerate(batches):
            if b is None:
                continue
            dt, dt_raw, g = timed(b, slow[r])
            w_plan = plan.workers[r]
            self.timekeeper.add_compute(r, dt * w_plan.steps)
            per_example[r] = dt / max(w_plan.batch_size, 1)
            if np.isnan(self.per_example_cost[r]):
                self.per_example_cost[r] = max(dt, 1e-9) / max(w_plan.batch_size, 1)
            elif slow[r] > 0 and not self._iter_cost_calibrated:
                realized = (dt_raw - timed(b, 0)[1]) / slow[r]
                if realized > 0 and np.isfinite(realized):
                    prev = self._iter_cost_s or realized
                    self._iter_cost_s = 0.5 * prev + 0.5 * realized
            elif slow[r] == 0:
                fresh = max(dt, 1e-9) / max(w_plan.batch_size, 1)
                self.per_example_cost[r] = 0.7 * self.per_example_cost[r] + 0.3 * fresh
            grads.append(g)
        self.recorder.meta.setdefault("probe_per_example_s", {})[str(epoch)] = per_example
        if init_epoch:
            # the first timed probes run cold and over-read the clean cost:
            # re-anchor every worker on a warm, injection-free pass before
            # the calibration sizes the injection off these anchors
            for r, b in enumerate(batches):
                if b is not None:
                    dt = timed(b, 0)[0]
                    self.per_example_cost[r] = max(dt, 1e-9) / max(plan.workers[r].batch_size, 1)
        if self._needs_iter_cost and not self._iter_cost_calibrated and max(slow) == 0:
            self._calibrate_iter_cost(plan, batches, timed)
            self._iter_cost_calibrated = True
        if self._rank_combine is not None:
            return self._probe_rank_combine(grads)
        # the packed path's sync probe is a span of its own, as the JAX
        # package's fused-path sync probe; the elastic one is the probe's
        span = (self._trace.span("sync_probe", cat="probe") if self._packed_epoch
                else contextlib.nullcontext())
        with span:
            combine_probe(self.optimizer, grads)  # warm
            self._sync()
            t0 = time.perf_counter()
            combine_probe(self.optimizer, grads)
            self._sync()
            return time.perf_counter() - t0

    def _probe_rank_combine(self, grads) -> float:
        """The combine across ranks timed once after a warm run, on this
        rank's probe gradients summed (zeros for a rank without a batch):
        the twin of the step's collectives and update, nothing written."""
        rc = self._rank_combine
        pos = {id(p): i for i, p in enumerate(self.params)}
        total = None
        for g in grads:
            total = list(g) if total is None else torch._foreach_add(total, list(g))
        flat = (torch.zeros_like(rc.grads.flat) if total is None
                else rc.grads.ravel([total[pos[id(p)]] for p in rc.params]))
        lr = learning_rate(self.optimizer)
        rc.probe(flat, lr)  # warm
        self._sync()
        t0 = time.perf_counter()
        rc.probe(flat, lr)
        self._sync()
        return time.perf_counter() - t0

    def _calibrate_iter_cost(self, plan, batches, timed) -> None:
        """Fixed-point iteration for the in-step synthetic-load cost: probe
        the first worker with a trip count sized to about double its clean
        step, take the realized cost an iteration from the raw injected wall
        minus a raw clean one in the same breath, and repeat until it moves
        under 5% (at most 4 rounds). ``timed`` is the probes' own timer."""
        r0 = next(r for r, b in enumerate(batches) if b is not None)
        clean = float(self.per_example_cost[r0]) * max(plan.workers[r0].batch_size, 1)
        if not np.isfinite(clean) or clean <= 0:
            return
        guess = self._iter_cost_s or self.load.calibrate_iter_cost(self.device)
        for _ in range(4):
            slow_n = max(int(round(clean / max(guess, 1e-12))), 1)
            dt = timed(batches[r0], slow_n)[1]
            dt_clean = timed(batches[r0], 0)[1]
            realized = (dt - dt_clean) / slow_n
            if realized <= 0 or not np.isfinite(realized):
                break
            done = abs(realized - guess) <= 0.05 * guess
            guess = realized
            if done:
                break
        self._iter_cost_s = guess
        self.recorder.meta["iter_cost_s"] = guess
        self.logger.info(f"injection calibrated: {guess * 1e6:.2f}us/iter (in-step)")

    # ------------------------------------------------------------- validate

    @torch.no_grad()
    def validate(self) -> "tuple[float, float]":
        """Full-test-set loss and accuracy (percent), on the f32 parameters
        whatever the compute dtype (the JAX ``fused_eval_step`` never
        casts)."""
        if self.n_proc > 1:
            return self._validate_sharded()
        self.model.eval()
        loss_sum = torch.zeros((), device=self.device)
        correct = torch.zeros((), device=self.device, dtype=torch.int64)
        n = len(self.test_y)
        for lo in range(0, n, _EVAL_CHUNK):
            x = normalize_images(self.test_x[lo : lo + _EVAL_CHUNK], self.bundle.mean, self.bundle.std)
            y = self.test_y[lo : lo + _EVAL_CHUNK]
            out = self.model(x).float()
            loss_sum += softmax_xent(out, y).sum()
            correct += (out.argmax(dim=-1) == y).sum()
        self.model.train()
        return float(loss_sum) / max(n, 1), 100.0 * float(correct) / max(n, 1)

    @torch.no_grad()
    def _validate_sharded(self) -> "tuple[float, float]":
        """``validate`` across ranks (the JAX ``_eval_sharded``): rank p
        evaluates the test set's chunks p, p + n, ...; the chunks' sums are
        gathered and added in chunk order in f32, as one process adds them,
        so the result is the one-process evaluation's."""
        self.model.eval()
        n = len(self.test_y)
        starts = list(range(0, n, _EVAL_CHUNK))
        stats = np.zeros((len(starts), 2), dtype=np.float64)
        for i in range(self.proc_id, len(starts), self.n_proc):
            lo = starts[i]
            x = normalize_images(self.test_x[lo:lo + _EVAL_CHUNK], self.bundle.mean, self.bundle.std)
            y = self.test_y[lo:lo + _EVAL_CHUNK]
            out = self.model(x).float()
            stats[i] = (float(softmax_xent(out, y).sum()), int((out.argmax(dim=-1) == y).sum()))
        self.model.train()
        stats = allgather_host(stats).reshape(self.n_proc, len(starts), 2).sum(axis=0)
        loss_sum = np.float32(0.0)
        for v in stats[:, 0].astype(np.float32):
            loss_sum = np.float32(loss_sum + v)
        return float(loss_sum) / max(n, 1), 100.0 * float(stats[:, 1].sum()) / max(n, 1)

    def rank_report(self) -> Dict[str, object]:
        """This rank at the end of a run (:func:`rank_report_base`), with its
        workers, the combine's buffers, and the combine that ran with its
        wires and the bandwidth probe's numbers it took."""
        return {
            **rank_report_base(self.model, self.proc_id, self.mesh, self.device, self.recorder),
            "workers": list(self._local_workers()),
            "combine": None if self._rank_combine is None else self._rank_combine.describe(),
            "grad_comm": self.grad_comm, "grad_comm_wires": list(self._grad_comm_wires),
            "link_bandwidth": self._link_bw,
        }

    # --------------------------------------------------------------- record

    def _record_epoch(
        self, epoch: int, plan, faults: EpochFaults, train_metrics,
        epoch_wall: float, probe_s: float, val_loss: float, accuracy: float,
    ) -> None:
        cfg = self.cfg
        if (
            not self._probe_this_epoch
            and self.timing_model is None
            and (cfg.dynamic_batch_size or self._needs_iter_cost)
        ):
            # probes skipped: the solver runs on modeled per-worker times
            self._model_compute_times(plan, faults)
        self._update_probe_schedule(epoch, plan, faults, epoch_wall)
        # the multiplier-free compute vector, with the example counts of the
        # plan it was measured under: the window controller's fallback rates
        self._clean_compute_s = self.timekeeper.compute_s.copy()
        self._clean_examples = np.array(
            [max(w.batch_size, 1) * max(w.steps, 1) for w in plan.workers], dtype=np.float64
        )
        self.recorder.meta.setdefault("node_time_source", []).append(
            "timing_model" if self.timing_model is not None
            else "probed" if probe_s > 0
            else "modeled" if cfg.dynamic_batch_size or self._needs_iter_cost
            else "none"
        )
        node_times = (
            self.timekeeper.compute_s * faults.time_multipliers
            + self.timekeeper.injected_s
        )
        # each process contributes its own workers' slice, gathered in rank order
        lo, hi = self.rank_lo, self.rank_lo + self.ws_local
        fresh = exchange_times(node_times[lo:hi])
        if cfg.time_smoothing > 0.0 and epoch > 0:
            a = cfg.time_smoothing
            self.node_times = a * self.node_times + (1.0 - a) * fresh
        else:
            self.node_times = fresh
        if self.n_proc > 1 and self._probes_ran:
            # a replicated gate (every rank probed epoch 0): the anchors of
            # every worker, so the modeled epochs and the contexts agree
            self.per_example_cost = exchange_times(self.per_example_cost[lo:hi])
        self.logger.info(
            f"Epoch {epoch}: node times {np.round(self.node_times, 4).tolist()}, "
            f"train_loss {train_metrics['loss']:.4f}, val_loss {val_loss:.4f}, "
            f"accuracy {accuracy:.2f}, wall {epoch_wall:.3f}s"
        )
        extras = {"probe_time": probe_s}
        if cfg.elastic == "on":
            # the fleet: workers_alive steps down on a loss and back up on a
            # readmission; recoveries counts completed recoveries
            extras["workers_alive"] = float(self.world_size)
            extras["recoveries"] = float(self._recoveries)
        if self._needs_iter_cost:
            prof = self._realized_injection_profile(plan, faults)
            if prof is not None:
                self.recorder.meta["realized_injection_profile"] = prof
        if epoch_wall > 0:
            extras["examples_per_s"] = self.n_train / epoch_wall
        ctl = self._rebalance_ctl
        if ctl is not None:
            # mid-epoch switches this epoch, and the controller's ledgers
            # with its decision journal (a replay corpus, balance/replaylab.py)
            extras["plan_switches"] = float(ctl.switches - self._switches_last)
            self._switches_last = ctl.switches
            self.recorder.meta["rebalance_controller"] = ctl.snapshot(include_journal=True)
        ici_b, dcn_b = self._comm_bytes_per_step()
        extras["comm_bytes_ici"] = ici_b * plan.num_steps
        extras["comm_bytes_dcn"] = dcn_b * plan.num_steps
        self._record_collective(epoch)
        for k in ("host_dispatch_s", "host_put_s", "host_overhead_per_step_s"):
            if k in train_metrics:  # the host walls (packed: dispatch only)
                extras[k] = train_metrics[k]
        ppe = self._flops_per_example
        if ppe is not None and ppe > 0:
            # MFU against the card's bf16 peak, from the counted FLOPs an
            # example times the rows the epoch ran (obs/flops.py)
            epoch_flops = ppe * train_metrics["padded_examples"]
            extras["flops_per_epoch"] = epoch_flops
            if epoch_wall > 0:
                u = mfu(epoch_flops / epoch_wall, 1, self.device)
                if u is not None:
                    extras["mfu_bf16_peak"] = u
        self.recorder.record_epoch(
            epoch=epoch,
            train_loss=train_metrics["loss"],
            train_time=float(self.node_times[0]),
            sync_time=train_metrics["sync_time"],
            val_loss=val_loss,
            accuracy=accuracy,
            partition=self.shares.tolist(),
            node_time=self.node_times.tolist(),
            wallclock_time=self.total_wallclock,
            **extras,
        )
