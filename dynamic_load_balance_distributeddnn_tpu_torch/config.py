"""Run configuration: the JAX package's CLI surface, copied.

Same flags, short flags, defaults and coercers as the reference
``config.py`` (``Config``, ``get_parser``, ``config_from_args``,
``base_filename``), so a command line written for the JAX trainer parses
here unchanged and artifacts land under the same config-encoded names.

One default differs, because this port has no use for the other value:
``use_pallas`` is ``True``: on the card the kernels always run; an explicit
``--use_pallas false`` with a CUDA device is rejected by the trainer, so the
card never quietly runs the plain path.

``Config.__post_init__`` runs the JAX package's value checks in its order,
each raising the JAX package's exception type (``tests/test_torch_config_checks.py``).
A flag whose feature this port does not implement yet raises
``NotImplementedError`` naming the flag when it is set to a non-default
value.

Several processes (``--coordinator host:port --num_processes N
--process_id i``, or the ``DBS_*`` environment) each own one device
(``parallel/mesh.py``): the ``-gpu`` map places each process's ``world_size
/ N`` workers, and a process's slice must name one device. Across ranks the
port runs the DBS loop of the vision models and of the language model
(window-mode elastic epochs), the fused and fused-DBS paths,
``--grad_accum``, ``--compress_grads int8``, ``--shard_update`` and
``--grad_comm hier`` (with ``--hier_levels``, ``--hier_hosts``,
``--grad_comm_wire(s)``, ``--dcn_bandwidth_probe`` and
``--dcn_probe_gate``; in one process it falls back to the flat combine with
the JAX package's warning) and ``--ckpt_dir`` (a save gathers each rank's
ZeRO-1 chunk and residuals to rank 0, ``train/checkpoint.py``);
``--rebalance window`` there runs at epoch cadence with the JAX package's
warning, as the JAX trainer does; ``--elastic on`` runs in one process and
across processes (``runtime/rendezvous.py``: a world brought up through
``elastic_initialize`` with ``DBS_PEER_HB_DIR`` set survives a lost process
and regrows; the cli's stock world detects the loss and aborts, as the JAX
trainer's does). ``--seq_parallel ring|ulysses`` trains the
language model with its sequence sharded over the ranks
(``train/sp_engine.py``). ``--remat`` recomputes the
training forward in the backward (``train/steps.py`` ``forward``).
The JAX package's compile-service flags drive the port's warm service
(``runtime/compiler.py``), whose "compile" is a step graph's capture
(``train/supersteps.py``; none under ``--superstep off``):

- ``--aot_warm`` (default on) makes the service: each elastic epoch
  captures its plan's missing keys before its first window, pending
  captures run before each epoch's wall (span ``aot_drain``), and the
  speculation runs after it. ``off`` captures every key lazily at its
  first step inside the wall, as before: the A/B reference.
- ``--warm_start`` submits the first epoch's keys (after a re-shard, the
  new fleet's) and, in the ranks' window mode, every ladder rung of each
  worker; they are captured before that epoch's wall.
- ``--aot_speculate`` (default on) captures, after each elastic or packed
  epoch with the balancer on, the keys the next epoch will likely
  dispatch: with ``--speculate_scan`` (default on) in one process the
  predicted batch tuple (``balance/solver.py``
  ``ShareTrajectoryPredictor``; under ``--rebalance window`` the
  controller's last candidate) at the next epoch's learning rate; across
  ranks each worker's ±bucket rungs (span ``speculate``).
- ``--aot_pool``, ``--aot_backend`` and ``--aot_workers`` are checked,
  accepted and have no effect: a capture cannot run beside other work on
  the card (``CAPTURE_GATE``), so there is no background pool, and a CUDA
  graph belongs to its process and context, so no capture can run in a
  subprocess (``nvcc``, the compile that can, already runs as concurrent
  subprocesses).

A run's counts are in the series' ``_meta.supersteps`` (per epoch:
``captures`` inside the wall, ``foreground_captures``,
``service_captures``, ``speculative_hits``), ``_meta.aot`` (each batch of
service captures: epoch, ``at`` drain, stage or speculate, count,
seconds), ``_meta.aot_service`` (the service's ``stats()``), the
``graph_captures`` series (foreground captures an epoch) and the registry
snapshot's ``compiles`` and ``aot`` (``Trainer.obs.snapshot()``).

``--device_cache`` has the JAX package's meaning (``Trainer.
_decide_device_cache``): under ``on``, or ``auto`` while the training
arrays fit ``device_cache_mb`` (512 MB), the training set lives on the
device and epochs gather it there by index; under ``off``, or ``auto``
over the cap, it stays on the host, and the packed and elastic epochs of
one process are fed a window at a time (``stream_chunk_steps``, and
``superstep_window`` in scan mode): each window's rows packed by the C++
gather (``runtime/native.py``) into pinned memory and staged one window
ahead on a CUDA copy stream (``train/pipeline.py``); validation then
streams the test set from pinned host memory. The ranks' windows, the
fused paths and the language model keep their data on the device under
``off`` for now (the run says so once). ``--ckpt_dir`` (``train/checkpoint.py``), ``--trace``,
``--trace_spool`` and ``--trace_annotations`` (``obs/trace.py``,
``obs/spool.py``) and ``--profile_dir`` (``torch.profiler``) work as in the
JAX package. ``--precision bfloat16`` is the JAX package's compute-dtype policy:
each training forward runs on bf16 copies of the f32 master weights
(``train/steps.py`` ``cast_compute``).

``--superstep`` works as in the JAX package on one device, where every
worker of this port runs (``Trainer._elastic_mode``):

- ``auto`` (the default) and ``on`` give ``"scan"`` in one process: each
  training step of the elastic and packed epochs is replayed from a CUDA
  graph captured once per step key (``train/supersteps.py``), a window's
  steps in one host dispatch; on the CPU the same executor runs each step
  eagerly from its static slots. Across ranks they give ``"window"``: each
  step's forward/backward replayed from its graph, the collective and the
  update eager between the replays.
- ``off`` gives ``"step"``: the eager per-step loop, the parity and
  host-overhead reference. One difference from the JAX package: ``off``
  keeps the packed step eager too, so both paths have an eager arm on the
  card (the JAX ``off`` leaves its fused packed scan as it is).

``stream_chunk_steps`` and ``superstep_window`` cut the elastic epoch into
the JAX package's dispatch windows (with ``--superstep off``,
``stream_chunk_steps`` alone): the boundaries at which ``--rebalance
window`` evaluates its controller, and in scan mode the steps that one
dispatch runs.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence

from dynamic_load_balance_distributeddnn_tpu_torch.parallel.topology import parse_hier_levels

MODELS = [
    "mnistnet",
    "resnet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "densenet", "densenet121", "densenet169", "densenet201", "densenet161",
    "googlenet",
    "regnet", "regnetx200mf", "regnetx400mf", "regnety400mf",
    "transformer",
]
DATASETS = ["cifar10", "cifar100", "mnist", "wikitext2"]


def str2bool(v) -> bool:
    """Boolean coercion with the reference's accepted spellings."""
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def _env_int(name: str, default: int) -> int:
    """Integer from the environment; empty/whitespace counts as unset."""
    v = os.environ.get(name, "").strip()
    if not v:
        return default
    try:
        return int(v)
    except ValueError:
        raise SystemExit(f"env var {name} must be an integer, got {v!r}")


def device_map(v):
    """Worker→device map: a single device ordinal or a comma list, one entry
    per worker (the reference's ``-gpu 0,0,0,1``)."""
    if isinstance(v, int):
        return v
    if isinstance(v, (list, tuple)):
        return [int(g) for g in v]
    if "," in v:
        return [int(g) for g in v.split(",")]
    return int(v)


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- reference-parity flags ----
    debug: bool = True
    world_size: int = 4
    batch_size: int = 64
    learning_rate: float = 0.01
    epoch_size: int = 10
    dataset: str = "wikitext2"
    dynamic_batch_size: bool = True
    device: object = None              # worker→device map; a process owns
                                       # one device, so a process's slice
                                       # of the map names one device
    model: str = "transformer"
    fault_tolerance: bool = False
    fault_tolerance_chance: float = 0.1
    one_cycle_policy: bool = False
    disable_enhancements: bool = False

    # ---- the JAX package's extras, same names and defaults ----
    seed: int = 1234
    n_train: int = 0
    momentum: float = 0.9
    bucket: int = 16
    capacity_factor: float = 2.0
    snap_to_bucket: bool = True
    time_smoothing: float = 0.0
    probe_overhead_correction: bool = True
    probe_mode: str = "adaptive"
    probe_every: int = 5
    probe_wall_tol: float = 0.25
    fault_mode: str = "virtual"
    straggler: str = ""
    precision: str = "float32"
    data_dir: str = "./data"
    lm_data_dir: str = "./rnn_data/wikitext-2"
    log_dir: str = "./logs"
    stat_dir: str = "./statis"
    ckpt_dir: str = ""
    bptt: int = 35
    seq_parallel: str = ""
    grad_clip: float = 0.0
    profile_dir: str = ""
    use_pallas: bool = True            # JAX default is False; see module doc
    use_flash_attention: bool = False
    remat: bool = False
    fused_dbs: bool = False
    grad_comm: str = "flat"
    grad_comm_wire: str = "int8"
    dcn_bandwidth_probe: bool = False
    hier_hosts: int = 0
    hier_levels: str = ""
    grad_comm_wires: str = ""
    dcn_probe_gate: float = 0.95
    compress_grads: str = ""
    grad_accum: int = 1
    shard_update: bool = False
    stream_chunk_steps: int = 128
    warm_start: bool = False
    aot_warm: bool = True
    aot_pool: int = 0
    aot_backend: str = "thread"
    aot_workers: int = 0
    aot_speculate: bool = True
    speculate_scan: bool = True
    device_cache: str = "auto"
    device_cache_mb: int = 512
    coordinator: str = ""
    num_processes: int = 0
    process_id: int = -1
    superstep: str = "auto"
    superstep_window: int = 16
    trace: str = "off"
    trace_ring: int = 1_000_000
    trace_dir: str = "./traces"
    trace_annotations: bool = False
    trace_spool: str = ""
    trace_spool_flush_s: float = 0.25
    trace_spool_fsync: bool = False
    elastic: str = "off"
    elastic_detect_misses: int = 2
    elastic_latency_factor: float = 8.0
    elastic_readmit: str = "epoch"
    elastic_max_recoveries: int = 8
    rebalance: str = "epoch"
    rebalance_every: int = 1
    rebalance_hysteresis: float = 0.1
    rebalance_margin: float = 3.0
    rebalance_budget_frac: float = 0.5
    rebalance_rate_alpha: float = 0.5
    fault_schedule: str = "none"
    fault_period: float = 2.0
    packed: str = "auto"

    def __post_init__(self):
        """The JAX ``Config.__post_init__``'s checks, copied in its order
        (each raises the JAX package's exception type), then this port's
        own: ``bucket``, ``precision`` and the flags it does not have yet."""
        if self.model not in MODELS:
            raise ValueError(f"invalid model {self.model!r}; choose from {MODELS}")
        if self.dataset not in DATASETS:
            raise ValueError(f"invalid dataset {self.dataset!r}; choose from {DATASETS}")
        if self.world_size < 1:
            raise ValueError("world_size must be >= 1")
        if isinstance(self.device, list) and len(self.device) != self.world_size:
            raise ValueError("device map length must equal world_size")
        if self.fault_mode not in ("virtual", "compute"):
            raise ValueError("fault_mode must be 'virtual' or 'compute'")
        if self.probe_mode not in ("adaptive", "always"):
            raise ValueError("probe_mode must be 'adaptive' or 'always'")
        if self.straggler and len(self.straggler_factors()) != self.world_size:
            raise ValueError("straggler factor list length must equal world_size")
        self._check_comm()
        if self.device_cache not in ("auto", "on", "off"):
            raise ValueError("device_cache must be 'auto', 'on' or 'off'")
        if self.packed not in ("auto", "on", "off"):
            raise ValueError("packed must be 'auto', 'on' or 'off'")
        if self.superstep not in ("auto", "on", "off"):
            raise ValueError("superstep must be 'auto', 'on' or 'off'")
        if self.elastic not in ("on", "off"):
            raise ValueError("elastic must be 'on' or 'off'")
        if self.elastic_detect_misses < 1:
            raise ValueError("elastic_detect_misses must be >= 1")
        if self.elastic_readmit not in ("epoch", "off"):
            raise ValueError("elastic_readmit must be 'epoch' or 'off'")
        self._check_rebalance()
        self._check_trace_and_compile()
        if self.compress_grads and self.dynamic_batch_size and not self.fused_dbs:
            raise ValueError(
                "compress_grads rides a fused path (the elastic DBS combine "
                "keeps exact f32 gradients); enable fused_dbs to combine it "
                "with the balancer"
            )
        if self.grad_accum > 1 and self.dynamic_batch_size and not self.fused_dbs:
            raise ValueError(
                "grad_accum rides a fused path; the elastic DBS path controls "
                "memory by shrinking per-worker batches instead"
            )
        if self.bucket < 1:
            raise ValueError("bucket must be >= 1")
        if self.precision not in ("float32", "bfloat16"):
            raise ValueError("precision must be 'float32' or 'bfloat16'")
        self._reject_unported()

    def _check_comm(self) -> None:
        """The JAX package's checks of the gradient-collective flags, in its
        order, with its exception types and messages."""
        if self.compress_grads not in ("", "int8"):
            raise ValueError("compress_grads must be '' or 'int8'")
        if self.grad_comm not in ("flat", "hier"):
            raise ValueError("grad_comm must be 'flat' or 'hier'")
        if self.grad_comm_wire not in ("fp32", "int8", "int4"):
            raise ValueError("grad_comm_wire must be 'fp32', 'int8' or 'int4'")
        if self.hier_hosts < 0:
            raise ValueError("hier_hosts must be >= 0 (0 = real topology)")
        if self.hier_levels:
            spec = self.hier_levels.strip()
            if spec == "learned" or spec.startswith("learned,"):
                spec = spec[len("learned"):].lstrip(",")
            parse_hier_levels(spec)  # raises on malformed entries
        if self.grad_comm_wires and self.grad_comm_wires != "auto":
            for w in self.grad_comm_wires.split(","):
                if w.strip() not in ("fp32", "int8", "int4"):
                    raise ValueError(
                        f"grad_comm_wires entry {w.strip()!r} must be "
                        "'fp32', 'int8' or 'int4' (or the whole flag 'auto')"
                    )
        if not (0.0 < self.dcn_probe_gate <= 1.5):
            raise ValueError("dcn_probe_gate must be in (0, 1.5]")
        if self.grad_comm == "hier" and self.compress_grads:
            raise ValueError(
                "grad_comm=hier subsumes compress_grads: the cross-host hop "
                "already rides --grad_comm_wire (the flat int8 collective "
                "stays available via compress_grads with grad_comm=flat)"
            )
        if self.grad_comm == "hier" and self.seq_parallel:
            raise ValueError(
                "grad_comm=hier applies to the data-parallel gradient "
                "combine; the sequence-parallel modes shard the sequence "
                "axis instead"
            )

    def _check_rebalance(self) -> None:
        """The JAX package's checks of the window-cadence controller and the
        time-varying straggler schedule."""
        if self.rebalance not in ("epoch", "window"):
            raise ValueError("rebalance must be 'epoch' or 'window'")
        if self.rebalance_every < 1:
            raise ValueError("rebalance_every must be >= 1")
        if self.rebalance_hysteresis < 0 or self.rebalance_margin < 0:
            raise ValueError("rebalance hysteresis/margin must be >= 0")
        if self.rebalance_budget_frac <= 0:
            raise ValueError("rebalance_budget_frac must be > 0")
        if not 0.0 < self.rebalance_rate_alpha <= 1.0:
            raise ValueError("rebalance_rate_alpha must be in (0, 1]")
        if self.fault_schedule not in (
            "none", "sin", "ramp", "spike", "diurnal", "brownout", "killstorm"
        ):
            raise ValueError(
                "fault_schedule must be 'none', 'sin', 'ramp', 'spike', "
                "'diurnal', 'brownout' or 'killstorm'"
            )
        if self.fault_period <= 0:
            raise ValueError("fault_period must be > 0 epochs")
        if self.fault_schedule != "none" and not self.straggler:
            raise ValueError("fault_schedule needs --straggler factors to modulate")
        if self.rebalance == "window" and not self.dynamic_batch_size:
            raise ValueError(
                "rebalance=window is a DBS control-loop cadence; it needs "
                "dynamic_batch_size on"
            )

        if self.rebalance == "window" and self.fused_dbs:
            raise ValueError(
                "rebalance=window retires windows mid-epoch on the elastic "
                "dispatch paths; the fused-DBS whole-epoch scan has no "
                "window boundary to act at"
            )

    def _check_trace_and_compile(self) -> None:
        """The JAX package's checks of the trace, superstep-window and
        compile-service flags (its last two, ``compress_grads`` and
        ``grad_accum`` riding a fused path, follow in ``__post_init__``)."""
        if self.trace not in ("on", "off", "ring"):
            raise ValueError("trace must be 'on', 'off' or 'ring'")
        if self.trace_ring < 1:
            raise ValueError("trace_ring must be >= 1")
        if self.trace_spool_flush_s <= 0:
            raise ValueError("trace_spool_flush_s must be > 0")
        if self.trace_spool and self.trace == "off":
            # the flight recorder streams the tracer's events: with tracing
            # off it would record nothing for the run it was set to protect
            raise ValueError("trace_spool requires tracing: set --trace ring (or on)")
        if self.superstep_window < 1:
            raise ValueError("superstep_window must be >= 1")
        if self.aot_pool < 0:
            raise ValueError("aot_pool must be >= 0 (0 = auto)")
        if self.aot_backend not in ("thread", "process"):
            raise ValueError("aot_backend must be 'thread' or 'process'")
        if self.aot_workers < 0:
            raise ValueError("aot_workers must be >= 0 (0 = auto)")

    def _reject_unported(self) -> None:
        """Features of the JAX package that this port does not have yet:
        each raises, naming its flag, instead of being silently ignored."""
        if self.dataset == "wikitext2" and self.model != "transformer":
            raise ValueError(
                f"-m {self.model} -ds wikitext2: wikitext2 is the transformer's "
                "corpus, the vision models train on image datasets"
            )
        if self.num_processes > 0 and self.process_id >= self.num_processes:
            raise ValueError(
                f"process_id {self.process_id} must be below num_processes {self.num_processes}"
            )
        if self.process_id > 0 and self.num_processes <= 0:
            raise NotImplementedError(
                f"--process_id={self.process_id} without --num_processes: torch.distributed "
                "needs the process count (the JAX package's autodetection on TPU pods is not "
                "implemented by this port)"
            )
        if self.coordinator and (self.num_processes <= 0 or self.process_id < 0):
            raise NotImplementedError(
                f"--coordinator={self.coordinator!r} without --num_processes and --process_id: "
                "torch.distributed needs both (the JAX package's autodetection on TPU pods is "
                "not implemented by this port)"
            )
        n_proc = max(self.num_processes, 1)
        if isinstance(self.device, list) and self.world_size % n_proc == 0:
            per = self.world_size // n_proc
            for p in range(n_proc):
                devs = set(self.device[p * per:(p + 1) * per])
                if len(devs) > 1:
                    raise NotImplementedError(
                        f"-gpu {self.device}: process {p}'s workers name devices "
                        f"{sorted(devs)}; a process of this port owns one device: launch "
                        "one process a device with --coordinator, --num_processes and "
                        "--process_id (or DBS_COORDINATOR, DBS_NUM_PROCESSES, DBS_PROCESS_ID)"
                    )
        if self.rebalance == "window" and self.model == "transformer" and n_proc == 1 \
                and not self.seq_parallel:
            raise NotImplementedError(
                "--rebalance='window' with -m transformer is not implemented by "
                "this port: a remainder plan re-slices examples, not a token "
                "stream folded into bptt windows, and the JAX package's language "
                "model fails at its first switch (ROADMAP.md lists what is left)"
            )

    def straggler_factors(self) -> List[float]:
        return [float(x) for x in self.straggler.split(",")] if self.straggler else []

    def worker_device_ids(self, n_devices: int) -> List[int]:
        """The worker→device map resolved over ``n_devices`` local devices:
        a list verbatim (mod ``n_devices``), an int pins every worker to
        that device. Unlike the JAX package, None (the default) puts every
        worker on the process's current device, not round-robin: a
        process of this port owns one device."""
        if isinstance(self.device, list):
            return [d % n_devices for d in self.device]
        if isinstance(self.device, int):
            return [self.device % n_devices] * self.world_size
        return [0] * self.world_size

    def base_filename(self) -> str:
        """Config-encoded artifact name, the JAX package's exactly; ``{}`` is
        the worker-rank placeholder."""
        name = (
            f"{self.model}-{self.dataset}-debug{int(self.debug)}-n{self.world_size}"
            f"-bs{self.batch_size}-lr{self.learning_rate:.4f}-ep{self.epoch_size}"
            f"-dbs{int(self.dynamic_batch_size)}-ft{int(self.fault_tolerance)}"
            f"-ftc{self.fault_tolerance_chance:f}-node{{}}"
            f"-ocp{int(self.one_cycle_policy)}"
        )
        if self.disable_enhancements:
            name = "puredbs=" + name
        if self.seq_parallel:
            name = f"sp_{self.seq_parallel}=" + name
        return name


def get_parser() -> argparse.ArgumentParser:
    """The JAX package's parser: the reference's 13 flags plus its extras,
    with the same names, short names, defaults and coercers."""
    p = argparse.ArgumentParser(
        description="Dynamic Batch Size for Distributed DNN Training — PyTorch/CUDA port"
    )
    d = Config.__dataclass_fields__
    dflt = {k: f.default for k, f in d.items()}
    p.add_argument("-d", "--debug", type=str2bool, default=dflt["debug"])
    p.add_argument("-ws", "--world_size", type=int, default=dflt["world_size"])
    p.add_argument("-b", "--batch_size", type=int, default=dflt["batch_size"])
    p.add_argument("-lr", "--learning_rate", type=float, default=dflt["learning_rate"])
    p.add_argument("-e", "--epoch_size", type=int, default=dflt["epoch_size"])
    p.add_argument("-ds", "--dataset", type=str, default=dflt["dataset"], choices=DATASETS)
    p.add_argument("-dbs", "--dynamic_batch_size", type=str2bool,
                   default=dflt["dynamic_batch_size"])
    p.add_argument("-gpu", "-dev", "--device", type=device_map, default=None,
                   help="Worker→device map, e.g. '0,0,0,0'; a process of "
                        "this port owns one device.")
    p.add_argument("-m", "--model", type=str, default=dflt["model"], choices=MODELS)
    p.add_argument("-ft", "--fault_tolerance", type=str2bool,
                   default=dflt["fault_tolerance"])
    p.add_argument("-ftc", "--fault_tolerance_chance", type=float,
                   default=dflt["fault_tolerance_chance"])
    p.add_argument("-ocp", "--one_cycle_policy", type=str2bool,
                   default=dflt["one_cycle_policy"])
    p.add_argument("-de", "--disable_enhancements", type=str2bool,
                   default=dflt["disable_enhancements"])
    typed = {
        "seed": int, "n_train": int, "momentum": float, "bucket": int,
        "capacity_factor": float, "snap_to_bucket": str2bool,
        "remat": str2bool, "fused_dbs": str2bool,
        "dcn_bandwidth_probe": str2bool, "hier_hosts": int,
        "hier_levels": str, "grad_comm_wires": str, "dcn_probe_gate": float,
        "grad_accum": int, "shard_update": str2bool,
        "stream_chunk_steps": int, "time_smoothing": float,
        "probe_overhead_correction": str2bool, "probe_every": int,
        "probe_wall_tol": float, "straggler": str, "data_dir": str,
        "lm_data_dir": str, "log_dir": str, "stat_dir": str, "ckpt_dir": str,
        "bptt": int, "grad_clip": float, "profile_dir": str,
        "use_pallas": str2bool, "use_flash_attention": str2bool,
        "warm_start": str2bool, "aot_warm": str2bool, "aot_pool": int,
        "aot_workers": int, "aot_speculate": str2bool,
        "speculate_scan": str2bool, "device_cache_mb": int,
        "superstep_window": int, "trace_ring": int, "trace_dir": str,
        "trace_annotations": str2bool, "trace_spool": str,
        "trace_spool_flush_s": float, "trace_spool_fsync": str2bool,
        "elastic_detect_misses": int, "elastic_latency_factor": float,
        "elastic_max_recoveries": int, "rebalance_every": int,
        "rebalance_hysteresis": float, "rebalance_margin": float,
        "rebalance_budget_frac": float, "rebalance_rate_alpha": float,
        "fault_period": float,
    }
    for name, coerce in typed.items():
        p.add_argument(f"--{name}", type=coerce, default=dflt[name])
    choices = {
        "grad_comm": ["flat", "hier"],
        "grad_comm_wire": ["fp32", "int8", "int4"],
        "compress_grads": ["", "int8"],
        "probe_mode": ["adaptive", "always"],
        "fault_mode": ["virtual", "compute"],
        "precision": ["float32", "bfloat16"],
        "seq_parallel": ["", "ring", "ulysses"],
        "aot_backend": ["thread", "process"],
        "device_cache": ["auto", "on", "off"],
        "superstep": ["auto", "on", "off"],
        "trace": ["on", "off", "ring"],
        "elastic": ["on", "off"],
        "elastic_readmit": ["epoch", "off"],
        "rebalance": ["epoch", "window"],
        "fault_schedule": ["none", "sin", "ramp", "spike", "diurnal",
                           "brownout", "killstorm"],
        "packed": ["auto", "on", "off"],
    }
    for name, allowed in choices.items():
        p.add_argument(f"--{name}", type=str, default=dflt[name], choices=allowed)
    p.add_argument("--coordinator", type=str,
                   default=os.environ.get("DBS_COORDINATOR", dflt["coordinator"]))
    p.add_argument("--num_processes", type=int,
                   default=_env_int("DBS_NUM_PROCESSES", dflt["num_processes"]))
    p.add_argument("--process_id", type=int,
                   default=_env_int("DBS_PROCESS_ID", dflt["process_id"]))
    return p


def config_from_args(argv: Optional[Sequence[str]] = None) -> Config:
    ns = get_parser().parse_args(argv)
    return Config(**vars(ns))
