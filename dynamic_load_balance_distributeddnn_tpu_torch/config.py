"""Run configuration: the JAX package's CLI surface, copied.

Same flags, short flags, defaults and coercers as the reference
``config.py`` (``Config``, ``get_parser``, ``config_from_args``,
``base_filename``), so a command line written for the JAX trainer parses
here unchanged and artifacts land under the same config-encoded names.

Two defaults differ, both because this port has no use for the other value:

- ``probe_mode`` is ``"always"``: the adaptive probe schedule is not ported
  yet, so ``adaptive`` is rejected.
- ``use_pallas`` is ``True``: on the card the kernels always run; an
  explicit ``--use_pallas false`` with a CUDA device is rejected by the
  trainer, so the card never quietly runs the plain path.

A flag whose feature this port does not implement yet raises
``NotImplementedError`` naming the flag when it is set to a non-default
value. Flags that tune only the JAX package's compile service, device cache
or dispatch windows (``aot_*``, ``speculate_scan``, ``warm_start``,
``device_cache*``, ``stream_chunk_steps``, ``superstep_window``) have no
meaning for an eager PyTorch program; they are accepted and have no effect.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
from typing import List, Optional, Sequence

MODELS = [
    "mnistnet",
    "resnet", "resnet18", "resnet34", "resnet50", "resnet101", "resnet152",
    "densenet", "densenet121", "densenet169", "densenet201", "densenet161",
    "googlenet",
    "regnet", "regnetx200mf", "regnetx400mf", "regnety400mf",
    "transformer",
]
DATASETS = ["cifar10", "cifar100", "mnist", "wikitext2"]

# Models this port builds (models/__init__.py build_model).
PORTED_MODELS = (
    "mnistnet", "densenet", "densenet121", "densenet169", "densenet201",
    "densenet161", "transformer",
)


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
    device: object = None              # worker→device map; every worker of
                                       # this port shares one card, so the
                                       # map may name one device only
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
    probe_mode: str = "always"         # JAX default is "adaptive" (not ported)
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
        if self.bucket < 1:
            raise ValueError("bucket must be >= 1")
        self._reject_unported()

    def _reject_unported(self) -> None:
        """Features of the JAX package that this port does not have yet:
        each raises, naming its flag, instead of being silently ignored."""
        if self.model not in PORTED_MODELS:
            raise NotImplementedError(
                f"-m {self.model}: this port builds {list(PORTED_MODELS)} only"
            )
        if self.dataset == "wikitext2" and self.model != "transformer":
            raise ValueError(
                f"-m {self.model} -ds wikitext2: wikitext2 is the transformer's "
                "corpus, the vision models train on image datasets"
            )
        devs = self.device if isinstance(self.device, list) else [self.device]
        if len({d for d in devs if d is not None}) > 1:
            raise NotImplementedError(
                f"-gpu {self.device}: every worker of this port shares one "
                "card; name a single device (e.g. 0,0,0,0)"
            )
        unported = {
            "probe_mode": self.probe_mode == "adaptive",
            "fused_dbs": self.fused_dbs,
            "shard_update": self.shard_update,
            "grad_comm": self.grad_comm != "flat",
            "compress_grads": bool(self.compress_grads),
            "grad_accum": self.grad_accum != 1,
            "rebalance": self.rebalance != "epoch",
            "elastic": self.elastic != "off",
            "coordinator": bool(self.coordinator),
            "trace": self.trace != "off",
            "seq_parallel": bool(self.seq_parallel),
            "fault_mode": self.fault_mode != "virtual",
            "fault_schedule": self.fault_schedule != "none",
            "fault_tolerance": self.fault_tolerance and not self.straggler,
            "precision": self.precision != "float32",
            "remat": self.remat,
            "ckpt_dir": bool(self.ckpt_dir),
            "profile_dir": bool(self.profile_dir),
            "packed": self.packed == "on",
            "superstep": self.superstep == "on",
        }
        for flag, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"--{flag}={getattr(self, flag)!r} is not implemented by "
                    "this port yet (ROADMAP.md lists what is left)"
                )

    def straggler_factors(self) -> List[float]:
        return [float(x) for x in self.straggler.split(",")] if self.straggler else []

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
                   help="Worker→device map, e.g. '0,0,0,0'; every worker "
                        "shares one card in this port.")
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
