"""The training engine: the DBS feedback loop on one card.

The JAX package's ``Trainer`` (``train/engine.py``), lean: one controller
drives every logical worker, all on one device (the analogue of the
reference's ``-gpu 0,0,0,0`` contention recipe), through the elastic path.

    for epoch:
        adjust LR (one-cycle)                     _plan_epoch
        shares <- solver(node_times, shares)      _plan_epoch
        plan   <- partition dataset + batches     _plan_epoch
        train one epoch, per-step weighted combine  _train_epoch_elastic
        time each worker's step (probe)           _probe_workers
        validate                                  validate
        node_times <- compute * multipliers + injected   _record_epoch
        record the 9 metric series                _record_epoch

Per-worker compute time on an asynchronous device is not a host clock
around a launched call, so the engine times a *probe*: one standalone
forward/backward of each worker's batch after ``torch.cuda.synchronize()``,
min over 3 repetitions, scaled by the worker's step count. The combine +
update is probed separately as ``sync_time`` and never enters the solver's
vector (PARITY contract 4). A ``timing_model`` replaces the probes with a
deterministic model, as in the JAX package.

The language-model trainer (``train/lm_engine.py``) subclasses this one and
overrides the data plane: ``SNAP_BATCHES``, ``_setup_data``,
``_setup_model``, ``_build_plan``, ``_worker_epoch`` and ``validate``.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.balance import (
    TimeKeeper,
    exchange_times,
    initial_partition,
    integer_batch_split,
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import (
    DatasetBundle,
    build_epoch_plan,
    load_dataset,
)
from dynamic_load_balance_distributeddnn_tpu_torch.faults import (
    EpochFaults,
    FaultContext,
    FaultInjector,
    NullInjector,
    StaticStragglerInjector,
)
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import (
    Dropout,
    init_flax_defaults,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs import MetricsRecorder, init_logger
from dynamic_load_balance_distributeddnn_tpu_torch.ops.augment import (
    augment_images,
    normalize_images,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.ops.losses import example_weights
from dynamic_load_balance_distributeddnn_tpu_torch.train.schedule import one_cycle_lr
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import (
    learning_rate,
    make_optimizer,
    set_learning_rate,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import (
    combine_probe,
    elastic_step,
    probe_grads,
)

_EVAL_CHUNK = 1024


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
        self.device = resolve_device(device)
        if self.device.type == "cuda" and not cfg.use_pallas:
            raise ValueError(
                "--use_pallas false: on the card this port always runs its "
                "CUDA kernels (the plain versions are for CPU tensors)"
            )
        self.cfg = cfg
        self.timing_model = timing_model
        self.logger = logger or init_logger(cfg, to_file=log_to_file)
        self.world_size = cfg.world_size

        self._setup_data(bundle)
        self._setup_model()

        if injector is not None:
            self.injector = injector
        elif cfg.straggler:
            self.injector = StaticStragglerInjector(
                cfg.straggler_factors(), mode=cfg.fault_mode
            )
        else:
            self.injector = NullInjector(cfg.world_size)

        self.recorder = MetricsRecorder()
        self.recorder.stamp_data_source(
            self.bundle if self.bundle is not None else getattr(self, "corpus", None)
        )
        self.recorder.meta["wall_excludes_probes"] = True
        self.recorder.meta["device"] = str(self.device)
        if self.device.type == "cuda":
            self.recorder.meta["device_name"] = torch.cuda.get_device_name(self.device)
        if cfg.straggler:
            self.recorder.meta["straggler_factors"] = cfg.straggler_factors()
            self.recorder.meta["fault_mode"] = cfg.fault_mode
        self.shares = initial_partition(cfg.world_size)
        self.node_times = np.ones(cfg.world_size, dtype=np.float64)
        self.timekeeper = TimeKeeper(cfg.world_size)
        self.total_wallclock = 0.0
        self.total_probe_s = 0.0
        self._sync_per_step = 0.0
        self._probe_this_epoch = True

    # -------------------------------------------------------------- set-up

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

    def _use_seeded_dropout(self) -> None:
        """Point every dropout of the model at the trainer's generator."""
        self.dropout_gen = torch.Generator(device=self.device).manual_seed(self.cfg.seed)
        for m in self.model.modules():
            if isinstance(m, Dropout):
                m.generator = self.dropout_gen

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------ run

    def run(self, epochs: Optional[int] = None) -> MetricsRecorder:
        cfg = self.cfg
        epochs = cfg.epoch_size if epochs is None else epochs
        self.logger.info(
            f"Starting: {cfg.model}/{cfg.dataset}, ws={cfg.world_size}, "
            f"B={cfg.batch_size}, device={self.device}, dbs={cfg.dynamic_batch_size}"
        )
        for epoch in range(epochs):
            self.run_epoch(epoch)
        self.recorder.save(cfg.stat_dir, cfg.base_filename())
        self.logger.info(
            f"Total wallclock: {self.total_wallclock:.3f}s"
            + (f" (+{self.total_probe_s:.3f}s probe)" if self.total_probe_s > 0 else "")
        )
        return self.recorder

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        plan, faults = self._plan_epoch(epoch)
        t_epoch = time.perf_counter()
        train_metrics = self._train_epoch_elastic(plan, faults, epoch)
        # the wall excludes the probes, as the JAX package's does
        probe_s = train_metrics["dbs_probe_cost"]
        epoch_wall = time.perf_counter() - t_epoch - probe_s
        self.total_wallclock += epoch_wall
        self.total_probe_s += probe_s
        val_loss, accuracy = self.validate()
        self._record_epoch(
            epoch, plan, faults, train_metrics, epoch_wall, probe_s, val_loss, accuracy
        )
        return {
            "epoch_wall": epoch_wall,
            "loss": train_metrics["loss"],
            "val_loss": val_loss,
            "accuracy": accuracy,
        }

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
        ctx = FaultContext(batch_sizes=plan.batch_sizes.astype(np.float64))
        faults = self.injector.epoch_faults(epoch, plan.num_steps, ctx)
        # probe_mode "always": the balancer's signal is re-measured every
        # epoch it is needed (a timing model stands in for the probes)
        self._probe_this_epoch = cfg.dynamic_batch_size
        return plan, faults

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

    # ---------------------------------------------------------- train epoch

    def _worker_epoch(self, plan, rank: int):
        """Worker ``rank``'s batch supplier for the epoch: a function of the
        step returning ``(batch, count)``, ``batch`` an ``(x, y, w)`` on the
        device or None for a step with no real data, and ``count`` the
        entries with positive weight (the train loss's denominator)."""
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
        idx = torch.from_numpy(idx).to(self.device)
        w = torch.from_numpy(w).to(self.device)
        n_real = mask.sum(axis=1).tolist()  # real rows are a prefix

        def step(s: int):
            n = n_real[s]
            if n == 0:
                return None, 0  # all-padding step: weight 0, skipped
            rows = idx[s, :n]
            return (self._prep(self.train_x[rows]), self.train_y[rows], w[s, :n]), n

        return step

    def _prep(self, x_u8: torch.Tensor) -> torch.Tensor:
        mean, std = self.bundle.mean, self.bundle.std
        if self.augment:
            return augment_images(x_u8, mean, std, generator=self.aug_gen)
        return normalize_images(x_u8, mean, std)

    def _train_epoch_elastic(self, plan, faults: EpochFaults, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        self.timekeeper.reset()
        self.model.train()
        if self.augment:
            self.aug_gen.manual_seed(cfg.seed * 7919 + epoch)
        suppliers = [self._worker_epoch(plan, r) for r in range(self.world_size)]
        loss_sum = torch.zeros((), device=self.device)
        count = 0
        first = None
        for s in range(plan.num_steps):
            batches = []
            for supply in suppliers:
                b, n = supply(s)
                batches.append(b)
                count += n
            if first is None:
                first = batches  # the probes reuse the epoch's first batches
            step_loss = elastic_step(self.model, self.optimizer, batches, self.grad_clip)
            if step_loss is not None:
                loss_sum += step_loss
        self._sync()

        dbs_probe_cost = 0.0
        if self.timing_model is None and self._probe_this_epoch:
            t0 = time.perf_counter()
            self._sync_per_step = self._probe_workers(plan, first)
            dbs_probe_cost = time.perf_counter() - t0
        if self.timing_model is not None:
            modeled = np.asarray(self.timing_model(plan), dtype=np.float64)
            for r in range(self.world_size):
                self.timekeeper.add_compute(r, modeled[r])
        for r in range(self.world_size):
            self.timekeeper.add_injected(r, float(faults.virtual_seconds[r]))
        return {
            "loss": float(loss_sum) / max(count, 1),
            "sync_time": self._sync_per_step * plan.num_steps,
            "dbs_probe_cost": dbs_probe_cost,
        }

    def _probe_workers(self, plan, batches, reps: int = 3) -> float:
        """Time each worker's forward/backward standalone (min over ``reps``,
        each after a device synchronize) into the time keeper, then one
        combine + update, returned as the per-step sync time. Neither probe
        touches ``.grad``, the parameters or the optimizer state."""
        model, params = self.model, self.params
        for b in batches:  # untimed warm pass
            if b is not None:
                probe_grads(model, params, b, self.grad_clip)
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
        grads = []
        for r, b in enumerate(batches):
            if b is None:
                continue
            dt, g = float("inf"), None
            for _ in range(reps):
                self._sync()
                t0 = time.perf_counter()
                g = probe_grads(model, params, b, self.grad_clip)
                self._sync()
                dt = min(dt, time.perf_counter() - t0)
            dt = max(dt - ovh, 0.2 * dt)
            self.timekeeper.add_compute(r, dt * plan.workers[r].steps)
            grads.append(g)
        combine_probe(self.optimizer, grads)  # warm
        self._sync()
        t0 = time.perf_counter()
        combine_probe(self.optimizer, grads)
        self._sync()
        return time.perf_counter() - t0

    # ------------------------------------------------------------- validate

    @torch.no_grad()
    def validate(self) -> "tuple[float, float]":
        """Full-test-set loss and accuracy (percent)."""
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

    # --------------------------------------------------------------- record

    def _record_epoch(
        self, epoch: int, plan, faults: EpochFaults, train_metrics,
        epoch_wall: float, probe_s: float, val_loss: float, accuracy: float,
    ) -> None:
        cfg = self.cfg
        node_times = (
            self.timekeeper.compute_s * faults.time_multipliers
            + self.timekeeper.injected_s
        )
        fresh = exchange_times(node_times)
        if cfg.time_smoothing > 0.0 and epoch > 0:
            a = cfg.time_smoothing
            self.node_times = a * self.node_times + (1.0 - a) * fresh
        else:
            self.node_times = fresh
        self.logger.info(
            f"Epoch {epoch}: node times {np.round(self.node_times, 4).tolist()}, "
            f"train_loss {train_metrics['loss']:.4f}, val_loss {val_loss:.4f}, "
            f"accuracy {accuracy:.2f}, wall {epoch_wall:.3f}s"
        )
        extras = {"probe_time": probe_s}
        if epoch_wall > 0:
            extras["examples_per_s"] = self.n_train / epoch_wall
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
