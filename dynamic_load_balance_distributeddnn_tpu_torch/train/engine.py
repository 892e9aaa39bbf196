"""The training engine: the DBS feedback loop on one card.

The JAX package's ``Trainer`` (``train/engine.py``), lean: one controller
drives every logical worker, all on one device (the analogue of the
reference's ``-gpu 0,0,0,0`` contention recipe).

    for epoch:
        adjust LR (one-cycle)                     _plan_epoch
        shares <- solver(node_times, shares)      _plan_epoch
        plan   <- partition dataset + batches     _plan_epoch
        faults <- injector; probe or not?         _plan_epoch (_should_probe)
        train one epoch                           _dispatch_epoch:
            packed: one step over the workers' concatenated batches
            elastic: per-worker steps, summed     _train_epoch_packed / _elastic
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
    LuckyFaultInjector,
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
from dynamic_load_balance_distributeddnn_tpu_torch.ops.faultload import SyntheticLoad
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
    packed_step,
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
        self._can_use_packed(None)  # --packed on fails here where it cannot engage

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

    def _make_injector(self) -> FaultInjector:
        """The JAX package's order: a straggler profile, else the
        reference's random faults (``-ft``), else none."""
        cfg = self.cfg
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
        train_metrics = self._dispatch_epoch(plan, faults, epoch)
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
        ctx = FaultContext(
            batch_sizes=plan.batch_sizes.astype(np.float64),
            iter_cost_s=(
                (self._iter_cost_s or self.load.calibrate_iter_cost(self.device))
                if self._needs_iter_cost
                else None
            ),
            per_example_cost_s=(
                self.per_example_cost if np.isfinite(self.per_example_cost).all() else None
            ),
        )
        faults = self.injector.epoch_faults(epoch, plan.num_steps, ctx)
        self._probe_this_epoch = self._should_probe(epoch, plan, faults)
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
        if not np.isfinite(self.per_example_cost).all():
            return True
        if self._needs_iter_cost and self._iter_cost_s is None:
            return True
        if self._episode_changed(plan, faults):
            return True  # the injection episode changed: re-anchor on reality
        return epoch >= self._next_probe_epoch

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
            self.bundle is not None
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

    def _dispatch_epoch(self, plan, faults: EpochFaults, epoch: int) -> Dict[str, float]:
        """Path selection and the epoch's training (probes included)."""
        packed = self._can_use_packed(plan)
        self.recorder.meta.setdefault("paths", []).append("packed" if packed else "elastic")
        if packed:
            return self._train_epoch_packed(plan, faults, epoch)
        return self._train_epoch_elastic(plan, faults, epoch)

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
        slow = faults.slow_iters_per_step.tolist()
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
            step_loss = elastic_step(
                self.model, self.optimizer, batches, self.grad_clip, self.load, slow
            )
            if step_loss is not None:
                loss_sum += step_loss
        self._sync()
        return self._finish_epoch(plan, faults, epoch, loss_sum, count, lambda: first)

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
        loss_sum = torch.zeros((), device=self.device)
        for s in steps:
            sel = idx[offs[s] : offs[s + 1]]
            batch = (self._prep(self.train_x[sel]), self.train_y[sel], w[offs[s] : offs[s + 1]])
            loss_sum += packed_step(self.model, self.optimizer, batch, self.load, slow)
        self._sync()

        def first():
            return [self._worker_epoch(plan, r)(0)[0] for r in range(self.world_size)]

        return self._finish_epoch(plan, faults, epoch, loss_sum, offs[-1], first)

    def _finish_epoch(self, plan, faults: EpochFaults, epoch: int, loss_sum, count: int,
                      first_batches) -> Dict[str, float]:
        """The balancer's signal after the epoch's steps: the probes when
        this epoch takes them (on ``first_batches()``), or the timing
        model; the virtual injected seconds; the epoch's train metrics."""
        cfg = self.cfg
        dbs_probe_cost = 0.0
        if (
            self.timing_model is None
            and self._probe_this_epoch
            and (cfg.dynamic_batch_size or self._needs_iter_cost)
        ):
            t0 = time.perf_counter()
            self._sync_per_step = self._probe_workers(plan, first_batches(), faults, epoch)
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
        slow = [int(n) for n in faults.slow_iters_per_step]
        for r, b in enumerate(batches):  # untimed warm pass
            if b is not None:
                probe_grads(model, params, b, clip, load, slow[r])
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
                g = probe_grads(model, params, b, clip, load, n_slow)
                self._sync()
                dt = min(dt, time.perf_counter() - t0)
            return max(dt - ovh, 0.2 * dt), dt, g

        init_epoch = bool(np.isnan(self.per_example_cost).any())
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
        combine_probe(self.optimizer, grads)  # warm
        self._sync()
        t0 = time.perf_counter()
        combine_probe(self.optimizer, grads)
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
        if (
            not self._probe_this_epoch
            and self.timing_model is None
            and (cfg.dynamic_batch_size or self._needs_iter_cost)
        ):
            # probes skipped: the solver runs on modeled per-worker times
            self._model_compute_times(plan, faults)
        self._update_probe_schedule(epoch, plan, faults, epoch_wall)
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
        if self._needs_iter_cost:
            prof = self._realized_injection_profile(plan, faults)
            if prof is not None:
                self.recorder.meta["realized_injection_profile"] = prof
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
