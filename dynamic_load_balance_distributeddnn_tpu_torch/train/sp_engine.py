"""Long-context LM training: the sequence sharded over the ranks (the JAX
package's ``train/sp_engine.py``).

The DBS trainers split the data over workers; this one splits the sequence.
Each step takes one ``[B, bptt]`` window of the token stream folded into
``-b`` columns, gives rank ``p`` the block of positions ``[p * bptt / n,
(p + 1) * bptt / n)``, runs attention over the whole window through the ring
or the Ulysses all-to-all (``--seq_parallel ring|ulysses``,
``parallel/ring.py``, ``parallel/ulysses.py``), and sums the gradients over
the ranks (``parallel/seq_parallel.py``). ``n`` is the process group's
world size (1 without one); each process owns one device, as the DBS
trainers' ranks do.

The JAX trainer's contracts are kept: ``bptt % n == 0``; for Ulysses the
head count divides by ``n``; the model must be the transformer; full-length
windows only (the tail window is skipped); the gradient clipped to 0.25 on
its global norm (``--grad_clip`` when set), then SGD with momentum; the
one-cycle learning rate; dropout drawn per rank from ``fold_in(fold_in(
PRNGKey(seed), epoch * 131071 + step), rank)``; validation over the
validation stream in windows of eval batch 10, "accuracy" ``1 - val_loss``;
the recorder's ``partition [1/n] * n``, ``node_time [wall] * n`` and
``tokens_per_s``; the spans ``plan_solve``/``train``/``validate``/``record``;
the ``sp_<mode>=`` file name. The per-token loss, in training and in
validation, is K2 (``softmax_xent``), as the port's LM computes it.

Steps run eagerly: the collectives inside the forward and the backward
block the host (staged through pinned host memory when ranks share a card),
which a captured CUDA graph cannot hold; ``_meta["steps"]`` says so. Each
step's host time inside those collectives goes to ``_meta["collective"]``.
The model is built and initialised as ``LMTrainer``'s, so one seed gives
both trainers the same weights and their state dicts interchange.
"""

from __future__ import annotations

import os
import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, batchify, bptt_windows
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.obs import (
    EPOCH_CAT,
    MetricsRecorder,
    MetricsRegistry,
    get_tracer,
    init_logger,
)
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import (
    data_mesh,
    process_count,
    process_index,
)
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import fold_in, prng_key
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.seq_parallel import (
    seq_parallel_apply,
    seq_parallel_value_and_grad,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import (
    RANK_SERIES,
    rank_device,
    rank_report_base,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.schedule import one_cycle_lr
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import (
    make_optimizer,
    set_learning_rate,
)

EVAL_BSZ = 10  # dataloader.py:109
_STEP_STRIDE = 131071  # a step's key: fold_in(PRNGKey(seed), epoch * stride + step)


class TimedAxis:
    """The rank group of the model's collectives (``parallel/mesh.py``),
    adding each collective's host wall into ``seconds``."""

    def __init__(self, mesh):
        self.mesh, self.seconds = mesh, 0.0
        self.size, self.rank = mesh.size, mesh.rank

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        try:
            return fn(*args)
        finally:
            self.seconds += time.perf_counter() - t0

    def permute(self, t, shift):
        return self._timed(self.mesh.permute, t, shift)

    def all_to_all(self, t):
        return self._timed(self.mesh.all_to_all, t)

    def all_reduce_(self, t, op="sum"):
        return self._timed(self.mesh.all_reduce_, t, op)


class SeqParallelLMTrainer:
    """The epoch loop of sequence-parallel LM training (module docstring).
    Its steps run eagerly, so the warm service (``runtime/compiler.py``)
    has nothing to capture here, as the JAX trainer runs one ``jit`` a
    step outside its compile service."""

    # the reference LM's dimensions (dbs.py:337-343), LMTrainer's
    EMSIZE = 200
    NHEAD = 2
    NHID = 200
    NLAYERS = 2
    DROPOUT = 0.2

    def __init__(self, cfg: Config, corpus: Optional[Corpus] = None, device="cuda",
                 log_to_file: bool = True):
        if cfg.model != "transformer":
            raise ValueError("seq_parallel training applies to the transformer LM")
        if cfg.seq_parallel not in ("ring", "ulysses"):
            raise ValueError("seq_parallel must be 'ring' or 'ulysses'")
        self.cfg = cfg
        self.n_proc, self.proc_id = process_count(), process_index()
        self.device = rank_device(cfg, device, self.proc_id, self.n_proc)
        self.logger = init_logger(cfg, rank=self.proc_id, to_file=log_to_file)
        self.mesh = data_mesh(self.device)
        self.axis = TimedAxis(self.mesh)
        self.n_dev = self.mesh.size
        if cfg.bptt % self.n_dev != 0:
            raise ValueError(f"bptt {cfg.bptt} must divide by the {self.n_dev}-device mesh")
        if cfg.seq_parallel == "ulysses" and self.NHEAD % self.n_dev != 0:
            raise ValueError(
                f"ulysses needs num_heads ({self.NHEAD}) % n_devices ({self.n_dev}) == 0"
            )

        self.corpus = corpus if corpus is not None else Corpus(cfg.lm_data_dir)
        for note in getattr(self.corpus, "notes", []):
            self.logger.warning(f"corpus: {note}")
        stream = self.corpus.train
        if cfg.n_train:
            stream = stream[: cfg.n_train]
        elif cfg.debug and len(stream) > 60_000:
            stream = stream[:60_000]
        # [nbatch, B] token columns; a step consumes a [B, bptt] window
        self.data = batchify(stream, max(cfg.batch_size, 1))
        self.val_data = batchify(self.corpus.valid, EVAL_BSZ)

        model = build_model(
            "transformer", ntoken=self.corpus.ntokens, ninp=self.EMSIZE, nhead=self.NHEAD,
            nhid=self.NHID, nlayers=self.NLAYERS, dropout=self.DROPOUT,
            seq_axis=self.axis, sp_mode=cfg.seq_parallel,
        )
        init_flax_defaults(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate, cfg.momentum)
        self.grad_clip = cfg.grad_clip if cfg.grad_clip > 0 else 0.25  # dbs.py:274
        self.dropout_gen = torch.Generator(device=self.device)
        self._t_local = cfg.bptt // self.n_dev
        self._lo = self.mesh.rank * self._t_local

        self.recorder = MetricsRecorder()
        self._trace = get_tracer().configure(
            cfg.trace, ring_size=cfg.trace_ring, annotations=cfg.trace_annotations
        )
        self.obs = MetricsRegistry(recorder=self.recorder, tracer=self._trace)
        self.recorder.stamp_data_source(self.corpus)
        meta = self.recorder.meta
        meta["wall_excludes_probes"] = True  # no probes here: the same wall schema
        meta["device"] = str(self.device)
        meta["ranks"] = self.mesh.describe()
        meta["steps"] = ("eager: the collectives inside a step block the host, "
                         "so no step is captured into a CUDA graph")
        if self.device.type == "cuda":
            meta["device_name"] = torch.cuda.get_device_name(self.device)
        if cfg.straggler:
            meta["straggler_factors"] = [float(f) for f in cfg.straggler_factors()]
            meta["fault_mode"] = cfg.fault_mode
        self.total_wallclock = 0.0

    # ------------------------------------------------------------------ loop

    def _windows(self, data: np.ndarray):
        """``(x, y, mask)`` ``[windows, B, bptt]``: the full column set, only
        the tail window short (and skipped)."""
        return bptt_windows(data, self.cfg.bptt)

    def _local(self, a: np.ndarray) -> torch.Tensor:
        """This rank's block of a ``[B, bptt]`` window, on the device."""
        return torch.from_numpy(np.ascontiguousarray(a[:, self._lo:self._lo + self._t_local])).to(
            self.device)

    @torch.no_grad()
    def _update(self, grads) -> None:
        """Clip the summed gradient on its global norm, then SGD-momentum."""
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        torch._foreach_mul_(grads, torch.clamp(self.grad_clip / torch.clamp_min(norm, 1e-12),
                                               max=1.0))
        for p, g in zip(self.params, grads):
            p.grad = g
        self.optimizer.step()

    def run_epoch(self, epoch: int) -> Dict[str, float]:
        tr = self._trace
        tr.set_epoch(epoch)
        try:
            with tr.span("epoch", cat=EPOCH_CAT):
                return self._run_epoch(epoch)
        finally:
            tr.set_epoch(None)

    def _run_epoch(self, epoch: int) -> Dict[str, float]:
        cfg = self.cfg
        tr = self._trace
        with tr.span("plan_solve"):
            if cfg.one_cycle_policy:
                set_learning_rate(self.optimizer, one_cycle_lr(
                    cfg.learning_rate, epoch, cfg.epoch_size,
                    disable_enhancements=cfg.disable_enhancements))
            xs, ys, ms = self._windows(self.data)
        self.model.train()
        with tr.span("train"):
            t0 = time.perf_counter()
            loss_sum, tok, n_done, coll = 0.0, 0, 0, []
            for s in range(xs.shape[0]):
                if not ms[s].all():  # full-length windows only
                    continue
                before = self.axis.seconds
                key = fold_in(prng_key(cfg.seed), epoch * _STEP_STRIDE + s)
                loss, grads = seq_parallel_value_and_grad(
                    self.model, self._local(xs[s]), self._local(ys[s]), self.axis, train=True,
                    key=key, generator=self.dropout_gen)
                self._update(grads)
                loss_sum += float(loss)
                tok += int(ms[s].sum())
                n_done += 1
                coll.append(self.axis.seconds - before)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            wall = time.perf_counter() - t0
        self.total_wallclock += wall
        train_loss = loss_sum / max(n_done, 1)
        with tr.span("validate"):
            val_loss, acc = self.validate()
        with tr.span("record"):
            tps = tok / wall if wall > 0 else 0.0
            self.logger.info(
                f"Epoch {epoch}: sp={cfg.seq_parallel} T={cfg.bptt} train_loss {train_loss:.4f}, "
                f"val_loss {val_loss:.4f}, {tps:,.0f} tok/s, wall {wall:.3f}s "
                f"(collectives {sum(coll):.3f}s over {n_done} steps)"
            )
            self.recorder.meta.setdefault("paths", []).append(f"seq_parallel_{cfg.seq_parallel}")
            self.recorder.meta.setdefault("collective", []).append({
                "epoch": int(epoch), "steps": n_done, "total_s": float(sum(coll)),
                "mean_s": float(sum(coll)) / max(n_done, 1), "max_s": max(coll, default=0.0),
            })
            self.recorder.record_epoch(
                epoch=epoch,
                train_loss=train_loss,
                train_time=wall,
                sync_time=0.0,
                val_loss=val_loss,
                accuracy=acc,
                partition=[1.0 / self.n_dev] * self.n_dev,
                node_time=[wall] * self.n_dev,
                wallclock_time=self.total_wallclock,
                tokens_per_s=tps,
            )
        return {"epoch_wall": wall, "loss": train_loss, "val_loss": val_loss}

    @torch.no_grad()
    def validate(self) -> Tuple[float, float]:
        """Mean NLL over the validation stream's full windows (eval batch
        10), each rank's block summed by K2 and the sums added over the
        ranks; "accuracy" is ``1 - val_loss`` (dbs.py:180-181)."""
        xs, ys, ms = self._windows(self.val_data)
        full = [s for s in range(xs.shape[0]) if ms[s].all()]
        sums = torch.zeros(len(full), dtype=torch.float32, device=self.device)
        for i, s in enumerate(full):
            logits = seq_parallel_apply(self.model, self._local(xs[s]))
            sums[i] = softmax_xent(logits.float(), self._local(ys[s])).sum()
        self.axis.all_reduce_(sums)
        tot = float(sum(float(v) for v in sums.cpu()))
        cnt = float(sum(ys[s].size for s in full))
        val = tot / max(cnt, 1.0)
        return val, 1.0 - val

    def run(self, epochs: Optional[int] = None) -> MetricsRecorder:
        n = epochs if epochs is not None else self.cfg.epoch_size
        for e in range(n):
            self.run_epoch(e)
        self.logger.info(f"Total wallclock: {self.total_wallclock:.3f}s")
        if self.proc_id == 0:
            self.recorder.save(self.cfg.stat_dir, self.cfg.base_filename())
        if self._trace.enabled:
            path = os.path.join(self.cfg.trace_dir,
                                self.cfg.base_filename().format(self.proc_id) + ".trace.json")
            self._trace.save(path)
            self.logger.info(f"graftscope trace saved: {path}")
        return self.recorder

    def rank_report(self) -> Dict[str, object]:
        """This rank at the end of a run, in the keys of ``Trainer.rank_report``."""
        return {
            **rank_report_base(self.model, self.proc_id, self.mesh, self.device, self.recorder,
                               RANK_SERIES + ("tokens_per_s",)),
            "workers": [self.proc_id], "combine": None, "grad_comm": "flat",
            "grad_comm_wires": [], "link_bandwidth": None,
        }
