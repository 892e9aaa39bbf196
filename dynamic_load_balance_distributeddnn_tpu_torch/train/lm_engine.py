"""Transformer-LM trainer — the JAX package's ``train/lm_engine.py``.

Shares the DBS controller (solver, timing, faults, recorder) with the vision
``Trainer`` and differs in the data plane, as the reference's transformer
branch does (dbs.py:253-288, 397-419; dataloader.py:100-110):

- the token *stream* is split contiguously by worker share (no shuffle) and
  each worker folds its slice into ``cols_r`` columns (``batchify``), the
  worker's "batch size" from the solver, not snapped to bucket multiples;
- steps consume bptt-token windows with next-token targets and per-token
  weights ``p_r / tokens in the window`` (over all workers they sum to 1);
- each worker's gradient is clipped to ``grad_clip`` (0.25 unless set)
  before the sum over workers (dbs.py:274);
- validation is bptt-windowed NLL over the test stream with eval batch 10,
  and "accuracy" is ``1 - val_loss`` (the reference's convention, dbs.py:
  180-181).

The plan, the windows and the weights equal the JAX package's. The JAX
package pads each worker's columns to a bucket multiple with weight-0
columns for static shapes; eager PyTorch runs each worker at its true
column count, which changes no sum.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from dynamic_load_balance_distributeddnn_tpu_torch.data import (
    Corpus,
    EpochPlan,
    WorkerPlan,
    batchify,
    bptt_windows,
    partition_indices,
)
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import init_flax_defaults
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import _EVAL_CHUNK, Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer

EVAL_BSZ = 10  # dataloader.py:109


class LMTrainer(Trainer):
    SNAP_BATCHES = False  # columns, not examples: keep the exact split

    # Reference LM hyperparameters (dbs.py:337-343)
    EMSIZE = 200
    NHEAD = 2
    NHID = 200
    NLAYERS = 2
    DROPOUT = 0.2

    def _setup_data(self, bundle: Optional[Corpus]) -> None:
        cfg = self.cfg
        self.corpus = bundle if bundle is not None else Corpus(cfg.lm_data_dir)
        for note in getattr(self.corpus, "notes", []):
            self.logger.warning(f"corpus: {note}")
        stream = self.corpus.train
        if cfg.n_train:
            stream = stream[: cfg.n_train]
        elif cfg.debug and len(stream) > 60_000:
            stream = stream[:60_000]
        self.train_stream = stream
        self.n_train = len(stream)
        self.bundle = None
        # the test windows, flattened to independent [rows, bptt] sequences
        # (each row one column's window), live on the device for every epoch
        test = self.corpus.test
        if cfg.debug and len(test) > 20_000:
            test = test[:20_000]
        x, y, m = bptt_windows(batchify(test, EVAL_BSZ), cfg.bptt)
        self.eval_x, self.eval_y, self.eval_m = (
            torch.from_numpy(a.reshape(-1, cfg.bptt)).to(self.device) for a in (x, y, m)
        )

    def _setup_model(self) -> None:
        cfg = self.cfg
        model = build_model(
            "transformer",
            ntoken=self.corpus.ntokens,
            ninp=self.EMSIZE,
            nhead=self.NHEAD,
            nhid=self.NHID,
            nlayers=self.NLAYERS,
            dropout=self.DROPOUT,
            # a knob of its own: flash attention drops the attention-prob
            # dropout, a change of training semantics, so it is not tied to
            # --use_pallas
            use_flash=cfg.use_flash_attention,
        )
        init_flax_defaults(model, torch.Generator().manual_seed(cfg.seed))
        self.model = model.to(self.device)
        self._use_seeded_dropout()
        self.params = list(self.model.parameters())
        self.optimizer = make_optimizer(self.params, cfg.learning_rate, cfg.momentum)
        self.grad_clip = cfg.grad_clip if cfg.grad_clip > 0 else 0.25  # dbs.py:274
        self.augment = False

    # ------------------------------------------------------------- planning

    def _build_plan(self, epoch: int, batch_sizes: np.ndarray) -> EpochPlan:
        """Contiguous stream slices; a worker's "batch size" is its column
        count, and its steps are the bptt windows of its folded slice."""
        cfg = self.cfg
        parts = partition_indices(self.n_train, self.shares, shuffle=False)
        workers = []
        num_steps = 0
        for rank, (token_range, cols) in enumerate(zip(parts, batch_sizes)):
            cols = int(max(cols, 1))
            nbatch = max(len(token_range) // cols, 2)
            steps = max(-(-(nbatch - 1) // cfg.bptt), 1)
            padded = -(-cols // cfg.bucket) * cfg.bucket
            workers.append(
                WorkerPlan(rank=rank, indices=token_range, batch_size=cols,
                           padded_batch=padded, steps=steps)
            )
            num_steps = max(num_steps, steps)
        return EpochPlan(
            epoch=epoch,
            shares=self.shares.copy(),
            batch_sizes=np.asarray(batch_sizes, dtype=np.int64),
            workers=tuple(workers),
            num_steps=num_steps,
            global_batch=cfg.batch_size,
        )

    def _build_windows(self, plan: EpochPlan, rank: int, pad_to: Optional[int] = None):
        """Worker ``rank``'s epoch as ``(x, y, weights)``, each
        ``[num_steps, cols, bptt]`` (``pad_to`` columns if given, as the JAX
        package pads to ``padded_batch``); steps past the worker's own are
        fully masked, weights are ``p_r`` (``1/ws`` under ``-de``) over the
        window's real token count."""
        cfg = self.cfg
        w = plan.workers[rank]
        if len(w.indices):
            slice_tokens = self.train_stream[w.indices[0] : w.indices[-1] + 1]
        else:
            slice_tokens = np.zeros(0, dtype=np.int32)
        x, y, m = bptt_windows(batchify(slice_tokens, w.batch_size), cfg.bptt, pad_bsz=pad_to)
        if x.shape[0] < plan.num_steps:
            zpad = ((0, plan.num_steps - x.shape[0]), (0, 0), (0, 0))
            x, y, m = (np.pad(a, zpad) for a in (x, y, m))
        p_r = 1.0 / cfg.world_size if cfg.disable_enhancements else float(plan.shares[rank])
        tok_counts = m.reshape(plan.num_steps, -1).sum(axis=1)
        weights = m * (p_r / np.maximum(tok_counts, 1.0)[:, None, None]).astype(np.float32)
        return x, y, weights

    def _worker_epoch(self, plan: EpochPlan, rank: int):
        x, y, w = self._build_windows(plan, rank)
        counts = (w > 0).reshape(plan.num_steps, -1).sum(axis=1).tolist()
        x, y, w = (torch.from_numpy(a).to(self.device) for a in (x, y, w))

        def step(s: int):
            if counts[s] == 0:
                return None, 0  # fully masked window: weight 0, skipped
            return (x[s], y[s], w[s]), counts[s]

        return step

    # ------------------------------------------------------------- validate

    @torch.no_grad()
    def validate(self) -> Tuple[float, float]:
        """Token-weighted NLL over the test windows, in chunks of rows, summed
        on the device; "accuracy" is ``1 - val_loss``."""
        self.model.eval()
        loss_sum = torch.zeros((), device=self.device)
        for lo in range(0, len(self.eval_x), _EVAL_CHUNK):
            sl = slice(lo, lo + _EVAL_CHUNK)
            losses = softmax_xent(self.model(self.eval_x[sl]).float(), self.eval_y[sl])
            loss_sum += torch.sum(losses * self.eval_m[sl])
        self.model.train()
        val_loss = float(loss_sum) / max(float(self.eval_m.sum()), 1.0)
        return val_loss, 1.0 - val_loss
