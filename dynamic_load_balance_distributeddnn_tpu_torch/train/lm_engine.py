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
columns for static shapes; the elastic path here runs each worker at its
true column count, which changes no sum. The fused paths (``-dbs false``,
``--fused_dbs``, with ``--grad_accum``, ``--compress_grads int8``,
``--shard_update`` and ``--grad_comm hier``: one worker a device, as in the
JAX package) take the JAX layout, ``_fused_epoch``: every step at the
worker's bucketed width, or the fused-DBS capacity ``_cap_b``, the padded
columns at weight 0, so ``--grad_accum`` splits the same columns as the JAX
package's micro-batches. Across ranks each rank builds only its own
workers' windows, and validation is split by chunks over the ranks
(``validate``).

Under ``--superstep auto`` (the default) the LM's elastic steps run as
replays of captured step graphs (``train/supersteps.py``), each key one
plan's column widths. Its dropout (and flash attention's absence of it, or
the plain attention's probability dropout) draws from the trainer's CUDA
generator (``dropout_gen``), which the executor registers with every graph,
so a replay draws the masks the eager step draws from the same state.
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
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import MAX_LOGITS, softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import allgather_host
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import _EVAL_CHUNK, Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer

EVAL_BSZ = 10  # dataloader.py:109


def eval_rows(bptt: int, ntoken: int) -> int:
    """Rows (windows of ``bptt`` tokens) in a validation chunk: the vision
    path's 1,024, or fewer where their ``[rows * bptt, ntoken]`` logits
    would pass what one K2 call takes (``MAX_LOGITS``; 457 rows at bptt 256
    and the committed files' 18,328 words). The loss is a token-weighted
    sum: the chunking changes only the order of its f32 additions."""
    return max(1, min(_EVAL_CHUNK, MAX_LOGITS // (bptt * ntoken)))


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
        # the token stream folds into windows on the host: nothing to cache
        # (``on`` warns, as in the JAX package); the windows stay on the
        # device under ``off`` (_feeds_from_host logs it)
        self._use_device_cache = self._decide_device_cache()
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

    def _plan_from(self, epoch: int, batch_sizes: np.ndarray, shares: np.ndarray) -> EpochPlan:
        """Contiguous stream slices; a worker's "batch size" is its column
        count, and its steps are the bptt windows of its folded slice."""
        cfg = self.cfg
        shares = np.asarray(shares, dtype=np.float64)
        parts = partition_indices(self.n_train, shares, shuffle=False)
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
            shares=shares.copy(),
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

    def _steps_to_device(self, a: np.ndarray) -> torch.Tensor:
        """``[steps, cols, bptt]`` on the device with every step's block
        starting on a 16-byte boundary (each padded to a multiple of 4
        elements): a reduction over one step's weights then takes the same
        vectorized path whatever the column count, as it does on the static
        slots of a captured step (``train/supersteps.py``), so the eager and
        graphed steps sum in the same order."""
        steps, n = a.shape[0], int(np.prod(a.shape[1:]))
        buf = np.zeros((steps, -(-n // 4) * 4), dtype=a.dtype)
        buf[:, :n] = a.reshape(steps, n)
        return torch.from_numpy(buf).to(self.device)[:, :n].view(a.shape)

    def _step_rows(self, plan: EpochPlan, rank: int):
        """Worker ``rank``'s columns a step (0 where its window holds no
        token: no batch), from the windows ``_worker_epoch`` builds."""
        _, _, w = self._build_windows(plan, rank)
        counts = (w > 0).reshape(plan.num_steps, -1).sum(axis=1)
        return [int(w.shape[1]) if c else 0 for c in counts]

    def _worker_epoch(self, plan: EpochPlan, rank: int):
        x, y, w = self._build_windows(plan, rank)
        counts = (w > 0).reshape(plan.num_steps, -1).sum(axis=1).tolist()
        x, y, w = (self._steps_to_device(a) for a in (x, y, w))

        def step(s: int):
            if counts[s] == 0:
                return None, 0  # fully masked window: weight 0, skipped
            return (x[s], y[s], w[s]), counts[s]

        return step

    def _fused_epoch(self, plan: EpochPlan, rank: int, dbs_probe: bool):
        """The fused paths' windows of worker ``rank`` (the JAX
        ``_worker_inputs(pad_to=...)``): every step at its bucketed width,
        or the capacity ``_cap_b`` under ``dbs_probe``, the padded columns
        at weight 0; ``(width, batch, counts)`` as the vision trainer's,
        ``counts`` the real tokens a step."""
        width = self._cap_b if dbs_probe else plan.workers[rank].padded_batch
        x, y, w = self._build_windows(plan, rank, pad_to=width)
        counts = (w > 0).reshape(plan.num_steps, -1).sum(axis=1).tolist()
        x, y, w = (self._steps_to_device(a) for a in (x, y, w))
        return x.shape[1], lambda s: (x[s], y[s], w[s]), counts

    def _dummy_batch(self, b: int):
        """A readmission probe's batch: the stream's first ``b`` columns of
        one bptt window, every token weighted ``1 / tokens``."""
        bptt = self.cfg.bptt
        x, y, m = bptt_windows(batchify(self.train_stream[: b * (bptt + 1)], b), bptt)
        w = m[0] / max(float(m[0].sum()), 1.0)
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                     for a in (x[0], y[0], w))

    # ------------------------------------------------------------- validate

    @torch.no_grad()
    def validate(self) -> Tuple[float, float]:
        """Token-weighted NLL over the test windows, in chunks of rows;
        "accuracy" is ``1 - val_loss``. Across ranks rank p evaluates the
        chunks p, p + n, ... (the JAX ``_eval_sharded``); the chunks' sums
        are gathered and added in chunk order in f32, as one process adds
        them on the device, so the loss is the one-process value."""
        self.model.eval()
        rows = eval_rows(self.cfg.bptt, self.corpus.ntokens)
        starts = list(range(0, len(self.eval_x), rows))
        sums = torch.zeros(len(starts), device=self.device)
        for i in range(self.proc_id, len(starts), self.n_proc):
            sl = slice(starts[i], starts[i] + rows)
            losses = softmax_xent(self.model(self.eval_x[sl]).float(), self.eval_y[sl])
            sums[i] = torch.sum(losses * self.eval_m[sl])
        self.model.train()
        if self.n_proc > 1:
            got = allgather_host(sums.to("cpu", torch.float64).numpy())
            chunk = got.reshape(self.n_proc, -1).sum(axis=0).astype(np.float32)
        else:
            chunk = sums.cpu().numpy()
        loss_sum = np.float32(0.0)
        for v in chunk:
            loss_sum = np.float32(loss_sum + v)
        val_loss = float(loss_sum) / max(float(self.eval_m.sum()), 1.0)
        return val_loss, 1.0 - val_loss
