"""Transformer language model — the JAX package's ``models/transformer.py``.

Sinusoidal positions, a post-LN encoder stack with causal self-attention
and a vocabulary-sized output layer, tied to the reference's hyperparameters
at the call site (``train/lm_engine.py``). Layout is batch-major: tokens
``[B, T]`` -> logits ``[B, T, V]``, as in the JAX package.

Submodules keep flax's auto-names (``Embed_0``, ``EncoderLayer_k`` with
``attn.{query,key,value,out}``, ``LayerNorm_0/1``, ``Dense_0/1``, and the
output ``Dense_0``) so ``bridge.py`` maps parameter paths. The attention
projections are ``nn.Linear`` over the flattened heads: flax's
``DenseGeneral`` kernels ``[in, H, hd]`` (``out``: ``[H, hd, out]``) are the
same numbers in another shape.

Attention has two branches, as in the JAX package:

- ``use_flash=True``: the K3 flash-attention kernels
  (``ops/kernels/flash_attention.py``), causal, with no dropout on the
  attention probabilities (the JAX ``FlashSelfAttention``);
- ``use_flash=False``: plain softmax attention with flax's
  ``MultiHeadDotProductAttention`` semantics — causal mask, and dropout on
  the probabilities with one mask broadcast over batch and heads.

Both keep the residual and feed-forward dropouts. LayerNorm eps is flax's
1e-6, not torch's 1e-5.

Sequence parallelism (``seq_axis``, the JAX ``seq_axis``/``sp_mode``):
tokens arrive as this rank's block ``[B, T/n]`` of a sequence sharded over
the ranks of ``seq_axis`` (``parallel/mesh.py``), attention runs over the
whole sequence through ``RingSelfAttention`` (``parallel/ring.py``) or
``UlyssesSelfAttention`` (``parallel/ulysses.py``, its local attention
plain, as the JAX model calls it), neither with dropout on the
probabilities, and the positions are offset by ``rank * T/n`` in a table
of ``min(max_len, n * T/n)`` rows. The attention variants keep the
``query``/``key``/``value``/``out`` names, so one state dict serves every
mode.

Mixed dtypes, as flax has them under the JAX package's bf16 compute dtype
(parameters cast to bf16, tokens left integers): the embedding gathers in
bf16 and ``x * sqrt(ninp)`` multiplies in bf16 by the factor rounded to bf16
(14.125 for ``ninp = 200``); adding the f32 positional table promotes to f32,
and from there every projection, LayerNorm and the decoder lift their bf16
weights to the activation's dtype (flax's ``promote_dtype``), so attention
(K3) and the logits are f32: an f32 computation on bf16-rounded weights.
"""

from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout, keep_mask
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
)
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ring import ring_self_attention
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ulysses import ulysses_self_attention

LN_EPS = 1e-6  # flax nn.LayerNorm's default


def _lifted(x: torch.Tensor, *ts: Optional[torch.Tensor]):
    """``ts`` in ``promote_types(x.dtype, t.dtype)``, as flax's
    ``promote_dtype`` lifts a layer's parameters to its input's dtype
    (no-ops when the dtypes agree)."""
    return [None if t is None else t.to(torch.promote_types(x.dtype, t.dtype)) for t in ts]


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias are lifted to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x, *_lifted(x, self.weight, self.bias))


class LayerNorm(nn.LayerNorm):
    """``nn.LayerNorm`` whose scale and bias are lifted to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x, self.normalized_shape, *_lifted(x, self.weight, self.bias), self.eps)


@functools.lru_cache(maxsize=None)
def embed_scale(ninp: int, dtype: torch.dtype) -> float:
    """``sqrt(ninp)`` rounded to ``dtype``: flax multiplies a bf16 embedding
    by the f32 constant in bf16, which rounds the constant first."""
    return torch.tensor(math.sqrt(float(ninp)), dtype=dtype).item()


def sinusoidal_positions(max_len: int, d_model: int) -> np.ndarray:
    pos = np.arange(max_len, dtype=np.float32)[:, None]
    div = np.exp(np.arange(0, d_model, 2, dtype=np.float32) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(pos * div)
    pe[:, 1::2] = np.cos(pos * div)
    return pe


class SelfAttention(nn.Module):
    """Causal multi-head self-attention, ``[B, T, E]`` -> ``[B, T, E]``."""

    def __init__(self, d_model: int, nhead: int, dropout: float, use_flash: bool):
        super().__init__()
        self.nhead = nhead
        self.use_flash = use_flash
        self.query = Linear(d_model, d_model)
        self.key = Linear(d_model, d_model)
        self.value = Linear(d_model, d_model)
        self.out = Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        heads = [
            proj(x).view(b, t, self.nhead, e // self.nhead).transpose(1, 2)
            for proj in (self.query, self.key, self.value)
        ]  # [B, H, T, hd] each
        o = self._attend(*heads)
        return self.out(o.transpose(1, 2).reshape(b, t, e))

    def _attend(self, q, k, v) -> torch.Tensor:
        if self.use_flash:
            return flash_attention(q, k, v, causal=True)
        return self._plain(q, k, v)

    def _plain(self, q, k, v) -> torch.Tensor:
        t = q.shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", q / math.sqrt(q.shape[-1]), k)
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1)
        if self.attn_dropout.training and self.attn_dropout.p > 0.0:
            # flax's broadcast_dropout: one [T, T] mask for every batch row
            # and head
            keep = keep_mask((1, 1, t, t), self.attn_dropout.p, self.attn_dropout.generator,
                             p.device)
            p = p * keep.to(p.dtype) / (1.0 - self.attn_dropout.p)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)


class RingSelfAttention(SelfAttention):
    """Causal self-attention over a sequence sharded on ``axis``: this
    rank's block attends to the whole sequence through the ring
    (``parallel/ring.py``); no dropout on the probabilities."""

    def __init__(self, d_model: int, nhead: int, axis):
        super().__init__(d_model, nhead, 0.0, False)
        self.axis = axis

    def _attend(self, q, k, v) -> torch.Tensor:
        return ring_self_attention(q, k, v, self.axis, causal=True)


class UlyssesSelfAttention(SelfAttention):
    """Causal self-attention over a sequence sharded on ``axis`` through the
    head all-to-all (``parallel/ulysses.py``), its local attention plain as
    the JAX model calls it; no dropout on the probabilities."""

    def __init__(self, d_model: int, nhead: int, axis):
        super().__init__(d_model, nhead, 0.0, False)
        self.axis = axis

    def _attend(self, q, k, v) -> torch.Tensor:
        return ulysses_self_attention(q, k, v, self.axis, causal=True)


def _attention(d_model: int, nhead: int, dropout: float, use_flash: bool, seq_axis,
               sp_mode: str) -> SelfAttention:
    """The JAX ``EncoderLayer``'s choice: Ulysses or the ring over
    ``seq_axis`` when one is given, else flash or plain attention."""
    if seq_axis is not None:
        cls = UlyssesSelfAttention if sp_mode == "ulysses" else RingSelfAttention
        return cls(d_model, nhead, seq_axis)
    return SelfAttention(d_model, nhead, dropout, use_flash)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (torch's convention, as the reference uses)."""

    def __init__(self, d_model: int, nhead: int, d_ff: int, dropout: float, use_flash: bool,
                 seq_axis=None, sp_mode: str = "ring"):
        super().__init__()
        self.attn = _attention(d_model, nhead, dropout, use_flash, seq_axis, sp_mode)
        self.Dropout_0 = Dropout(dropout)
        self.LayerNorm_0 = LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = Linear(d_model, d_ff)
        self.Dropout_1 = Dropout(dropout)
        self.Dense_1 = Linear(d_ff, d_model)
        self.Dropout_2 = Dropout(dropout)
        self.LayerNorm_1 = LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.LayerNorm_0(x + self.Dropout_0(self.attn(x)))
        ff = self.Dropout_1(torch.relu(self.Dense_0(x)))
        ff = self.Dropout_2(self.Dense_1(ff))
        return self.LayerNorm_1(x + ff)


class TransformerLM(nn.Module):
    """tokens ``[B, T]`` int -> logits ``[B, T, ntoken]`` f32; with
    ``seq_axis``, this rank's block of tokens -> its block of logits (the
    module docstring)."""

    def __init__(
        self,
        ntoken: int = 2000,
        ninp: int = 200,
        nhead: int = 2,
        nhid: int = 200,
        nlayers: int = 2,
        dropout: float = 0.2,
        max_len: int = 5000,
        use_flash: bool = False,
        seq_axis=None,
        sp_mode: str = "ring",
    ):
        super().__init__()
        if ninp % nhead:
            raise ValueError(f"model width {ninp} not divisible by {nhead} heads")
        self.ninp = ninp
        self.nlayers = nlayers
        self.max_len = max_len
        self.seq_axis = seq_axis
        self.Embed_0 = nn.Embedding(ntoken, ninp)
        self.Dropout_0 = Dropout(dropout)
        for i in range(nlayers):
            setattr(self, f"EncoderLayer_{i}",
                    EncoderLayer(ninp, nhead, nhid, dropout, use_flash, seq_axis, sp_mode))
        self.Dense_0 = Linear(ninp, ntoken)
        self._pe: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def _positions(self, t: int, device: torch.device) -> torch.Tensor:
        """The ``t`` rows of the sinusoidal table this block's tokens take,
        cached per device: the first ``t``, or under ``seq_axis`` those from
        ``rank * t`` in a table of ``min(max_len, n * t)`` rows (the start
        clamped into the table, as the JAX ``dynamic_slice`` clamps it)."""
        key = (t, device)
        if key not in self._pe:
            n, rank = (1, 0) if self.seq_axis is None else (self.seq_axis.size, self.seq_axis.rank)
            rows = min(self.max_len, max(n * t, 1))
            off = max(min(rank * t, rows - t), 0)
            pe = sinusoidal_positions(rows, self.ninp)
            self._pe[key] = torch.from_numpy(pe[off:off + t]).to(device)
        return self._pe[key]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        x = self.Embed_0(tokens.long())
        x = x * embed_scale(self.ninp, x.dtype)
        x = self.Dropout_0(x + self._positions(t, x.device)[None])  # f32 from here
        for i in range(self.nlayers):
            x = getattr(self, f"EncoderLayer_{i}")(x)
        return self.Dense_0(x)
