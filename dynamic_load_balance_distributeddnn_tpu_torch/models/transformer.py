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
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
)

LN_EPS = 1e-6  # flax nn.LayerNorm's default


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
        self.query = nn.Linear(d_model, d_model)
        self.key = nn.Linear(d_model, d_model)
        self.value = nn.Linear(d_model, d_model)
        self.out = nn.Linear(d_model, d_model)
        self.attn_dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, e = x.shape
        heads = [
            proj(x).view(b, t, self.nhead, e // self.nhead).transpose(1, 2)
            for proj in (self.query, self.key, self.value)
        ]  # [B, H, T, hd] each
        if self.use_flash:
            o = flash_attention(*heads, causal=True)
        else:
            o = self._plain(*heads)
        return self.out(o.transpose(1, 2).reshape(b, t, e))

    def _plain(self, q, k, v) -> torch.Tensor:
        t = q.shape[2]
        s = torch.einsum("bhqd,bhkd->bhqk", q / math.sqrt(q.shape[-1]), k)
        pos = torch.arange(t, device=q.device)
        s = s.masked_fill(pos[:, None] < pos[None, :], torch.finfo(s.dtype).min)
        p = torch.softmax(s, dim=-1)
        if self.attn_dropout.training and self.attn_dropout.p > 0.0:
            # flax's broadcast_dropout: one [T, T] mask for every batch row
            # and head
            keep = torch.rand(
                (1, 1, t, t), generator=self.attn_dropout.generator, device=p.device
            ) >= self.attn_dropout.p
            p = p * keep.to(p.dtype) / (1.0 - self.attn_dropout.p)
        return torch.einsum("bhqk,bhkd->bhqd", p, v)


class EncoderLayer(nn.Module):
    """Post-LN encoder layer (torch's convention, as the reference uses)."""

    def __init__(self, d_model: int, nhead: int, d_ff: int, dropout: float, use_flash: bool):
        super().__init__()
        self.attn = SelfAttention(d_model, nhead, dropout, use_flash)
        self.Dropout_0 = Dropout(dropout)
        self.LayerNorm_0 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d_model, d_ff)
        self.Dropout_1 = Dropout(dropout)
        self.Dense_1 = nn.Linear(d_ff, d_model)
        self.Dropout_2 = Dropout(dropout)
        self.LayerNorm_1 = nn.LayerNorm(d_model, eps=LN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.LayerNorm_0(x + self.Dropout_0(self.attn(x)))
        ff = self.Dropout_1(torch.relu(self.Dense_0(x)))
        ff = self.Dropout_2(self.Dense_1(ff))
        return self.LayerNorm_1(x + ff)


class TransformerLM(nn.Module):
    """tokens ``[B, T]`` int -> logits ``[B, T, ntoken]`` f32."""

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
    ):
        super().__init__()
        if ninp % nhead:
            raise ValueError(f"model width {ninp} not divisible by {nhead} heads")
        self.ninp = ninp
        self.nlayers = nlayers
        self.max_len = max_len
        self.Embed_0 = nn.Embedding(ntoken, ninp)
        self.Dropout_0 = Dropout(dropout)
        for i in range(nlayers):
            setattr(self, f"EncoderLayer_{i}", EncoderLayer(ninp, nhead, nhid, dropout, use_flash))
        self.Dense_0 = nn.Linear(ninp, ntoken)
        self._pe: Dict[Tuple[int, torch.device], torch.Tensor] = {}

    def _positions(self, t: int, device: torch.device) -> torch.Tensor:
        """The first ``t`` rows of the sinusoidal table, cached per device."""
        key = (t, device)
        if key not in self._pe:
            pe = sinusoidal_positions(min(self.max_len, max(t, 1)), self.ninp)
            self._pe[key] = torch.from_numpy(pe[:t]).to(device)
        return self._pe[key]

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        t = tokens.shape[1]
        x = self.Embed_0(tokens.long()) * math.sqrt(float(self.ninp))
        x = self.Dropout_0(x + self._positions(t, x.device)[None])
        for i in range(self.nlayers):
            x = getattr(self, f"EncoderLayer_{i}")(x)
        return self.Dense_0(x)
