"""Ulysses sequence parallelism: attention-head all-to-all (the JAX
package's ``parallel/ulysses.py``).

Tokens arrive sequence-sharded, ``[B, H, T/n, D]`` on each of ``n`` ranks.
One all-to-all re-shards them head-sharded, ``[B, H/n, T, D]``: every rank
then holds the whole sequence for its ``H/n`` heads and runs full attention
on it locally (so the port's K3 flash-attention kernels apply directly,
``use_flash``), and the inverse all-to-all restores the sequence sharding.
Two all-to-alls an attention against the ring's ``n`` hops; the head count
must divide by ``n``.

The all-to-all is :class:`HeadAllToAll`, an autograd function over the rank
group (``parallel/mesh.py`` ``all_to_all``, staged through pinned host
memory when ranks share a card); its backward is the inverse all-to-all.
"""

from __future__ import annotations

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ring import reference_attention


def _to_heads(x: torch.Tensor, axis) -> torch.Tensor:
    """``[B, H, T/n, D]`` -> ``[B, H/n, T, D]``: head block ``j`` to rank
    ``j``, the sequence blocks concatenated in rank order (the JAX
    ``all_to_all(split_axis=1, concat_axis=2, tiled=True)``)."""
    n = axis.size
    b, h, t, d = x.shape
    blocks = x.reshape(b, n, h // n, t, d).transpose(0, 1)  # [n, B, H/n, T/n, D]
    got = axis.all_to_all(blocks)  # [n (sequence block), B, H/n, T/n, D]
    return got.permute(1, 2, 0, 3, 4).reshape(b, h // n, n * t, d)


def _to_sequence(x: torch.Tensor, axis) -> torch.Tensor:
    """``[B, H/n, T, D]`` -> ``[B, H, T/n, D]``: the inverse of
    :func:`_to_heads` (the JAX ``all_to_all(split_axis=2, concat_axis=1,
    tiled=True)``)."""
    n = axis.size
    b, hn, t, d = x.shape
    blocks = x.reshape(b, hn, n, t // n, d).permute(2, 0, 1, 3, 4)  # [n, B, H/n, T/n, D]
    got = axis.all_to_all(blocks)  # [n (head block), B, H/n, T/n, D]
    return got.transpose(0, 1).reshape(b, n * hn, t // n, d)


class HeadAllToAll(torch.autograd.Function):
    """Sequence-sharded to head-sharded (``to_heads``) or back; the backward
    is the other direction."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis, to_heads: bool) -> torch.Tensor:
        ctx.axis, ctx.to_heads = axis, to_heads
        return (_to_heads if to_heads else _to_sequence)(x, axis)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return (_to_sequence if ctx.to_heads else _to_heads)(g, ctx.axis), None, None


def ulysses_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                           causal: bool = True, use_flash: bool = False) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` through the head
    all-to-all: ``q, k, v`` this rank's blocks ``[B, H, T/n, D]``, ``H``
    divisible by ``n``; returns this rank's output block. ``use_flash``
    runs the local full attention on K3 (``ops/kernels/flash_attention.py``),
    else ``reference_attention``."""
    n = axis.size
    if q.shape[1] % n:
        raise ValueError(f"num_heads {q.shape[1]} must divide by axis size {n}")
    qg, kg, vg = (HeadAllToAll.apply(x, axis, True) for x in (q, k, v))
    if use_flash:
        from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.flash_attention import (
            flash_attention,
        )

        og = flash_attention(qg, kg, vg, causal=causal)
    else:
        og = reference_attention(qg, kg, vg, causal=causal)
    return HeadAllToAll.apply(og, axis, False)
