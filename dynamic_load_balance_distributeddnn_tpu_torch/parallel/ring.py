"""Ring attention: the sequence sharded over the ranks (the JAX package's
``parallel/ring.py``).

Each rank holds one contiguous block of the sequence, ``[B, H, T/n, D]``
of queries, keys and values. The key/value blocks travel around the ring of
ranks: at hop ``i`` a rank attends to the block of rank ``(my - i) % n``
with the streaming-softmax update (a running max, sum and output, as flash
attention keeps them), then passes its block on to rank ``my + 1``. No rank
ever holds the whole ``[T, T]`` score matrix. The JAX package's ``n`` hops
and its causal mask (query position ``my * t + i`` sees key position ``src
* t + j`` when ``>=``) are kept. The ring shifts ``n - 1`` times: the JAX
loop's ``n``-th ``ppermute`` feeds a carry that is discarded, so XLA drops
it as dead code, and so does this port.

The shift is :class:`RingShift`, an autograd function over the rank group
(``parallel/mesh.py`` ``permute``: ``batch_isend_irecv`` to the next rank,
staged through pinned host memory when ranks share a card). Its backward is
the reverse shift, the transpose of ``ppermute``. Keys and values travel as
one stacked tensor, one message a hop. Every rank runs the same graph, so
the backward's shifts meet in the same order on every rank.

The block update stays plain PyTorch: the JAX package's is ``einsum`` too,
no Pallas kernel.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class RingShift(torch.autograd.Function):
    """``x`` of rank ``my - shift`` on rank ``my`` (``axis.permute``); the
    backward sends each gradient back by ``-shift``."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, axis, shift: int) -> torch.Tensor:
        ctx.axis, ctx.shift = axis, shift
        return axis.permute(x, shift)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.axis.permute(g.contiguous(), -ctx.shift), None, None


def _block_attn_update(q, k, v, m, l, o, score_mask: Optional[torch.Tensor]):
    """One streaming-softmax update with the current key/value block (the
    JAX ``_block_attn_update``): ``q [B, H, Tq, D]``, ``k, v [B, H, Tk, D]``,
    ``m, l [B, H, Tq]``, ``o [B, H, Tq, D]``; ``score_mask [Tq, Tk]``
    additive (``-inf`` where masked) or None. Rows masked so far (``m`` at
    ``-inf``) and fully masked rows give no NaN."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if score_mask is not None:
        s = s + score_mask[None, None]
    m_new = torch.maximum(m, s.amax(dim=-1))
    m_safe = torch.where(torch.isfinite(m_new), m_new, torch.zeros_like(m_new))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    finite = torch.isfinite(m)
    corr = torch.exp(torch.where(finite, m - m_safe, torch.full_like(m, -math.inf)))
    corr = torch.where(finite, corr, torch.zeros_like(corr))
    l_new = l * corr + p.sum(dim=-1)
    o_new = o * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, v)
    return m_new, l_new, o_new


def _causal_mask(my: int, src: int, t: int, like: torch.Tensor) -> torch.Tensor:
    """``[t, t]``: 0 where query ``my * t + i`` sees key ``src * t + j``,
    ``-inf`` elsewhere."""
    q_pos = my * t + torch.arange(t, device=like.device)
    k_pos = src * t + torch.arange(t, device=like.device)
    zero = torch.zeros((), dtype=like.dtype, device=like.device)
    return torch.where(q_pos[:, None] >= k_pos[None, :], zero, torch.full_like(zero, -math.inf))


def ring_self_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, axis,
                        causal: bool = False) -> torch.Tensor:
    """Attention over a sequence sharded on ``axis`` (``parallel/mesh.py``:
    ``size`` ranks, this one ``rank``): ``q, k, v`` this rank's blocks
    ``[B, H, T/n, D]``; returns this rank's output block."""
    n, my = axis.size, axis.rank
    t_local = q.shape[2]
    m = torch.full(q.shape[:3], -math.inf, dtype=q.dtype, device=q.device)
    l = torch.zeros(q.shape[:3], dtype=q.dtype, device=q.device)
    o = torch.zeros_like(q)
    kv = torch.stack([k, v])
    for i in range(n):  # the JAX package's n hops
        src = (my - i) % n  # whose keys this rank holds now
        mask = _causal_mask(my, src, t_local, q) if causal else None
        m, l, o = _block_attn_update(q, kv[0], kv[1], m, l, o, mask)
        if i < n - 1:  # nothing reads the last hop's shift
            kv = RingShift.apply(kv, axis, 1)
    return o / torch.clamp_min(l, 1e-20)[..., None]


def reference_attention(q, k, v, causal: bool = False) -> torch.Tensor:
    """Plain full attention (the JAX ``reference_attention``)."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * scale
    if causal:
        t = q.shape[2]
        pos = torch.arange(t, device=q.device)
        zero = torch.zeros((), dtype=s.dtype, device=s.device)
        s = s + torch.where(pos[:, None] >= pos[None, :], zero, torch.full_like(zero, -math.inf))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, dim=-1), v)
