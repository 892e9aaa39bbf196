"""Sequence parallelism: the Transformer LM on a sequence sharded over the
ranks (the JAX package's ``parallel/seq_parallel.py``).

Each rank holds one block ``[B, T/n]`` of the tokens (the block of its rank,
in rank order), embeds it at its offset positions and runs attention over
the whole sequence (``RingSelfAttention`` or ``UlyssesSelfAttention``,
``models/transformer.py``, built with ``seq_axis``). The model's parameters
are the one-device model's, so one state dict serves both.

The loss is the all-reduced ``[sum, count]`` ratio of the per-token
cross-entropy (K2, ``ops/kernels/xent.py``). Its gradient: each rank runs
the backward of its own sum over the global count, the collectives' own
backwards carry the cotangents of the blocks that travelled, and the
parameter gradients are then summed over the ranks (one all-reduce of one
flat buffer). That is what the transpose of the JAX ``shard_map`` does for
replicated parameters; as there, the gradient is not taken inside one
rank's program alone, which would miss what travelled through the
collectives.

With ``train=True`` the model's dropout draws from a generator seeded by
``fold_in(key, rank)`` (``parallel/prng.py``), so each rank draws its own
stream and each token, resident on one rank, is dropped there only.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import Key, fold_in, key_data


def key_seed(key: Key) -> int:
    """A generator seed from a key's two words."""
    k0, k1 = key_data(key)
    return (k0 << 32) | k1


def seed_dropout(model: torch.nn.Module, generator: torch.Generator, key: Key, rank: int) -> None:
    """Point every dropout of ``model`` at ``generator``, seeded by
    ``fold_in(key, rank)``: this rank's stream of the step."""
    generator.manual_seed(key_seed(fold_in(key, rank)))
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator


@torch.no_grad()
def seq_parallel_apply(model: torch.nn.Module, tokens: torch.Tensor) -> torch.Tensor:
    """This rank's logits ``[B, T/n, V]`` for its token block (the JAX
    ``make_seq_parallel_apply``, ``train=False``)."""
    was = model.training
    model.eval()
    try:
        return model(tokens)
    finally:
        model.train(was)


def seq_parallel_value_and_grad(model: torch.nn.Module, tokens: torch.Tensor,
                                targets: torch.Tensor, axis, train: bool = False,
                                key: Optional[Key] = None,
                                generator: Optional[torch.Generator] = None
                                ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """``(mean_xent, grads)`` over the whole sharded sequence (the JAX
    ``make_seq_parallel_value_and_grad``): ``tokens``, ``targets`` this
    rank's blocks ``[B, T/n]``; the loss the all-reduced sum over the
    all-reduced count, the same on every rank, and the gradients (in
    ``model.parameters()`` order) summed over the ranks. ``train=True``
    turns on dropout, seeded from ``key`` (default ``PRNGKey(0)``) folded
    with the rank into ``generator``."""
    params = list(model.parameters())
    was = model.training
    model.train(train)
    if train:
        if generator is None:
            generator = torch.Generator(device=tokens.device)
        seed_dropout(model, generator, (0, 0) if key is None else key, axis.rank)
    try:
        logits = model(tokens)
        local_sum = softmax_xent(logits.float(), targets).sum()
        total = torch.stack([local_sum.detach(),
                             torch.tensor(float(targets.numel()), device=local_sum.device)])
        axis.all_reduce_(total)
        grads = list(torch.autograd.grad(local_sum / total[1], params))
    finally:
        model.train(was)
    flat = torch.cat([g.reshape(-1) for g in grads])
    axis.all_reduce_(flat)
    out, off = [], 0
    for p in params:
        out.append(flat[off:off + p.numel()].view(p.shape))
        off += p.numel()
    return total[0] / total[1], out
