"""The elastic DBS step (the JAX package's ``train/steps.py`` elastic path).

For each step, every logical worker runs forward and backward on its own
batch with loss ``sum(losses * w)``, ``w`` from ``ops/losses.py
example_weights``. The gradients accumulate in ``.grad``: that running sum
is the JAX ``combine_update``'s sum over workers. Then one
``optimizer.step()`` applies SGD-momentum. All workers of a step see the
same parameters, as in the JAX package.

The JAX package pads every batch to a bucket multiple with weight-0 rows and
runs all-padding steps for workers with fewer steps, because XLA needs
static shapes. Eager PyTorch does not: this step runs each batch at its true
width and skips a worker's empty steps. Weight-0 rows add nothing to the
loss or the gradient, so the math is the same.

The probe twins time a worker's forward/backward (``probe_grads``: returns
gradients without touching ``.grad``) and the combine + update
(``combine_probe``: computes the updated parameters without writing them),
so probing never changes the training state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x NHWC float, y, w)


def weighted_loss(model: torch.nn.Module, x, y, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum(losses * w), losses)`` for one worker's batch."""
    losses = softmax_xent(model(x).float(), y)
    return torch.sum(losses * w), losses


def elastic_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batches: Sequence[Optional[Batch]],
) -> Optional[torch.Tensor]:
    """One DBS step over every worker's batch (``None`` for a worker with no
    real rows this step). Returns the sum of the per-example losses, or None
    if no worker had data."""
    optimizer.zero_grad(set_to_none=True)
    loss_sum = None
    for b in batches:
        if b is None:
            continue
        wloss, losses = weighted_loss(model, *b)
        wloss.backward()  # adds this worker's weighted gradient into .grad
        s = losses.detach().sum()
        loss_sum = s if loss_sum is None else loss_sum + s
    optimizer.step()
    return loss_sum


def probe_grads(model: torch.nn.Module, params: List[torch.Tensor], batch: Batch):
    """One worker's forward/backward, gradients returned, ``.grad`` untouched."""
    wloss, _ = weighted_loss(model, *batch)
    return torch.autograd.grad(wloss, params)


@torch.no_grad()
def combine_probe(optimizer: torch.optim.SGD, worker_grads: Sequence[Sequence[torch.Tensor]]):
    """The combine (sum over workers) and the SGD-momentum update, computed
    into new tensors: the parameters and momentum buffers are not written."""
    group = optimizer.param_groups[0]
    params, lr, mom = group["params"], group["lr"], group["momentum"]
    total = list(worker_grads[0])
    for g in worker_grads[1:]:
        total = torch._foreach_add(total, list(g))
    bufs = [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
    if any(b is None for b in bufs):
        step = total  # first step: the buffer starts as the gradient
    else:
        step = torch._foreach_add(torch._foreach_mul(bufs, mom), total)
    return torch._foreach_add(params, step, alpha=-lr)
