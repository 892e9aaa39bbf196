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

A batch is ``(x, y, w)``: images ``[b, H, W, C]`` with labels and weights
``[b]``, or token windows ``[cols, bptt]`` with next-token labels and
per-token weights ``[cols, bptt]`` (the language model). Either way the
loss is ``sum(losses * w)`` and the reported loss sum counts the entries
with ``w > 0`` only, as the JAX ``local_grads`` does.

With ``grad_clip > 0`` (the language model: 0.25) each worker's gradient is
clipped on its own before the sum over workers, as the JAX ``local_grads``
does it: the worker's gradient is ``w_r * g_r`` with ``w_r = sum(w)``, so it
is unscaled by ``w_r``, its global norm clipped to ``grad_clip``, and
rescaled. That needs each worker's gradient apart from the others', so this
path takes it with ``torch.autograd.grad`` and adds it into ``.grad``; with
``grad_clip == 0`` the step accumulates through ``backward()`` as before.

The probe twins time a worker's forward/backward (``probe_grads``: returns
gradients, clipped as in training, without touching ``.grad``) and the
combine + update (``combine_probe``: computes the updated parameters without
writing them), so probing never changes the training state.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x, y, w)


def weighted_loss(model: torch.nn.Module, x, y, w) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum(losses * w), sum(losses * (w > 0)))`` for one worker's batch."""
    losses = softmax_xent(model(x).float(), y)
    return torch.sum(losses * w), torch.sum(losses.detach() * (w > 0))


def clip_worker_grads(grads: Sequence[torch.Tensor], w: torch.Tensor, grad_clip: float):
    """The JAX ``local_grads`` clip, in place: unscale the worker's gradient
    by ``max(sum(w), 1e-12)``, take its global norm, and scale the gradient
    by ``min(1, grad_clip / max(norm, 1e-12))``. Stays on the device."""
    w_r = torch.clamp_min(torch.sum(w), 1e-12)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(torch._foreach_div(grads, w_r))))
    torch._foreach_mul_(grads, torch.clamp(grad_clip / torch.clamp_min(norm, 1e-12), max=1.0))
    return grads


def worker_grads(model, params: List[torch.Tensor], batch: Batch, grad_clip: float):
    """One worker's (clipped) weighted gradient and its loss sum; ``.grad``
    untouched."""
    wloss, loss_sum = weighted_loss(model, *batch)
    grads = list(torch.autograd.grad(wloss, params))
    if grad_clip > 0:
        clip_worker_grads(grads, batch[2], grad_clip)
    return grads, loss_sum


def elastic_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batches: Sequence[Optional[Batch]],
    grad_clip: float = 0.0,
) -> Optional[torch.Tensor]:
    """One DBS step over every worker's batch (``None`` for a worker with no
    real data this step). Returns the sum of the losses of the entries with
    positive weight, or None if no worker had data."""
    optimizer.zero_grad(set_to_none=True)
    params = [p for g in optimizer.param_groups for p in g["params"]]
    loss_sum, total = None, None
    for b in batches:
        if b is None:
            continue
        if grad_clip > 0:
            grads, s = worker_grads(model, params, b, grad_clip)
            if total is None:
                total = grads
            else:
                torch._foreach_add_(total, grads)
        else:
            wloss, s = weighted_loss(model, *b)
            wloss.backward()  # adds this worker's weighted gradient into .grad
        loss_sum = s if loss_sum is None else loss_sum + s
    if total is not None:
        for p, g in zip(params, total):
            p.grad = g
    optimizer.step()
    return loss_sum


def probe_grads(
    model: torch.nn.Module, params: List[torch.Tensor], batch: Batch, grad_clip: float = 0.0
):
    """One worker's forward/backward (and clip), gradients returned,
    ``.grad`` untouched."""
    return worker_grads(model, params, batch, grad_clip)[0]


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
