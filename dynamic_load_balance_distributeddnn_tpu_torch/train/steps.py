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

``packed_step`` is the single-device packed path's step (the JAX
``_train_epoch_fused(..., packed=True)``): the workers' true-width batches,
concatenated into one batch with the same per-example weights, go through
one forward and one backward, then the update. The sum over examples is the
sum over workers, so it is the elastic step's math in one launch sequence.

Compute-mode straggler injection (``--fault_mode compute``): after a
worker's backward, ``load(slow_iters, wloss)`` runs that many synthetic-load
iterations (``ops/faultload.py``) seeded off the worker's weighted loss, as
the JAX ``local_grads`` does; the packed step runs the workers' sum.

The probe twins time a worker's forward/backward (``probe_grads``: returns
gradients, clipped as in training, without touching ``.grad``) and the
combine + update (``combine_probe``: computes the updated parameters without
writing them), so probing never changes the training state.

Compute dtype (``--precision bfloat16``, the JAX ``StepLibrary``'s
``compute_dtype``): every training forward runs on ``cast_compute`` copies
of the f32 master weights, each f32 parameter cast to bf16, with the input
cast likewise (integer tokens stay as they are); ``model(x).float()`` keeps
the loss in f32. The copies enter the model through
``torch.func.functional_call``, so each gradient reaches its f32 leaf
through the cast's backward (a bf16 gradient widened to f32), as the JAX
gradient reaches it through the transpose of ``astype``; ``.grad``, the
momentum buffers and the sum over workers stay f32. The elastic step casts
once a step and shares the copies between its workers: each worker's
backward still runs through the casts on its own, so its gradient is
widened on its own and the workers are summed in f32 (``combine_update``'s
sum), never in the bf16 copies. Evaluation never casts.

Capturable form (``train/supersteps.py`` captures a whole step into a CUDA
graph): a step allocates nothing that outlives it. ``prepare_step_state``
gives every parameter a zero ``.grad`` and a zero momentum buffer once,
before the first step; each step then zeroes ``.grad`` in place, the
workers' gradients add into it (``backward()`` accumulates in place into an
existing ``.grad``; a clipped worker's gradient is added with
``_foreach_add_``), and ``optimizer.step()`` updates the parameters and
buffers in place. So the parameters, ``.grad`` and the momentum buffers
keep their addresses from step to step, and only temporaries live in a
graph's memory pool. The sums are the same as before in the same order
(``0 + g`` is ``g``), and a buffer that starts at zero takes the gradient
on the first step as torch's clone-on-first-step does (``train/state.py``).
A load's iteration count is an int, or the device int32 scalar that a
captured load reads (``ops/faultload.py``).

Remat (``--remat``, the JAX ``_apply_train``'s ``jax.checkpoint``): on a
model marked by ``set_remat`` every training forward (``forward``: the
steps, the probes) runs under ``torch.utils.checkpoint`` (non-reentrant),
so its activations are recomputed in the backward instead of kept. The
recompute runs the same kernels on the same inputs (K1's and K3's forwards
launch a second time) and takes the forward's dropout masks from a tape
(``models/common.py`` ``keep_mask``), so the gradients are the ones
without remat, bit for bit wherever the kernels are deterministic. The
shared ``cast_compute`` copies stay outside the checkpoint (each worker's
recompute reuses them); the input's cast is inside. Evaluation never goes
through ``forward``.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple, Union

import torch
from torch.utils.checkpoint import checkpoint

from dynamic_load_balance_distributeddnn_tpu_torch.models.common import mask_replay_contexts
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import softmax_xent

Batch = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]  # (x, y, w)
Load = Callable[[int, torch.Tensor], torch.Tensor]  # (iterations, seed) -> scalar


Cast = Optional[Dict[str, torch.Tensor]]  # cast_compute's copies of the parameters


def cast_compute(named: Iterable[Tuple[str, torch.Tensor]], dtype: Optional[torch.dtype]) -> Cast:
    """The JAX ``StepLibrary._cast_compute`` over ``(name, tensor)`` pairs
    (``model.named_parameters()``): each f32 tensor cast to ``dtype``, every
    other one as it is; None when ``dtype`` is None (no compute dtype: the
    model runs on its own parameters)."""
    if dtype is None:
        return None
    return {k: t.to(dtype) if t.dtype == torch.float32 else t for k, t in named}


_REMAT = "_remat_forward"  # the attribute set_remat puts on a model


def set_remat(model: torch.nn.Module, remat: bool) -> None:
    """Mark ``model`` so that ``forward`` recomputes its training forward in
    the backward (``--remat``), or unmark it."""
    setattr(model, _REMAT, bool(remat))


def _apply(model: torch.nn.Module, x, compute_dtype: Optional[torch.dtype], cast: Cast):
    if compute_dtype is None:
        return model(x)
    if x.dtype == torch.float32:
        x = x.to(compute_dtype)
    return torch.func.functional_call(model, cast, (x,))


def forward(model: torch.nn.Module, x, compute_dtype: Optional[torch.dtype] = None,
            cast: Cast = None) -> torch.Tensor:
    """The training forward: ``model(x)``, or under ``compute_dtype`` the
    model on ``cast`` (``cast_compute`` of its parameters, made here when
    not given) with an f32 input cast too; on a model marked by
    ``set_remat``, under ``torch.utils.checkpoint`` (the module docstring)."""
    if compute_dtype is not None and cast is None:
        cast = cast_compute(model.named_parameters(), compute_dtype)
    if getattr(model, _REMAT, False):
        # no default generator draws here (every mask is keep_mask's), so
        # their states need not be kept; reading them is not capture-safe
        return checkpoint(_apply, model, x, compute_dtype, cast, use_reentrant=False,
                          preserve_rng_state=False, context_fn=mask_replay_contexts)
    return _apply(model, x, compute_dtype, cast)


def weighted_loss(model: torch.nn.Module, x, y, w, compute_dtype: Optional[torch.dtype] = None,
                  cast: Cast = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(sum(losses * w), sum(losses * (w > 0)))`` for one worker's batch,
    the loss on f32 logits whatever the compute dtype."""
    losses = softmax_xent(forward(model, x, compute_dtype, cast).float(), y)
    return torch.sum(losses * w), torch.sum(losses.detach() * (w > 0))


def clip_worker_grads(grads: Sequence[torch.Tensor], w: torch.Tensor, grad_clip: float):
    """The JAX ``local_grads`` clip, in place: unscale the worker's gradient
    by ``max(sum(w), 1e-12)``, take its global norm, and scale the gradient
    by ``min(1, grad_clip / max(norm, 1e-12))``. Stays on the device."""
    w_r = torch.clamp_min(torch.sum(w), 1e-12)
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(torch._foreach_div(grads, w_r))))
    torch._foreach_mul_(grads, torch.clamp(grad_clip / torch.clamp_min(norm, 1e-12), max=1.0))
    return grads


Count = Union[int, torch.Tensor]  # iterations: an int, or a device int32 scalar


def _inject(load: Optional[Load], slow_iters: Count, wloss: torch.Tensor) -> None:
    """The load after a worker's backward: a device count always runs (its
    value is on the card); an int runs when positive."""
    if isinstance(slow_iters, torch.Tensor) or slow_iters > 0:
        load(slow_iters, wloss.detach())


def prepare_step_state(optimizer: torch.optim.Optimizer) -> List[torch.Tensor]:
    """Give every parameter a zero ``.grad`` and (with momentum) a zero
    momentum buffer where it has none, so the step's state keeps its
    addresses from the first step on; returns the parameters."""
    params = [p for g in optimizer.param_groups for p in g["params"]]
    for group in optimizer.param_groups:
        for p in group["params"]:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if group.get("momentum", 0) != 0:
                state = optimizer.state[p]
                if state.get("momentum_buffer") is None:
                    state["momentum_buffer"] = torch.zeros_like(p)
    return params


def worker_grads(model, params: List[torch.Tensor], batch: Batch, grad_clip: float,
                 load: Optional[Load] = None, slow_iters: Count = 0,
                 compute_dtype: Optional[torch.dtype] = None, cast: Cast = None):
    """One worker's (clipped) weighted gradient and its loss sum, then its
    injected load; ``.grad`` untouched. The gradient is the f32 leaves'."""
    wloss, loss_sum = weighted_loss(model, *batch, compute_dtype, cast)
    grads = list(torch.autograd.grad(wloss, params))
    if grad_clip > 0:
        clip_worker_grads(grads, batch[2], grad_clip)
    _inject(load, slow_iters, wloss)
    return grads, loss_sum


def accumulate_grads(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batches: Sequence[Optional[Batch]],
    grad_clip: float = 0.0,
    load: Optional[Load] = None,
    slow_iters: Sequence[Count] = (),
    compute_dtype: Optional[torch.dtype] = None,
    losses: Optional[torch.Tensor] = None,
) -> Optional[torch.Tensor]:
    """An elastic step's gradients: ``.grad`` zeroed, then every worker's
    (clipped) weighted gradient added into it, worker r followed by
    ``slow_iters[r]`` iterations of ``load``; under ``compute_dtype`` every
    worker's forward runs on one ``cast_compute`` of the parameters. Each
    worker's loss sum goes to ``losses[r]`` when given (0 for a worker with
    no batch). Returns the sum of the losses of the entries with positive
    weight, or None if no worker had data."""
    params = prepare_step_state(optimizer)
    grads = [p.grad for p in params]
    torch._foreach_zero_(grads)
    cast = cast_compute(model.named_parameters(), compute_dtype)
    loss_sum = None
    for r, b in enumerate(batches):
        if b is None:
            if losses is not None:
                losses[r].zero_()
            continue
        n_slow = slow_iters[r] if len(slow_iters) else 0
        if grad_clip > 0:
            g, s = worker_grads(model, params, b, grad_clip, load, n_slow, compute_dtype, cast)
            torch._foreach_add_(grads, g)
        else:
            wloss, s = weighted_loss(model, *b, compute_dtype, cast)
            wloss.backward()  # adds this worker's weighted gradient into .grad
            _inject(load, n_slow, wloss)
        if losses is not None:
            losses[r].copy_(s)
        loss_sum = s if loss_sum is None else loss_sum + s
    return loss_sum


def elastic_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batches: Sequence[Optional[Batch]],
    grad_clip: float = 0.0,
    load: Optional[Load] = None,
    slow_iters: Sequence[Count] = (),
    compute_dtype: Optional[torch.dtype] = None,
) -> Optional[torch.Tensor]:
    """One DBS step over every worker's batch (``None`` for a worker with no
    real data this step): ``accumulate_grads``, then the update. Returns the
    sum of the losses of the entries with positive weight, or None if no
    worker had data."""
    loss_sum = accumulate_grads(model, optimizer, batches, grad_clip, load, slow_iters,
                                compute_dtype)
    optimizer.step()
    return loss_sum


def fused_grads(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: Batch,
    grad_accum: int = 1,
    grad_clip: float = 0.0,
    load: Optional[Load] = None,
    slow_iters: Count = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """The fused path's local gradient (the JAX ``_fused_shard_body`` before
    its collective): ``.grad`` zeroed, then the batch in ``grad_accum``
    equal micro-batches, each one's weighted gradient added into ``.grad``
    (per-example weights make the sum the whole batch's gradient), the
    clip on the sum, then the load seeded off the summed weighted loss.
    Returns the loss sum of the entries with positive weight."""
    params = prepare_step_state(optimizer)
    grads = [p.grad for p in params]
    torch._foreach_zero_(grads)
    x, y, w = batch
    b = x.shape[0]
    if b % grad_accum:
        raise ValueError(f"per-device batch {b} must divide by grad_accum {grad_accum}")
    m = b // grad_accum
    wloss = loss_sum = None
    for i in range(grad_accum):
        sl = slice(i * m, (i + 1) * m)
        wl, s = weighted_loss(model, x[sl], y[sl], w[sl], compute_dtype)
        wl.backward()
        wloss = wl.detach() if wloss is None else wloss + wl.detach()
        loss_sum = s if loss_sum is None else loss_sum + s
    if grad_clip > 0:
        clip_worker_grads(grads, w, grad_clip)
    _inject(load, slow_iters, wloss)
    return loss_sum


def packed_step(
    model: torch.nn.Module,
    optimizer: torch.optim.Optimizer,
    batch: Batch,
    load: Optional[Load] = None,
    slow_iters: Count = 0,
    compute_dtype: Optional[torch.dtype] = None,
) -> torch.Tensor:
    """One DBS step over the workers' concatenated batch (per-example
    weights as the elastic step's), then ``slow_iters`` iterations of
    ``load`` (the workers' sum). Returns the sum of the losses of the
    entries with positive weight."""
    params = prepare_step_state(optimizer)
    torch._foreach_zero_([p.grad for p in params])
    wloss, loss_sum = weighted_loss(model, *batch, compute_dtype)
    wloss.backward()
    _inject(load, slow_iters, wloss)
    optimizer.step()
    return loss_sum


def probe_grads(
    model: torch.nn.Module, params: List[torch.Tensor], batch: Batch, grad_clip: float = 0.0,
    load: Optional[Load] = None, slow_iters: Count = 0,
    compute_dtype: Optional[torch.dtype] = None,
):
    """One worker's forward/backward (and clip) and its injected load,
    gradients returned, ``.grad`` untouched; under ``compute_dtype`` its
    cast included (the elastic step casts once for all its workers)."""
    return worker_grads(model, params, batch, grad_clip, load, slow_iters, compute_dtype)[0]


@torch.no_grad()
def combine_probe(optimizer: torch.optim.SGD, worker_grads: Sequence[Sequence[torch.Tensor]],
                  params: Optional[Sequence[torch.Tensor]] = None):
    """The combine (sum over workers) and the SGD-momentum update, computed
    into new tensors: the parameters and momentum buffers are not written.
    ``params``: the parameters in the gradients' order (default: the
    optimizer's)."""
    group = optimizer.param_groups[0]
    lr, mom = group["lr"], group["momentum"]
    params = group["params"] if params is None else list(params)
    total = list(worker_grads[0])
    for g in worker_grads[1:]:
        total = torch._foreach_add(total, list(g))
    bufs = [optimizer.state.get(p, {}).get("momentum_buffer") for p in params]
    if any(b is None for b in bufs):
        step = total  # first step: the buffer starts as the gradient
    else:
        step = torch._foreach_add(torch._foreach_mul(bufs, mom), total)
    return torch._foreach_add(params, step, alpha=-lr)
