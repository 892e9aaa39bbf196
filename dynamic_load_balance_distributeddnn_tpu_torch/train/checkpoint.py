"""Checkpoint and resume (the JAX package's ``train/checkpoint.py``, torch-native).

The reference has no model checkpointing; the JAX package adds orbax
checkpoints of its TrainState with a JSON sidecar holding the DBS
controller's state, so a resumed run continues balanced where it stopped.
This port keeps the layout and the contract without orbax:

- one directory per epoch under ``ckpt_dir`` (``<ckpt_dir>/<epoch>/``),
  the last :data:`MAX_TO_KEEP` kept, as orbax's ``max_to_keep=3``;
- in it, ``state.pt``: a ``torch.save`` of the parameters by name, the SGD
  momentum buffers by the same names, the trainer's step counter and the
  states of its generators (``dropout_gen``, ``aug_gen``);
- beside it, the sidecar ``controller_<epoch>.json`` with the JAX keys
  (``shares``, ``node_times``, ``total_wallclock``, ``total_probe_s``,
  ``active_ranks``).

A save writes the sidecar, then the state into a temporary directory that
``os.replace`` renames to the epoch's: a half-written checkpoint is never
the latest. The JAX package saves asynchronously and drains at
:func:`flush_checkpoints`; here a save blocks and the flush makes the last
checkpoint durable (``fsync``) at the end of a run.

**Across processes** the contract is the JAX package's: one checkpoint of
the *global* state, and process 0 alone writes the sidecar. The save is
collective. The engine gathers to every rank what is a rank's own (ZeRO-1's
momentum chunks into the one-process layout, ``RankCombine
.momentum_by_name``; under ``--grad_comm hier`` the error-feedback
residuals, one row a rank, ``RankCombine.residual_rows``; each rank's
generator states); rank 0 writes the sidecar and ``state.pt`` (the
parameters and the momentum in the one-process layout, the rest under
``ranks``) and renames it into place; then every rank meets at a barrier,
so none goes on before the checkpoint is whole. A restore reads the file on
every rank, and each takes its own chunk, residual rows and generators.

:func:`restore_checkpoint` loads with ``torch.load(..., weights_only=True)``
and copies into the live parameters and momentum buffers with
``Tensor.copy_``: a captured step graph (``train/supersteps.py``) keeps the
addresses of both, so nothing is rebound.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MAX_TO_KEEP = 3
STATE_FILE = "state.pt"


def _epochs(ckpt_dir: str) -> List[int]:
    """The epochs with a complete checkpoint directory, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(
        int(n) for n in os.listdir(ckpt_dir)
        if n.isdigit() and os.path.isfile(os.path.join(ckpt_dir, n, STATE_FILE))
    )


def _sidecar(ckpt_dir: str, epoch: int) -> str:
    return os.path.join(ckpt_dir, f"controller_{epoch}.json")


def _named_momentum(model: torch.nn.Module, optimizer: torch.optim.Optimizer):
    """``(name, momentum buffer)`` of every parameter that has one."""
    for name, p in model.named_parameters():
        buf = optimizer.state.get(p, {}).get("momentum_buffer")
        if buf is not None:
            yield name, buf


def save_checkpoint(
    ckpt_dir: str, epoch: int, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    controller: Dict[str, Any], steps: int = 0,
    generators: Optional[Dict[str, torch.Generator]] = None,
    momentum: Optional[Dict[str, torch.Tensor]] = None,
    ranks: Optional[Dict[str, Any]] = None,
    write: bool = True,
    barrier: Optional[Callable[[], None]] = None,
) -> str:
    """Save epoch ``epoch``'s state and sidecar; returns the directory.
    ``controller``: the JSON-safe controller state (numpy vectors become
    lists, scalars floats, as the JAX package writes them). ``momentum``:
    the momentum buffers by parameter name where the optimizer does not
    hold them (``--shard_update``'s chunk, ``train/combine.py``). Across
    processes: ``ranks``, every rank's own state gathered (saved as
    ``state["ranks"]``), ``write`` true on rank 0 alone, and ``barrier``
    called by every rank once the writer has renamed the checkpoint into
    place."""
    final = os.path.join(ckpt_dir, str(epoch))
    if write:
        _write(ckpt_dir, epoch, model, optimizer, controller, steps, generators, momentum, ranks)
    if barrier is not None:
        barrier()
    return final


def _write(ckpt_dir, epoch, model, optimizer, controller, steps, generators, momentum,
           ranks) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    clean = {
        k: (np.asarray(v).tolist() if not np.isscalar(v) else float(v))
        for k, v in controller.items()
    }
    side = _sidecar(ckpt_dir, epoch)
    with open(side + ".tmp", "w") as f:
        json.dump(clean, f)
    os.replace(side + ".tmp", side)
    payload = {
        "epoch": int(epoch),
        "steps": int(steps),
        "params": {n: p.detach().to("cpu", copy=True) for n, p in model.named_parameters()},
        "momentum": {n: b.detach().to("cpu", copy=True) for n, b in (
            momentum.items() if momentum is not None else _named_momentum(model, optimizer))},
        "generators": {k: g.get_state() for k, g in (generators or {}).items()},
    }
    if ranks is not None:
        payload["ranks"] = ranks
    final = os.path.join(ckpt_dir, str(epoch))
    tmp = os.path.join(ckpt_dir, f".tmp-{epoch}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    for old in _epochs(ckpt_dir)[:-MAX_TO_KEEP]:
        shutil.rmtree(os.path.join(ckpt_dir, str(old)), ignore_errors=True)


def flush_checkpoints(ckpt_dir: str) -> None:
    """Make the latest checkpoint durable: ``fsync`` its files, its
    sidecar and the directories. Saves here block, so nothing is pending;
    this is the end-of-run point where the JAX package drains its
    asynchronous saves."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return
    last = os.path.join(ckpt_dir, str(epochs[-1]))
    for path in (os.path.join(last, STATE_FILE), _sidecar(ckpt_dir, epochs[-1])):
        if os.path.exists(path):
            with open(path, "rb") as f:
                os.fsync(f.fileno())
    for d in (last, ckpt_dir):
        fd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)


@torch.no_grad()
def restore_checkpoint(
    ckpt_dir: str, model: torch.nn.Module, optimizer: torch.optim.Optimizer,
    load_momentum: Optional[Callable[[Dict[str, torch.Tensor]], None]] = None,
) -> Optional[Tuple[int, Dict[str, Any], Dict[str, Any]]]:
    """Copy the latest checkpoint into ``model``'s parameters and
    ``optimizer``'s momentum buffers in place; returns ``(epoch, state,
    controller)``, ``state`` holding ``steps``, the generator states and,
    from a save across processes, ``ranks``; or None when ``ckpt_dir`` is
    absent or holds no checkpoint. The momentum buffers must exist
    (``train/steps.py`` ``prepare_step_state``), unless ``load_momentum``
    takes the saved momentum by name instead (ZeRO-1's chunk,
    ``RankCombine.load_momentum``). A checkpoint whose names or shapes do
    not match the model raises."""
    epochs = _epochs(ckpt_dir)
    if not epochs:
        return None
    epoch = epochs[-1]
    state = torch.load(os.path.join(ckpt_dir, str(epoch), STATE_FILE),
                       map_location="cpu", weights_only=True)
    params = dict(model.named_parameters())
    if set(state["params"]) != set(params):
        raise ValueError(
            f"checkpoint {ckpt_dir}/{epoch}: its parameters "
            f"{sorted(set(state['params']) ^ set(params))} do not match the model's"
        )
    bufs = dict(_named_momentum(model, optimizer)) if load_momentum is None else params
    if set(state["momentum"]) != set(bufs):
        raise ValueError(
            f"checkpoint {ckpt_dir}/{epoch}: its momentum buffers do not match "
            "the optimizer's (prepare the step state before restoring)"
        )
    for saved_map, live in ((state["params"], params), (state["momentum"], bufs)):
        for name, saved in saved_map.items():
            if saved.shape != live[name].shape or saved.dtype != live[name].dtype:
                raise ValueError(
                    f"checkpoint {ckpt_dir}/{epoch}: {name} is {saved.dtype} "
                    f"{tuple(saved.shape)}, the model's {live[name].dtype} "
                    f"{tuple(live[name].shape)}"
                )
    for name, saved in state["params"].items():
        params[name].copy_(saved)
    if load_momentum is None:
        for name, saved in state["momentum"].items():
            bufs[name].copy_(saved)
    else:
        load_momentum(state["momentum"])
    controller: Dict[str, Any] = {}
    side = _sidecar(ckpt_dir, epoch)
    if os.path.exists(side):
        with open(side) as f:
            controller = json.load(f)
    out = {"steps": int(state["steps"]), "generators": state["generators"]}
    if "ranks" in state:
        out["ranks"] = state["ranks"]
    return epoch, out, controller
