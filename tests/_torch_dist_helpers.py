"""Rank entry points of the port's multi-rank tests (``tests/test_torch_dist*.py``).

This module imports only torch, numpy, the port and the rank launcher
(``scripts/rank_launch.py``), never JAX: each rank is
a fresh ``python -c`` child that imports it (the test modules import JAX).

A ``train``, ``lm_train`` or ``sp_train`` job runs ``job["epochs"]``
epochs when given (a run stopped there, for a resume from its
``--ckpt_dir``) and returns the warnings its trainer logged.

``launch(world, jobs, tmp)`` starts ``world`` ranks, each with one torch
thread, that rendezvous through ``file://`` under ``tmp`` and run the same
``jobs`` in order in one process group (a job is a dict with a ``kind``:
``train``, ``warm_train``, ``lm_train``, ``collectives``, ``combine``,
``tree``, ``sp_attn``, ``sp_grad``, ``sp_train`` or ``sp_contracts``); ``scripts/rank_launch.py``
``launch_ranks`` joins them with a timeout, kills them all when it expires
or a rank fails, and raises with their logs, so a hang fails the test
instead of the tier. It returns each rank's results.
"""

from __future__ import annotations

import logging
import os
import sys
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from scripts.rank_launch import launch_ranks

REPO = Path(__file__).resolve().parents[1]
FACTORS = {"3,1": (3.0, 1.0), "3,1,1,1": (3.0, 1.0, 1.0, 1.0)}


def launch(world: int, jobs: Dict[str, dict], tmp: Path, timeout: float = 300.0) -> List[dict]:
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    spec = tmp / "jobs.pt"
    torch.save(jobs, spec)
    init = tmp / "rendezvous"
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    code = "from tests._torch_dist_helpers import rank_main; rank_main()"
    cmds = [[sys.executable, "-c", code, str(spec), str(r), str(world), str(init),
             str(tmp / f"rank{r}.pt")] for r in range(world)]
    launch_ranks(cmds, str(tmp), timeout, [env] * world, cwd=str(REPO))
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(world)]


def computed_once(tmp_path_factory, name: str, fn):
    """``fn(directory)`` computed once a test session, however many
    pytest-xdist workers ask: the first takes a file lock under the
    session's shared temporary root, computes, saves the result
    (``torch.save``) and releases; the others wait on the lock and load it.
    ``directory`` is a shared one named ``name``."""
    from filelock import FileLock

    root = Path(tmp_path_factory.getbasetemp())
    if os.environ.get("PYTEST_XDIST_WORKER"):
        root = root.parent  # the session's root, shared by the workers
    path = root / f"{name}.pt"
    with FileLock(str(path) + ".lock"):
        if path.exists():
            return torch.load(path, weights_only=False)
        out = fn(root / name)
        torch.save(out, path)
        return out


def rank_main() -> None:
    spec, rank, world, init, out = sys.argv[1:]
    rank, world = int(rank), int(world)
    torch.set_num_threads(1)
    import torch.distributed as dist

    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(f"file://{init}", world, rank, timeout_s=240)
    jobs = torch.load(spec, weights_only=False)
    results = {name: _JOBS[job["kind"]](job, rank, world) for name, job in jobs.items()}
    torch.save(results, out)
    dist.destroy_process_group()


# ---------------------------------------------------------------- jobs


class _Warnings(logging.Handler):
    """The warnings a trainer's logger emits, kept as their messages."""

    def __init__(self):
        super().__init__(level=logging.WARNING)
        self.messages: List[str] = []

    def emit(self, record) -> None:
        self.messages.append(record.getMessage())


def _run(tr, job: dict) -> List[str]:
    """``tr.run`` for ``job["epochs"]`` epochs (all without it); returns
    the warnings its logger emitted."""
    h = _Warnings()
    tr.logger.logger.addHandler(h)
    try:
        tr.run(job.get("epochs"))
    finally:
        tr.logger.logger.removeHandler(h)
    return h.messages


def straggler_time(factors):
    """Deterministic compute model: time proportional to examples, with the
    worker factors (as ``tests/test_torch_engine.py``'s)."""

    def model(plan):
        return np.array([f * w.batch_size * w.steps * 1e-3 for f, w in zip(factors, plan.workers)])

    return model


def trainer(job: dict, rank: int = 0, world: int = 1):
    """A port ``Trainer`` on the CPU for ``job``: its ``cfg`` (this rank's
    process flags added when ``world > 1``), the synthetic MNIST stand-in,
    the straggler timing model ``job["timing"]`` (a ``FACTORS`` key), the
    weights ``job["state"]`` and dropout off with ``job["no_dropout"]``."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    kw = dict(job["cfg"])
    if world > 1:
        kw.update(num_processes=world, process_id=rank)
    timing = job.get("timing")
    tr = Trainer(Config(**kw),
                 bundle=synthetic_dataset("mnist", n_train=kw["n_train"], n_test=job.get("n_test", 256)),
                 timing_model=None if timing is None else straggler_time(FACTORS[timing]),
                 device="cpu", log_to_file=False)
    if job.get("state") is not None:
        tr.model.load_state_dict(job["state"])
    if job.get("no_dropout"):
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return tr


def train_outputs(tr) -> dict:
    """What a train job returns: the series, part of ``_meta``, the
    parameters, the momentum (the buffers by name, or the ZeRO-1 chunk) and
    the rank report."""
    named = dict(tr.model.named_parameters())
    bufs = {k: tr.optimizer.state.get(p, {}).get("momentum_buffer") for k, p in named.items()}
    rc = tr._rank_combine
    return {
        "residuals": (None if rc is None or rc.axes is None
                      else [r.clone() for r in rc.residuals]),
        "steps": tr.steps_done,
        "generators": {k: g.get_state() for k, g in tr._generators().items()},
        "data": {k: list(v) for k, v in tr.recorder.data.items()},
        "meta": {k: tr.recorder.meta.get(k) for k in ("paths", "ranks", "combine", "collective",
                                                      "supersteps", "grad_comm", "grad_comm_levels",
                                                      "grad_comm_wires", "link_bandwidth",
                                                      "modeled_comm_step_s")},
        "params": {k: p.detach().clone() for k, p in named.items()},
        "momentum": {k: b.clone() for k, b in bufs.items() if b is not None},
        "chunk": None if rc is None or not rc.shard_update else rc.mom.clone(),
        "mode": tr._elastic_mode(),
        "report": tr.rank_report(),
    }


def _train(job: dict, rank: int, world: int) -> dict:
    tr = trainer(job, rank, world)
    warnings = _run(tr, job)
    return dict(train_outputs(tr), warnings=warnings)


def lm_trainer(job: dict, rank: int = 0, world: int = 1):
    """A port ``LMTrainer`` on the CPU for ``job``: its ``cfg`` (this rank's
    process flags added when ``world > 1``), the corpus under
    ``job["corpus"]``, the straggler timing model ``job["timing"]``, the
    weights ``job["state"]``, dropout ``job.get("dropout", 0.0)``, and
    ``job["max_logits"]`` (if given) as the validation chunk's bound."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus
    from dynamic_load_balance_distributeddnn_tpu_torch.train import lm_engine

    kw = dict(job["cfg"])
    if world > 1:
        kw.update(num_processes=world, process_id=rank)
    if job.get("max_logits"):
        lm_engine.MAX_LOGITS = job["max_logits"]
    cls = type("LM", (lm_engine.LMTrainer,), {"DROPOUT": job.get("dropout", 0.0)})
    timing = job.get("timing")
    tr = cls(Config(**kw), bundle=Corpus(job["corpus"]),
             timing_model=None if timing is None else straggler_time(FACTORS[timing]),
             device="cpu", log_to_file=False)
    if job.get("state") is not None:
        tr.model.load_state_dict(job["state"])
    return tr


def _lm_train(job: dict, rank: int, world: int) -> dict:
    tr = lm_trainer(job, rank, world)
    warnings = _run(tr, job)
    out = dict(train_outputs(tr), warnings=warnings)
    out["validate"] = tr.validate()
    return out


def _collectives(job: dict, rank: int, world: int) -> dict:
    """``exchange_times``, the probe vote and the compressed wire on the
    job's inputs (``job["v"]``: one row a rank)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.balance import exchange_times
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import (
        fold_in,
        fold_in_many,
        prng_key,
    )

    mesh = data_mesh("cpu")
    times = exchange_times(np.array([10.0 * rank + 0.5, 10.0 * rank + 0.25]))
    votes = [bool(np.any(exchange_times(np.array([1.0 if rank == who else 0.0])) > 0.5))
             for who in (-1, world - 1)]
    v = torch.from_numpy(job["v"][rank])
    key = fold_in(prng_key(job["seed"]), rank)  # as each device folds in its index
    total, sent = wire.compressed_reduce(v, key, mesh, world, "int8")
    t4, s4 = wire.compressed_reduce(v, key, mesh, world, "int4")
    scattered = wire.compressed_reduce_scatter(v, key, mesh, world, "int8")
    sizes = job["sizes"]
    leaves = wire.compressed_reduce_leaves(v, sizes, fold_in_many(key, [i + 0x7FFF for i in range(len(sizes))]),
                                           mesh, world)
    return {"times": times, "votes": votes, "total": total, "sent": sent, "total4": t4, "sent4": s4,
            "scattered": scattered, "leaves": leaves, "backend": mesh.backend}


def _combine(job: dict, rank: int, world: int) -> dict:
    """One step of the port's combine (``train/combine.py``) on given
    gradients, for each of ``job["variants"]`` (``RankCombine`` keywords,
    ``channels_last`` to lay the convolutions' parameters out so): MnistNet
    (or ``job["model"]``, a ``(name, keywords)`` of ``build_model``) from
    zero parameters, SGD at lr 1 and momentum 0.9, this rank's
    gradients ``job["grads"][rank]`` (a state dict) in ``.grad``, the key
    ``fold_in(PRNGKey(job["seed"]), rank)``. The parameters after the
    step are minus the combined gradient, exactly."""
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import fold_in, prng_key
    from dynamic_load_balance_distributeddnn_tpu_torch.train.combine import RankCombine

    mesh = data_mesh("cpu")
    key = fold_in(prng_key(job["seed"]), rank)
    name_kw = job.get("model", ("mnistnet", {"num_classes": 10, "in_channels": 1}))
    out = {}
    for name, variant in job["variants"].items():
        kw = dict(variant)
        model = build_model(name_kw[0], **name_kw[1])
        if kw.pop("channels_last", False):
            model = model.to(memory_format=torch.channels_last)
        named = dict(model.named_parameters())
        with torch.no_grad():
            for p in named.values():
                p.zero_()
        opt = torch.optim.SGD(model.parameters(), lr=1.0, momentum=0.9)
        rc = RankCombine(mesh, model, opt, 0.9, **kw)
        for k, g in job["grads"][rank].items():
            named[k].grad.copy_(g)
        rc.step(1.0, key)
        out[name] = {k: p.detach().clone() for k, p in named.items()}
        if rc.axes is not None:
            out[name + ":residuals"] = [r.clone() for r in rc.residuals]
    return out


def _tree(job: dict, rank: int, world: int) -> dict:
    """``parallel/wire.py`` ``tree_allreduce`` of this rank's row of
    ``job["v"]`` for each of ``job["cases"]`` (name: ``(names, sizes,
    wires, residuals)``, ``residuals`` None or one ``[world, W_i]`` array a
    hop), key ``fold_in(PRNGKey(job["seed"]), rank)``: the output and the
    new residuals of each case, and on two levels whether
    ``hier_tree_allreduce`` gives the same."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.prng import fold_in, prng_key

    mesh = data_mesh("cpu")
    key = fold_in(prng_key(job["seed"]), rank)
    v = torch.from_numpy(job["v"][rank])
    out = {}
    for name, (names, sizes, wires, res) in job["cases"].items():
        axes = mesh.tree_axes(names, sizes)
        res = None if res is None else [torch.from_numpy(r[rank]) for r in res]
        total, new = wire.tree_allreduce(v, key, axes, wires, res)
        out[name] = {"out": total, "residuals": new, "groups": [a.ranks for a in axes]}
        if len(axes) == 2:  # the two-level delegate gives the same
            t2, r2 = wire.hier_tree_allreduce(v, key, *axes, wires[0], None if res is None else res[0])
            out[name]["two_level_same"] = torch.equal(t2, total) and torch.equal(r2, new[0])
    return out


def _sp_attn(job: dict, rank: int, world: int) -> dict:
    """Ring and Ulysses attention on this rank's blocks of ``job["q"]``,
    ``["k"]``, ``["v"]`` (``[B, H, T, D]``, the sequence split in rank
    order), causal and not, with the gradients of ``sum(out * job["g"])``
    (this rank's block of ``g``) with respect to its blocks: the output and
    the gradients of each (mode, causal, use_flash)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ring import ring_self_attention
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.ulysses import (
        ulysses_self_attention,
    )

    mesh = data_mesh("cpu")
    t = job["q"].shape[2] // world
    sl = slice(rank * t, (rank + 1) * t)
    out = {}
    for mode, causal, flash in job["cases"]:
        q, k, v = (torch.from_numpy(job[x][:, :, sl]).requires_grad_() for x in "qkv")
        if mode == "ring":
            o = ring_self_attention(q, k, v, mesh, causal=causal)
        else:
            o = ulysses_self_attention(q, k, v, mesh, causal=causal, use_flash=flash)
        (o * torch.from_numpy(job["g"][:, :, sl])).sum().backward()
        out[(mode, causal, flash)] = {"o": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def _sp_model(job: dict, mesh, mode: str):
    from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model

    model = build_model("transformer", **job["dims"], seq_axis=mesh, sp_mode=mode)
    model.load_state_dict(job["state"])
    return model


def _sp_grad(job: dict, rank: int, world: int) -> dict:
    """``seq_parallel_value_and_grad(train=False)`` of the SP model (each of
    ``job["modes"]``, weights ``job["state"]``, dimensions ``job["dims"]``)
    on this rank's blocks of ``job["tokens"]`` and ``["targets"]``: the
    loss and the gradients by parameter name."""
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import data_mesh
    from dynamic_load_balance_distributeddnn_tpu_torch.parallel.seq_parallel import (
        seq_parallel_value_and_grad,
    )

    mesh = data_mesh("cpu")
    t = job["tokens"].shape[1] // world
    x, y = (torch.from_numpy(job[a][:, rank * t:(rank + 1) * t]) for a in ("tokens", "targets"))
    out = {}
    for mode in job["modes"]:
        model = _sp_model(job, mesh, mode)
        loss, grads = seq_parallel_value_and_grad(model, x, y, mesh)
        names = [n for n, _ in model.named_parameters()]
        out[mode] = {"loss": float(loss), "grads": dict(zip(names, grads))}
    return out


def _sp_train(job: dict, rank: int, world: int) -> dict:
    """A port ``SeqParallelLMTrainer`` on the CPU: its ``cfg`` (this rank's
    process flags added), the corpus under ``job["corpus"]``, dropout
    ``job["dropout"]``, the weights ``job["state"]`` if given; the series,
    the parameters and the rank report after ``run``."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus
    from dynamic_load_balance_distributeddnn_tpu_torch.train import sp_engine

    kw = dict(job["cfg"], num_processes=world, process_id=rank)
    cls = type("SP", (sp_engine.SeqParallelLMTrainer,), {"DROPOUT": job["dropout"]})
    tr = cls(Config(**kw), corpus=Corpus(job["corpus"]), device="cpu", log_to_file=False)
    if job.get("state") is not None:
        tr.model.load_state_dict(job["state"])
    warnings = _run(tr, job)
    return {"data": {k: list(v) for k, v in tr.recorder.data.items()},
            "meta": dict(tr.recorder.meta), "warnings": warnings,
            "params": {k: p.detach().clone() for k, p in tr.model.named_parameters()},
            "report": tr.rank_report()}


def _sp_contracts(job: dict, rank: int, world: int) -> dict:
    """The ``SeqParallelLMTrainer`` contracts that need ranks: ``bptt`` 18
    (not a multiple of a 4-rank world) and Ulysses' 2 heads over 4 ranks;
    each raises, and the job returns ``(type name, message)`` of each."""
    from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
    from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus
    from dynamic_load_balance_distributeddnn_tpu_torch.train.sp_engine import (
        SeqParallelLMTrainer,
    )

    out = {}
    for name, over in (("bptt", {"bptt": 18, "seq_parallel": "ring"}),
                       ("ulysses", {"seq_parallel": "ulysses"})):
        cfg = Config(**dict(job["cfg"], num_processes=world, process_id=rank, **over))
        try:
            SeqParallelLMTrainer(cfg, corpus=Corpus(job["corpus"]), device="cpu",
                                 log_to_file=False)
        except ValueError as e:
            out[name] = (type(e).__name__, str(e))
    return out


class _ReplayGraph:
    """A CUDA graph's contract on the CPU: the capture records the step and
    runs nothing, each replay runs it."""

    def __init__(self, executor):
        self.fn = None

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _warm_train(job: dict, rank: int, world: int) -> dict:
    """A train job whose step graphs are ``_ReplayGraph``s; adds the warm
    service's stats, the batch widths of the keys it speculated and of every
    key it knows, and each epoch's batch sizes."""
    tr = trainer(job, rank, world)
    tr.supersteps._factory = _ReplayGraph
    warnings = _run(tr, job)
    svc = tr._aot

    def widths(keys):
        return sorted({tuple(x[0] for x in k[1]) for k in keys})

    return dict(train_outputs(tr), warnings=warnings, aot=svc.stats(),
                speculated=widths(svc._speculative), known=widths(svc.keys()),
                graph_captures=tr.recorder.data["graph_captures"])


_JOBS = {"train": _train, "lm_train": _lm_train, "collectives": _collectives,
         "combine": _combine, "tree": _tree, "sp_attn": _sp_attn, "sp_grad": _sp_grad,
         "sp_train": _sp_train, "sp_contracts": _sp_contracts, "warm_train": _warm_train}
