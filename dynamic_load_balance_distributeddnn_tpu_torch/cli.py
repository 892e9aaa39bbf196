"""Command-line entry point: ``python -m dynamic_load_balance_distributeddnn_tpu_torch.cli <flags>``.

Parses the JAX package's flags (``config.py``), joins the ranks when
``--coordinator`` is given (one process a device: ``--coordinator host:port
--num_processes N --process_id i``, or ``DBS_COORDINATOR``,
``DBS_NUM_PROCESSES``, ``DBS_PROCESS_ID``), skips a run whose completion
sentinel process 0 finds, then trains on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``: ``-m transformer --seq_parallel
ring|ulysses`` with the sequence-parallel trainer (``train/sp_engine.py``),
``-m transformer`` with the language-model trainer (``train/lm_engine.py``),
every other model with the vision one (which, as the JAX package's, reads
no ``--seq_parallel``).

When the run has several processes, each writes a JSON report of its rank
after the run (``Trainer.rank_report``: the collectives' backend, launch
counts, a digest of the parameters, the combine's buffers, the collective
walls and peak device memory) beside the run's statistics
(:func:`rank_report_file`), where the rank harnesses read it
(``scripts/rank_launch.py``).
"""

from __future__ import annotations

import json
import os
import sys
from typing import Optional, Sequence

import torch.distributed as dist

from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
from dynamic_load_balance_distributeddnn_tpu_torch.obs.logging import (
    mark_run_done,
    run_already_done,
)
from dynamic_load_balance_distributeddnn_tpu_torch.parallel.mesh import (
    broadcast_flag,
    initialize_multihost,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.sp_engine import SeqParallelLMTrainer


def _maybe_init_distributed(cfg) -> None:
    """The rendezvous (the reference's ``MASTER_ADDR``/``PORT`` and
    ``init_process_group('gloo')``): one process a device, from
    ``--coordinator``; a no-op without one."""
    initialize_multihost(
        cfg.coordinator,
        num_processes=cfg.num_processes if cfg.num_processes > 0 else None,
        process_id=cfg.process_id if cfg.process_id >= 0 else None,
    )


def _run_already_done_global(cfg) -> bool:
    """The idempotence probe, made collective: process 0 decides and every
    rank follows, so no rank skips while its peers wait in their first
    collective."""
    return broadcast_flag(run_already_done(cfg))


def rank_report_file(cfg, proc_id: int) -> str:
    """Where process ``proc_id`` of a multi-process run writes its rank
    report: ``<stat_dir>/<base_filename of the process>.rank.json``."""
    return os.path.join(cfg.stat_dir, cfg.base_filename().format(proc_id) + ".rank.json")


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    cfg = config_from_args(argv)
    joined = not dist.is_initialized()
    _maybe_init_distributed(cfg)
    joined = joined and dist.is_initialized()  # this call made the group: it ends it
    try:
        return _main(cfg, device)
    finally:
        if joined:
            dist.destroy_process_group()


def _main(cfg, device) -> int:
    if _run_already_done_global(cfg):
        print("\n===========================")
        print("Had finished this experiment, skipping...")
        print("===========================\n")
        return 0
    if cfg.model == "transformer" and cfg.seq_parallel:
        trainer = SeqParallelLMTrainer(cfg, device=device)
    else:
        trainer = (LMTrainer if cfg.model == "transformer" else Trainer)(cfg, device=device)
    trainer.run()
    mark_run_done(cfg)
    if cfg.num_processes > 1:
        os.makedirs(cfg.stat_dir, exist_ok=True)
        with open(rank_report_file(cfg, trainer.proc_id), "w") as f:
            json.dump(trainer.rank_report(), f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
