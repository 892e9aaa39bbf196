"""Run logging (the JAX package's ``obs/logging.py``).

A file + stream logger whose format injects the run's world size, learning
rate and dbs/ft switches into every line, and whose file name encodes the
full config; plus the completion sentinel that makes re-running a finished
configuration a no-op.
"""

from __future__ import annotations

import logging
import os
import socket
import time
from typing import Optional

from dynamic_load_balance_distributeddnn_tpu_torch.config import Config

_FORMAT = (
    "%(asctime)s [%(world_size)s:%(lr)s:dbs_%(dbs)s:ft_%(ft)s] "
    "[%(filename)s:%(lineno)d] %(levelname)s %(message)s"
)


def init_logger(cfg: Config, rank: int = 0, to_file: bool = True,
                job: Optional[str] = None) -> logging.LoggerAdapter:
    """The run's logger; a tenant of the many-stream engine (``job``) gets
    one of its own, so that admitting another tenant does not take over its
    handlers."""
    extra = {
        "world_size": cfg.world_size,
        "lr": cfg.learning_rate,
        "dbs": "enabled" if cfg.dynamic_batch_size else "disabled",
        "ft": "enabled" if cfg.fault_tolerance else "disabled",
    }
    name = f"{socket.gethostname()}.dbs_torch"
    logger = logging.getLogger(name if job is None else f"{name}.job.{job}")
    for h in logger.handlers[:]:
        logger.removeHandler(h)
        h.close()
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    formatter = logging.Formatter(_FORMAT)

    sh = logging.StreamHandler()
    sh.setFormatter(formatter)
    logger.addHandler(sh)

    if to_file:
        os.makedirs(cfg.log_dir, exist_ok=True)
        path = os.path.join(cfg.log_dir, cfg.base_filename().format(rank) + ".log")
        fh = logging.FileHandler(path, "w")
        fh.setFormatter(formatter)
        logger.addHandler(fh)
        logging.LoggerAdapter(logger, extra).info(
            f"==== run started (pid {os.getpid()}, "
            f"{time.strftime('%Y-%m-%dT%H:%M:%S')}) ===="
        )

    return logging.LoggerAdapter(logger, extra)


def _done_sentinel(cfg: Config) -> str:
    return os.path.join(cfg.log_dir, cfg.base_filename().format(0) + ".done")


def mark_run_done(cfg: Config) -> None:
    """Record successful completion, after the metrics are saved."""
    os.makedirs(cfg.log_dir, exist_ok=True)
    with open(_done_sentinel(cfg), "w") as f:
        f.write("done\n")


def run_already_done(cfg: Config) -> bool:
    """Idempotence probe for completed runs."""
    return os.path.isfile(_done_sentinel(cfg))
