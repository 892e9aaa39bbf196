"""Command-line entry point: ``python -m dynamic_load_balance_distributeddnn_tpu_torch.cli <flags>``.

Parses the JAX package's flags (``config.py``), skips a run whose completion
sentinel already exists, then trains on the card (``device="cuda"``) unless
the caller passes ``device="cpu"``: ``-m transformer`` with the language-model
trainer (``train/lm_engine.py``), every other model with the vision one.
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence

from dynamic_load_balance_distributeddnn_tpu_torch.config import config_from_args
from dynamic_load_balance_distributeddnn_tpu_torch.obs.logging import (
    mark_run_done,
    run_already_done,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer


def main(argv: Optional[Sequence[str]] = None, device="cuda") -> int:
    cfg = config_from_args(argv)
    if run_already_done(cfg):
        print("\n===========================")
        print("Had finished this experiment, skipping...")
        print("===========================\n")
        return 0
    trainer = LMTrainer if cfg.model == "transformer" else Trainer
    trainer(cfg, device=device).run()
    mark_run_done(cfg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
