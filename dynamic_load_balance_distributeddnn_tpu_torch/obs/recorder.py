"""Per-epoch metrics recorder (the JAX package's ``obs/recorder.py``).

Records the reference's nine per-epoch series and persists them as a
pickled-dict ``.npy`` plus a JSON sidecar under ``stat_dir``, with the
config-encoded file name — the same artifacts the JAX trainer writes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List

import numpy as np

SERIES = (
    "epoch",
    "train_loss",
    "train_time",
    "sync_time",
    "val_loss",
    "accuracy",
    "partition",
    "node_time",
    "wallclock_time",
)


def _pythonize(v):
    """Coerce numpy scalars/arrays to plain Python so series stay JSON-able."""
    if isinstance(v, np.ndarray):
        return v.tolist() if v.ndim else v.item()
    if isinstance(v, (np.floating, np.integer, np.bool_)):
        return v.item()
    if isinstance(v, (list, tuple)):
        return [_pythonize(x) for x in v]
    return v


class MetricsRecorder:
    def __init__(self):
        self.data: Dict[str, List] = {k: [] for k in SERIES}
        # run-level facts (e.g. synthetic data), saved under "_meta" in the
        # JSON sidecar only
        self.meta: Dict[str, object] = {}

    def stamp_data_source(self, src) -> None:
        """Record where the data came from (a ``DatasetBundle`` or a
        ``Corpus``): the synthetic stand-in flag and the fallbacks taken
        (``notes``, e.g. valid.txt standing in for a missing train.txt)."""
        self.meta["synthetic"] = bool(getattr(src, "synthetic", False))
        notes = list(getattr(src, "notes", []))
        if notes:
            self.meta["data_notes"] = notes

    def record_epoch(self, **kw) -> None:
        """The nine series are mandatory; extra keyword series are recorded
        alongside them."""
        missing = set(SERIES) - set(kw)
        if missing:
            raise ValueError(f"missing series: {sorted(missing)}")
        for k, v in kw.items():
            self.data.setdefault(k, []).append(_pythonize(v))

    def save(self, stat_dir: str, base_filename: str, rank: int = 0) -> str:
        os.makedirs(stat_dir, exist_ok=True)
        stem = base_filename.format(rank)
        npy_path = os.path.join(stat_dir, stem + ".npy")
        np.save(npy_path, self.data)
        payload = dict(self.data)
        if self.meta:
            payload["_meta"] = {k: _pythonize(v) for k, v in self.meta.items()}
        with open(os.path.join(stat_dir, stem + ".json"), "w") as f:
            json.dump(payload, f)
        return npy_path
