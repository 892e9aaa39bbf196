"""Vision dataset readers — a copy of the JAX package's ``data/datasets.py``.

Datasets load into host numpy arrays as raw uint8 NHWC images; the trainer
moves them to the card once and normalizes/augments there. When the files
are absent (nothing is downloaded), a deterministic synthetic stand-in with
the real shapes and a learnable label rule is substituted and flagged via
``DatasetBundle.synthetic``.
"""

from __future__ import annotations

import dataclasses
import gzip
import os
import pickle
from typing import Optional, Tuple

import numpy as np

# Channel stats of the reference's Normalize transforms. "mnist" is
# FashionMNIST, like the reference.
NORM_STATS = {
    "mnist": ((0.2860,), (0.3530,)),
    "cifar10": ((0.4914, 0.4822, 0.4465), (0.2470, 0.2435, 0.2616)),
    "cifar100": ((0.5071, 0.4865, 0.4409), (0.2673, 0.2564, 0.2762)),
}

_SHAPES = {
    "mnist": (28, 28, 1),
    "cifar10": (32, 32, 3),
    "cifar100": (32, 32, 3),
}

_NUM_CLASSES = {"mnist": 10, "cifar10": 10, "cifar100": 100}

_FULL_SIZES = {name: (50000 if name != "mnist" else 60000, 10000) for name in _SHAPES}


@dataclasses.dataclass
class DatasetBundle:
    """One dataset, fully materialized on the host: raw uint8 NHWC images and
    the per-channel stats the normalizer applies."""

    name: str
    train_x: np.ndarray
    train_y: np.ndarray
    test_x: np.ndarray
    test_y: np.ndarray
    num_classes: int
    mean: Tuple[float, ...]
    std: Tuple[float, ...]
    synthetic: bool = False


def synthetic_dataset(
    name: str, n_train: int = 4096, n_test: int = 1024, seed: int = 1234
) -> DatasetBundle:
    """Deterministic stand-in with the real dataset's shapes and a learnable
    label rule: the top-left patch encodes the class."""
    h, w, c = _SHAPES[name]
    nc = _NUM_CLASSES[name]
    rng = np.random.RandomState(seed)

    def gen(n: int):
        x = rng.randint(0, 256, size=(n, h, w, c)).astype(np.uint8)
        y = rng.randint(0, nc, size=(n,)).astype(np.int32)
        patch = (y * (255 // nc) + (255 // nc) // 2).astype(np.uint8)
        x[:, : h // 4, : w // 4, :] = patch[:, None, None, None]
        return x, y

    train_x, train_y = gen(n_train)
    test_x, test_y = gen(n_test)
    mean, std = NORM_STATS[name]
    return DatasetBundle(
        name=name,
        train_x=train_x,
        train_y=train_y,
        test_x=test_x,
        test_y=test_y,
        num_classes=nc,
        mean=mean,
        std=std,
        synthetic=True,
    )


def _read_idx(path: str, magic: int, header: int) -> Optional[bytes]:
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rb") as f:
            data = f.read()
    except OSError:
        return None
    if len(data) < header or int.from_bytes(data[:4], "big") != magic:
        return None
    return data


def _read_idx_images(path: str) -> Optional[np.ndarray]:
    data = _read_idx(path, 2051, 16)
    if data is None:
        return None
    n, rows, cols = (int.from_bytes(data[4 + 4 * i : 8 + 4 * i], "big") for i in range(3))
    return np.frombuffer(data, np.uint8, offset=16).reshape(n, rows, cols, 1)


def _read_idx_labels(path: str) -> Optional[np.ndarray]:
    data = _read_idx(path, 2049, 8)
    if data is None:
        return None
    return np.frombuffer(data, np.uint8, offset=8).astype(np.int32)


def _find(data_dir: str, *candidates: str) -> Optional[str]:
    for rel in candidates:
        p = os.path.join(data_dir, rel)
        if os.path.exists(p):
            return p
        if os.path.exists(p + ".gz"):
            return p + ".gz"
    return None


def _load_fashion_mnist(data_dir: str):
    """FashionMNIST from the torchvision on-disk layout."""
    raw = os.path.join(data_dir, "FashionMNIST", "raw")
    parts = {}
    for split, img, lab in (
        ("train", "train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
        ("test", "t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
    ):
        ip = _find(raw, img) or _find(data_dir, img)
        lp = _find(raw, lab) or _find(data_dir, lab)
        if ip is None or lp is None:
            return None
        x = _read_idx_images(ip)
        y = _read_idx_labels(lp)
        if x is None or y is None:
            return None
        parts[split] = (x, y)
    return parts["train"], parts["test"]


def _load_cifar(data_dir: str, name: str):
    """CIFAR-10/100 from the standard python-pickle archives. Only files the
    user placed under ``data_dir`` are read."""

    def unpickle(path):
        with open(path, "rb") as f:
            return pickle.load(f, encoding="latin1")

    def to_nhwc(flat: np.ndarray) -> np.ndarray:
        return flat.reshape(-1, 3, 32, 32).transpose(0, 2, 3, 1).astype(np.uint8)

    if name == "cifar10":
        root = os.path.join(data_dir, "cifar-10-batches-py")
        if not os.path.isdir(root):
            return None
        xs, ys = [], []
        for i in range(1, 6):
            p = os.path.join(root, f"data_batch_{i}")
            if not os.path.exists(p):
                return None
            d = unpickle(p)
            xs.append(to_nhwc(np.asarray(d["data"])))
            ys.append(np.asarray(d["labels"], np.int32))
        tp = os.path.join(root, "test_batch")
        if not os.path.exists(tp):
            return None
        td = unpickle(tp)
        return (
            (np.concatenate(xs), np.concatenate(ys)),
            (to_nhwc(np.asarray(td["data"])), np.asarray(td["labels"], np.int32)),
        )

    root = os.path.join(data_dir, "cifar-100-python")
    if not os.path.isdir(root):
        return None
    try:
        tr = unpickle(os.path.join(root, "train"))
        te = unpickle(os.path.join(root, "test"))
    except OSError:
        return None
    return (
        (to_nhwc(np.asarray(tr["data"])), np.asarray(tr["fine_labels"], np.int32)),
        (to_nhwc(np.asarray(te["data"])), np.asarray(te["fine_labels"], np.int32)),
    )


def load_dataset(
    name: str,
    data_dir: str = "./data",
    n_train: Optional[int] = None,
    n_test: Optional[int] = None,
) -> DatasetBundle:
    """Load a vision dataset from ``data_dir``, falling back to the synthetic
    stand-in when files are missing. ``n_train``/``n_test`` truncate (real)
    or size (synthetic) the splits."""
    if name not in _SHAPES:
        raise ValueError(f"unknown dataset {name!r}; choose from {sorted(_SHAPES)}")
    loaded = (
        _load_fashion_mnist(data_dir) if name == "mnist" else _load_cifar(data_dir, name)
    )
    if loaded is None:
        full_tr, full_te = _FULL_SIZES[name]
        return synthetic_dataset(
            name,
            n_train=n_train or full_tr,
            n_test=n_test or full_te,
        )
    (train_x, train_y), (test_x, test_y) = loaded
    if n_train is not None:
        train_x, train_y = train_x[:n_train], train_y[:n_train]
    if n_test is not None:
        test_x, test_y = test_x[:n_test], test_y[:n_test]
    mean, std = NORM_STATS[name]
    return DatasetBundle(
        name=name,
        train_x=np.ascontiguousarray(train_x),
        train_y=np.ascontiguousarray(train_y.astype(np.int32)),
        test_x=np.ascontiguousarray(test_x),
        test_y=np.ascontiguousarray(test_y.astype(np.int32)),
        num_classes=_NUM_CLASSES[name],
        mean=mean,
        std=std,
        synthetic=False,
    )
