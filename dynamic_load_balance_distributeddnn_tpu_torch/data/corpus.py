"""Word-level LM corpus and bptt windowing — a copy of the JAX package's
``data/corpus.py`` (reference: dataloader.py:120-173, utils.py:7-10).

Same tokenization contract as the reference: each line is split on
whitespace and terminated with ``<eos>`` (dataloader.py:141-148), the vocab
is built in order of first appearance, and ``batchify`` folds the token
stream column-major so column j holds a contiguous chunk (dataloader.py:
166-173).

Deviations, both deliberate (SURVEY §7.3):
- the reference's wikitext-2 ships without train.txt (.MISSING_LARGE_BLOBS:1)
  yet hardcodes the full-corpus vocab size (dbs.py:337) — here the vocab is
  always *derived* from whatever files exist, train falls back to valid, and
  a fully synthetic corpus stands in when nothing is on disk (zero-egress
  environments), each fallback recorded in ``notes``;
- windows are pre-materialized as static-shape ``[windows, bsz, bptt]``
  arrays with a token mask (short final window ⇒ masked tail), so every LM
  step sees the same sequence length (the port keeps the JAX layout so the
  two packages' windows compare element for element).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

SYNTH_VOCAB = 2000
SYNTH_TRAIN_TOKENS = 200_000
SYNTH_EVAL_TOKENS = 20_000


class Dictionary:
    """Insertion-ordered word↔id map (reference Dictionary,
    dataloader.py:122-133)."""

    def __init__(self) -> None:
        self.word2idx: Dict[str, int] = {}
        self.idx2word: List[str] = []

    def add_word(self, word: str) -> int:
        if word not in self.word2idx:
            self.word2idx[word] = len(self.idx2word)
            self.idx2word.append(word)
        return self.word2idx[word]

    def __len__(self) -> int:
        return len(self.idx2word)


def _read_lines(path: str) -> Optional[List[str]]:
    if not os.path.exists(path):
        return None
    with open(path, "r", encoding="utf-8") as f:
        return f.readlines()


class Corpus:
    """Tokenized train/valid/test streams with a shared vocab.

    Attributes: ``train``/``valid``/``test`` (int32 token streams),
    ``ntokens`` (vocab size), ``synthetic`` (no files found), ``notes``
    (human-readable fallbacks taken)."""

    def __init__(self, path: str) -> None:
        self.dictionary = Dictionary()
        self.notes: List[str] = []
        splits: Dict[str, Optional[List[str]]] = {
            name: _read_lines(os.path.join(path, f"{name}.txt"))
            for name in ("train", "valid", "test")
        }
        if all(v is None for v in splits.values()):
            self._init_synthetic(path)
            return
        self.synthetic = False
        # vocab in order of first appearance, train -> valid -> test
        for name in ("train", "valid", "test"):
            lines = splits[name]
            if lines is None:
                continue
            for line in lines:
                for word in line.split() + ["<eos>"]:
                    self.dictionary.add_word(word)
        streams: Dict[str, Optional[np.ndarray]] = {
            name: self._tokenize(lines) if lines is not None else None
            for name, lines in splits.items()
        }
        if streams["train"] is None:
            fallback = "valid" if streams["valid"] is not None else "test"
            self.notes.append(
                f"train.txt missing under {path!r} (as in the reference checkout, "
                f".MISSING_LARGE_BLOBS:1); using {fallback}.txt as the train stream"
            )
            streams["train"] = streams[fallback]
        for name in ("valid", "test"):
            if streams[name] is None:
                other = "test" if name == "valid" else "valid"
                src = streams[other] if streams[other] is not None else streams["train"]
                self.notes.append(f"{name}.txt missing; substituting {other or 'train'}")
                streams[name] = src
        self.train: np.ndarray = streams["train"]
        self.valid: np.ndarray = streams["valid"]
        self.test: np.ndarray = streams["test"]

    def _tokenize(self, lines: List[str]) -> np.ndarray:
        ids: List[int] = []
        w2i = self.dictionary.word2idx
        for line in lines:
            for word in line.split() + ["<eos>"]:
                ids.append(w2i[word])
        return np.asarray(ids, dtype=np.int32)

    def _init_synthetic(self, path: str) -> None:
        """Deterministic Zipf-ish token streams: structured enough that a
        small LM's loss moves, hermetic for zero-egress test environments."""
        self.synthetic = True
        self.notes.append(
            f"no corpus files under {path!r}; using the synthetic stand-in "
            f"({SYNTH_VOCAB}-word vocab, {SYNTH_TRAIN_TOKENS} train tokens)"
        )
        for i in range(SYNTH_VOCAB):
            self.dictionary.add_word(f"w{i}")
        rng = np.random.RandomState(1234)

        def stream(n: int) -> np.ndarray:
            # heavy-tailed unigram draw + a short-range bigram rule
            ranks = np.arange(1, SYNTH_VOCAB + 1, dtype=np.float64)
            probs = (1.0 / ranks) / np.sum(1.0 / ranks)
            toks = rng.choice(SYNTH_VOCAB, size=n, p=probs).astype(np.int32)
            # every 3rd token follows its predecessor deterministically,
            # giving the model something learnable
            toks[2::3] = (toks[1::3][: len(toks[2::3])] * 7 + 13) % SYNTH_VOCAB
            return toks

        self.train = stream(SYNTH_TRAIN_TOKENS)
        self.valid = stream(SYNTH_EVAL_TOKENS)
        self.test = stream(SYNTH_EVAL_TOKENS)

    @property
    def ntokens(self) -> int:
        return len(self.dictionary)


def batchify(stream: np.ndarray, bsz: int) -> np.ndarray:
    """Fold a token stream into ``[nbatch, bsz]``, column-major: column j is a
    contiguous chunk of the stream (reference batchify, dataloader.py:166-173).
    Trailing tokens that don't fill a row are trimmed."""
    stream = np.asarray(stream)
    nbatch = len(stream) // bsz if bsz > 0 else 0
    if nbatch == 0:
        return np.zeros((0, max(bsz, 0)), dtype=stream.dtype)
    return stream[: nbatch * bsz].reshape(bsz, nbatch).T.copy()


def bptt_windows(
    data: np.ndarray, bptt: int, pad_bsz: Optional[int] = None
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Slice batchified data into static-shape next-token windows.

    Returns ``(x, y, mask)`` each ``[windows, bsz, bptt]``: ``x[w, b, t] =
    data[w*bptt + t, b]`` with ``y`` shifted one row ahead (the reference's
    get_batch target, utils.py:7-10) and ``mask`` marking real tokens —
    the final short window (seq = nbatch-1-i) is zero-padded and masked.
    ``pad_bsz`` pads the column axis (masked) up to a bucketed width."""
    nbatch, bsz = data.shape
    out_bsz = bsz if pad_bsz is None else max(pad_bsz, bsz)
    nwin = max(-(-(nbatch - 1) // bptt), 0) if nbatch > 1 else 0
    x = np.zeros((nwin, out_bsz, bptt), dtype=data.dtype)
    y = np.zeros((nwin, out_bsz, bptt), dtype=data.dtype)
    m = np.zeros((nwin, out_bsz, bptt), dtype=np.float32)
    for wi in range(nwin):
        i = wi * bptt
        seq = min(bptt, nbatch - 1 - i)
        x[wi, :bsz, :seq] = data[i : i + seq].T
        y[wi, :bsz, :seq] = data[i + 1 : i + 1 + seq].T
        m[wi, :bsz, :seq] = 1.0
    return x, y, m
