"""The port's copy of the LM corpus (``data/corpus.py``) against the JAX
package's: vocabulary, token streams, fallbacks and their notes, ``batchify``
and ``bptt_windows`` are equal bit for bit, on the committed wikitext-2
files, on the tests' tiny corpus, and on the synthetic stand-in.
"""

import shutil
from pathlib import Path

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.data import corpus as jax_corpus
from dynamic_load_balance_distributeddnn_tpu_torch.data import corpus
from dynamic_load_balance_distributeddnn_tpu_torch.obs import MetricsRecorder
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus

WIKITEXT2 = Path(__file__).resolve().parents[1] / "rnn_data" / "wikitext-2"


def assert_same_corpus(got, want):
    assert got.dictionary.idx2word == want.dictionary.idx2word
    assert got.dictionary.word2idx == want.dictionary.word2idx
    assert got.ntokens == want.ntokens
    assert got.synthetic == want.synthetic
    assert got.notes == want.notes
    for split in ("train", "valid", "test"):
        a, b = getattr(got, split), getattr(want, split)
        assert a.dtype == b.dtype and np.array_equal(a, b), split


def test_wikitext2_corpus_equals_the_jax_corpus():
    got, want = corpus.Corpus(str(WIKITEXT2)), jax_corpus.Corpus(str(WIKITEXT2))
    assert_same_corpus(got, want)
    # the committed files: valid.txt stands in for the missing train.txt
    assert got.ntokens == 18_328 and len(got.train) == 217_646
    assert got.notes and "train.txt missing" in got.notes[0]


def test_tiny_corpus_equals_the_jax_corpus(tmp_path):
    want = make_tiny_corpus(tmp_path / "c")
    assert_same_corpus(corpus.Corpus(str(tmp_path / "c")), want)


@pytest.mark.parametrize("present", [(), ("valid", "test"), ("train",), ("test",), ("train", "valid")])
def test_fallbacks_and_their_notes_equal_the_jax_corpus(tmp_path, present):
    make_tiny_corpus(tmp_path / "all", lines=60)
    (tmp_path / "c").mkdir()
    for name in present:
        shutil.copy(tmp_path / "all" / f"{name}.txt", tmp_path / "c" / f"{name}.txt")
    got, want = corpus.Corpus(str(tmp_path / "c")), jax_corpus.Corpus(str(tmp_path / "c"))
    assert_same_corpus(got, want)
    assert got.synthetic == (present == ())


@pytest.mark.parametrize("n,bsz,bptt,pad_bsz", [
    (1000, 10, 35, None), (1000, 7, 16, 8), (203, 3, 5, 16), (80, 1, 35, None),
    (5, 10, 35, None), (0, 4, 35, 8), (36, 1, 35, None),
])
def test_batchify_and_bptt_windows_equal_the_jax_functions(n, bsz, bptt, pad_bsz):
    stream = np.random.RandomState(n).randint(0, 500, n).astype(np.int32)
    got = corpus.batchify(stream, bsz)
    want = jax_corpus.batchify(stream, bsz)
    assert got.dtype == want.dtype and np.array_equal(got, want)
    for a, b in zip(corpus.bptt_windows(got, bptt, pad_bsz=pad_bsz),
                    jax_corpus.bptt_windows(want, bptt, pad_bsz=pad_bsz)):
        assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)


def test_recorder_keeps_the_corpus_notes():
    rec = MetricsRecorder()
    rec.stamp_data_source(corpus.Corpus(str(WIKITEXT2)))
    assert rec.meta["synthetic"] is False
    assert rec.meta["data_notes"] == corpus.Corpus(str(WIKITEXT2)).notes
