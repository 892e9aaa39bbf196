"""The port's language-model path against the JAX package's, on the CPU.

- One elastic step of two workers with token batches, per-token weights and
  per-worker gradient clipping at 0.25, against the JAX ``StepLibrary``
  (``worker_step_first``/``worker_step_acc`` on a 1-device mesh, then
  ``combine_update``), on the same bridged small Transformer LM with dropout
  off: parameters within atol 1e-5, momentum buffers (the clipped, summed
  gradients) within the gradient tolerance 5e-4.
- ``LMTrainer``'s plans and windows equal the JAX ``LMTrainer``'s for the
  same shares and column counts.
- Both trainers run a small LM (EMSIZE 16) on the tiny corpus under the same
  ``timing_model`` and a 3:1 virtual straggler: the ``partition`` and
  ``node_time`` series are equal.
- The cli trains the LM on the CPU, writes the 9 series under the JAX file
  name with the corpus's fallback note, and skips a finished run.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.config import config_from_args as jax_args
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.models.transformer import TransformerLM as FlaxLM
from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import data_mesh, replicated_sharding
from dynamic_load_balance_distributeddnn_tpu.train.lm_engine import LMTrainer as JaxLMTrainer
from dynamic_load_balance_distributeddnn_tpu.train.state import (
    create_state,
    make_optimizer as jax_optimizer,
)
from dynamic_load_balance_distributeddnn_tpu.train.steps import (
    StepLibrary,
    shard_views,
    stack_partials,
)
from dynamic_load_balance_distributeddnn_tpu_torch import cli
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config, config_from_args
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus
from dynamic_load_balance_distributeddnn_tpu_torch.models.transformer import TransformerLM
from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels.xent import MAX_LOGITS
from dynamic_load_balance_distributeddnn_tpu_torch.train import lm_engine
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.state import make_optimizer
from dynamic_load_balance_distributeddnn_tpu_torch.train.steps import elastic_step, probe_grads
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus

LR = 0.5
SMALL = dict(ntoken=50, ninp=32, nhead=2, nhid=32, nlayers=2, dropout=0.0)
FACTORS = (3.0, 1.0, 1.0, 1.0)


def _token_batches(bptt=35):
    """Two workers' windows (3 and 5 columns), worker 1 with a short final
    window (masked tail), weights p_r / real tokens as ``_build_windows``."""
    rng = np.random.RandomState(4)
    out = []
    for cols, p_r, seq in ((3, 0.375, bptt), (5, 0.625, 20)):
        x = rng.randint(0, 50, (cols, bptt)).astype(np.int32)
        y = rng.randint(0, 50, (cols, bptt)).astype(np.int32)
        m = np.zeros((cols, bptt), np.float32)
        m[:, :seq] = 1.0
        out.append((x * m.astype(np.int32), y * m.astype(np.int32), m * np.float32(p_r / m.sum())))
    return out


@pytest.mark.parametrize("use_flash", [True, False], ids=["flash", "plain"])
def test_clipped_elastic_step_matches_step_library(use_flash):
    mesh = data_mesh([jax.devices()[0]])
    fmod = FlaxLM(**SMALL, use_flash=use_flash)
    tx = jax_optimizer(LR, 0.9)
    state = create_state(fmod, jnp.zeros((1, 35), jnp.int32), tx, seed=0,
                         sharding=replicated_sharding(mesh))
    lib = StepLibrary(ModelSpec("transformer", fmod, "logits", "tokens"), mesh, tx, grad_clip=0.25)
    model = TransformerLM(**SMALL, use_flash=use_flash)
    model.load_state_dict(params_from_flax(state.params, model))
    opt = make_optimizer(model.parameters(), LR, 0.9)

    data = _token_batches()
    key = jax.random.PRNGKey(0)
    view = shard_views(state.params, [jax.devices()[0]])[0]
    acc, aux0 = lib.worker_step_first(view, *data[0], key, jnp.int32(0))
    acc, aux1 = lib.worker_step_acc(view, acc, *data[1], key, jnp.int32(0))
    state = lib.combine_update(state, stack_partials([acc], mesh))

    batches = [(torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w)) for x, y, w in data]
    params = list(model.parameters())
    for b in batches:  # the clip binds: each worker's mean-loss gradient norm > 0.25
        g = probe_grads(model, params, b, grad_clip=0.0)
        norm = torch.linalg.vector_norm(torch.stack([t.norm() for t in g])) / b[2].sum()
        assert norm > 0.25, float(norm)
    loss_sum = elastic_step(model, opt, batches, grad_clip=0.25)
    np.testing.assert_allclose(float(loss_sum), float(aux0[1]) + float(aux1[1]), rtol=1e-5)

    want = params_from_flax(state.params, model)
    trace = params_from_flax(state.opt_state.inner_state[0].trace, model)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), atol=1e-5, err_msg=name)
        np.testing.assert_allclose(opt.state[p]["momentum_buffer"].numpy(), trace[name].numpy(),
                                   atol=5e-4, err_msg=name)


def test_probe_grads_are_the_clipped_worker_gradients():
    model = TransformerLM(**SMALL, use_flash=True)
    params = list(model.parameters())
    b = [torch.from_numpy(a) for a in _token_batches()[0]]
    raw = probe_grads(model, params, b)
    clipped = probe_grads(model, params, b, grad_clip=0.25)
    norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in raw])) / b[2].sum()
    for r, c in zip(raw, clipped):
        torch.testing.assert_close(c, r * (0.25 / norm), atol=1e-7, rtol=1e-5)
    assert all(p.grad is None for p in params)


# ---------------------------------------------------------------- trainers


class SmallJaxLM(JaxLMTrainer):
    EMSIZE = 16
    NHID = 16


class SmallLM(LMTrainer):
    EMSIZE = 16
    NHID = 16


def straggler_time(plan):
    """Deterministic compute model: time ∝ columns x steps, worker 0 three
    times slower."""
    return np.array([f * w.batch_size * w.steps * 1e-3 for f, w in zip(FACTORS, plan.workers)])


def _kw(tmp, tag):
    return dict(
        debug=True, world_size=4, batch_size=40, learning_rate=LR, epoch_size=3,
        dataset="wikitext2", model="transformer", bucket=4, bptt=16,
        straggler="3,1,1,1", fault_mode="virtual",
        log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"),
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("lm")
    jax_corpus = make_tiny_corpus(tmp / "corpus")
    jtr = SmallJaxLM(JaxConfig(**_kw(tmp, "jax")), bundle=jax_corpus,
                     timing_model=straggler_time, log_to_file=False)
    jrec = jtr.run()
    tr = SmallLM(Config(**_kw(tmp, "torch")), bundle=Corpus(str(tmp / "corpus")),
                 timing_model=straggler_time, device="cpu", log_to_file=False)
    rec = tr.run()
    return jtr, jrec, tr, rec


def test_partition_and_node_time_series_equal_the_jax_lm_trainer(runs):
    _, jrec, _, rec = runs
    assert rec.data["partition"] == jrec.data["partition"]
    assert rec.data["node_time"] == jrec.data["node_time"]
    assert rec.data["partition"][-1][0] < 0.25  # share moved off the straggler
    assert np.isfinite(rec.data["train_loss"]).all()
    assert rec.data["accuracy"] == [1.0 - v for v in rec.data["val_loss"]]


@pytest.mark.parametrize("shares,cols", [
    ([0.25, 0.25, 0.25, 0.25], [10, 10, 10, 10]),
    ([0.1, 0.3, 0.3, 0.3], [4, 12, 12, 12]),
    ([0.025, 0.325, 0.325, 0.325], [1, 13, 13, 13]),
    ([0.4, 0.2, 0.3, 0.1], [16, 8, 12, 4]),
])
def test_plans_and_windows_equal_the_jax_lm_trainer(runs, shares, cols):
    jtr, _, tr, _ = runs
    jtr.shares = tr.shares = np.array(shares)
    got = tr._build_plan(5, np.array(cols))
    want = jtr._build_plan(5, np.array(cols))
    assert got.num_steps == want.num_steps
    assert np.array_equal(got.batch_sizes, want.batch_sizes)
    for g, w in zip(got.workers, want.workers):
        assert (g.batch_size, g.padded_batch, g.steps) == (w.batch_size, w.padded_batch, w.steps)
        assert np.array_equal(g.indices, w.indices)
    for rank, w in enumerate(got.workers):
        jx = jtr._build_windows(want, rank, None)  # columns padded to the bucket
        padded = tr._build_windows(got, rank, pad_to=w.padded_batch)
        for a, b in zip(padded, jx):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        true_width = tr._build_windows(got, rank)
        for a, b in zip(true_width, jx):
            assert np.array_equal(a, b[:, : w.batch_size])
        assert not jx[2][:, w.batch_size :].any()  # the padding columns weigh 0


def test_validation_chunks_by_tokens_and_the_loss_does_not_move(runs, monkeypatch):
    """Validation's chunk holds the vision path's 1,024 rows, or the most
    rows whose logits one K2 call takes (``MAX_LOGITS``), at any bptt and
    the vocabularies of the committed wikitext-2 files, wikitext-2 and
    wikitext-103; chunks of 3 rows give the same loss as the default
    chunking."""
    assert lm_engine.eval_rows(35, 18_328) == 1024 and lm_engine.eval_rows(256, 18_328) == 457
    for ntoken in (18_328, 33_278, 267_735):
        for bptt in range(1, 4097):
            rows = lm_engine.eval_rows(bptt, ntoken)
            assert rows * bptt * ntoken <= MAX_LOGITS, (bptt, ntoken)
            assert rows == 1024 or (rows + 1) * bptt * ntoken > MAX_LOGITS, (bptt, ntoken)
    _, _, tr, _ = runs
    whole = tr.validate()
    monkeypatch.setattr(lm_engine, "MAX_LOGITS", 3 * tr.cfg.bptt * tr.corpus.ntokens)
    assert lm_engine.eval_rows(tr.cfg.bptt, tr.corpus.ntokens) == 3 < len(tr.eval_x)
    np.testing.assert_allclose(tr.validate(), whole, rtol=1e-6, atol=0)


def test_cli_trains_the_lm_and_records_the_corpus_note(tmp_path, capsys):
    make_tiny_corpus(tmp_path / "corpus")
    os.remove(tmp_path / "corpus" / "train.txt")  # valid.txt stands in, with a note
    argv = [
        "-m", "transformer", "-ds", "wikitext2", "-ws", "2", "-b", "8", "--bptt", "16",
        "-e", "2", "--grad_clip", "0.25", "--straggler", "3,1", "--fault_mode", "virtual",
        "--use_flash_attention", "true", "--lm_data_dir", str(tmp_path / "corpus"),
        "--log_dir", str(tmp_path / "logs"), "--stat_dir", str(tmp_path / "statis"),
    ]
    assert cli.main(argv, device="cpu") == 0
    cfg = config_from_args(argv)
    assert cfg.base_filename() == jax_args(argv).base_filename()
    stem = cfg.base_filename().format(0)
    with open(os.path.join(cfg.stat_dir, stem + ".json")) as f:
        saved = json.load(f)
    saved_npy = np.load(os.path.join(cfg.stat_dir, stem + ".npy"), allow_pickle=True).item()
    for k in SERIES:
        assert len(saved[k]) == 2 and len(saved_npy[k]) == 2, k
    assert np.isfinite(saved["train_loss"]).all() and np.isfinite(saved["val_loss"]).all()
    assert saved["accuracy"] == [1.0 - v for v in saved["val_loss"]]
    assert any("train.txt missing" in n for n in saved["_meta"]["data_notes"])
    capsys.readouterr()
    assert cli.main(argv, device="cpu") == 0
    assert "Had finished this experiment, skipping" in capsys.readouterr().out
