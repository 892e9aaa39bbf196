"""Sequence parallelism of the port across gloo ranks (``parallel/ring.py``,
``parallel/ulysses.py``, ``parallel/seq_parallel.py``,
``train/sp_engine.py``) against the JAX package on as many CPU devices.

- **Attention**: on 2 and 4 ranks, ``ring_self_attention`` and
  ``ulysses_self_attention`` (the local attention plain, and on K3's plain
  version, ``use_flash``), causal and not, on each rank's block of the same
  ``q, k, v``, against the JAX ``make_ring_attention_fn`` /
  ``make_ulysses_attention_fn`` on a mesh of the first ``n`` CPU devices:
  outputs within atol 2e-5, the gradients of ``sum(out * g)`` within atol
  5e-5 (the JAX tests' tolerances, ``tests/test_ring_attention.py``,
  ``tests/test_ulysses.py``).
- **Value and gradient**: ``seq_parallel_value_and_grad(train=False)`` of
  the ring and the Ulysses LM against the JAX
  ``make_seq_parallel_value_and_grad``, weights bridged from the flax tree:
  the loss within rtol 1e-5, the gradients within atol 5e-4
  (``tests/test_seq_parallel_lm.py``).
- **The trainer**: ``SeqParallelLMTrainer`` at the reference's full width
  on the tiny corpus, dropout 0, from the JAX trainer's weights, against
  the JAX ``SeqParallelLMTrainer`` with its ``data_mesh`` on ``n`` devices
  (ring on 4 ranks, Ulysses on 2): train and validation losses within rtol
  1e-4 after 2 epochs, the recorder's series and file name the JAX
  trainer's.
- **Dropout on** (0.2): two runs are bit for bit, the ranks end with equal
  parameters, the losses are finite and fall.
- **The JAX contracts** raise with the JAX messages: ``bptt % n``, Ulysses
  with 2 heads on 4 ranks, a model other than the transformer.

The JAX references and the ranks' runs are made once a session
(``computed_once``), however many pytest-xdist workers run these tests.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.sp_engine as jax_sp
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.models import build_model as jax_build_model
from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import data_mesh as jax_data_mesh
from dynamic_load_balance_distributeddnn_tpu.parallel.ring import make_ring_attention_fn
from dynamic_load_balance_distributeddnn_tpu.parallel.seq_parallel import (
    make_seq_parallel_value_and_grad,
    shard_tokens,
)
from dynamic_load_balance_distributeddnn_tpu.parallel.ulysses import make_ulysses_attention_fn
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.train.sp_engine import SeqParallelLMTrainer
from tests._torch_dist_helpers import computed_once, launch
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus

B, H, T_LOCAL, D = 2, 4, 8, 8
ATTN_CASES = [(mode, causal, flash) for mode, flash in (("ring", False), ("ulysses", False),
                                                         ("ulysses", True))
              for causal in (False, True)]
DIMS = dict(ntoken=64, ninp=32, nhead=4, nhid=48, nlayers=2, dropout=0.0)
LM_B, LM_T = 2, 32
TRAIN = {2: "ulysses", 4: "ring"}  # the trainer against JAX: ranks -> mode


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=2, batch_size=4, learning_rate=0.5, epoch_size=2,
              dataset="wikitext2", model="transformer", seed=1234, bptt=16, n_train=1600,
              lm_data_dir=str(tmp / "corpus"),
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _attn_inputs():
    rng = np.random.RandomState(0)
    return {x: rng.randn(B, H, 4 * T_LOCAL, D).astype(np.float32) for x in "qkvg"}


def _jax_attention(n: int, inputs, mode: str, causal: bool):
    """The JAX function on the first ``n`` CPU devices over the first ``n *
    T_LOCAL`` positions: the output and the gradients of ``sum(out * g)``."""
    mesh = jax_data_mesh(jax.devices()[:n])
    make = make_ring_attention_fn if mode == "ring" else make_ulysses_attention_fn
    fn = make(mesh, causal=causal)
    q, k, v, g = (jnp.asarray(inputs[x][:, :, : n * T_LOCAL]) for x in "qkvg")
    out = fn(q, k, v)
    grads = jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * g), argnums=(0, 1, 2))(q, k, v)
    return np.asarray(out), [np.asarray(x) for x in grads]


def _lm_inputs():
    rng = np.random.RandomState(2)
    return (rng.randint(0, DIMS["ntoken"], (LM_B, LM_T)).astype(np.int32),
            rng.randint(0, DIMS["ntoken"], (LM_B, LM_T)).astype(np.int32))


def _port_lm_state(params, dims) -> dict:
    return params_from_flax(params, build_model("transformer", **dims))


def _jax_trainers(tmp) -> dict:
    """The JAX ``SeqParallelLMTrainer`` for each of ``TRAIN``, its mesh on
    ``n`` devices, dropout 0: its initial flax parameters and its series."""
    from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus

    out = {}
    for n, mode in TRAIN.items():
        mp = pytest.MonkeyPatch()
        mp.setattr(jax_sp, "DROPOUT", 0.0)
        mp.setattr(jax_sp, "data_mesh", lambda n=n: jax_data_mesh(jax.devices()[:n]))
        try:
            tr = jax_sp.SeqParallelLMTrainer(
                JaxConfig(**_kw(tmp, f"jax{n}", world_size=n, seq_parallel=mode)),
                corpus=JaxCorpus(str(tmp / "corpus")), log_to_file=False)
            init = jax.tree_util.tree_map(np.asarray, tr.state.params)
            out[n] = {"init": init, "data": {k: list(v) for k, v in tr.run().data.items()}}
        finally:
            mp.undo()
    return out


def _jax_value_and_grad(lm_params, n: int, mode: str):
    mesh = jax_data_mesh(jax.devices()[:n])
    module = jax_build_model("transformer", **DIMS, seq_axis="data", sp_mode=mode).module
    tokens, targets = (jnp.asarray(a) for a in _lm_inputs())
    loss, grads = make_seq_parallel_value_and_grad(mesh, module)(
        lm_params, shard_tokens(mesh, tokens), shard_tokens(mesh, targets))
    return float(loss), _port_lm_state(jax.tree_util.tree_map(np.asarray, grads), DIMS)


def _train_dims(ntoken):
    t = SeqParallelLMTrainer
    return dict(ntoken=ntoken, ninp=t.EMSIZE, nhead=t.NHEAD, nhid=t.NHID, nlayers=t.NLAYERS,
                dropout=0.0)


def _world(tmp, jax_trainers, lm_params, n: int):
    from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus

    corpus = str(tmp / "corpus")
    tokens, targets = _lm_inputs()
    ntoken = Corpus(corpus).ntokens
    jobs = {
        "attn": dict({x: a[:, :, : n * T_LOCAL] for x, a in _attn_inputs().items()},
                     kind="sp_attn", cases=ATTN_CASES),
        "grad": {"kind": "sp_grad", "dims": DIMS, "state": _port_lm_state(lm_params, DIMS),
                 "tokens": tokens, "targets": targets, "modes": ["ring", "ulysses"]},
        "train": {"kind": "sp_train", "corpus": corpus, "dropout": 0.0,
                  "state": _port_lm_state(jax_trainers[n]["init"], _train_dims(ntoken)),
                  "cfg": _kw(tmp / f"world{n}", "train", world_size=n, seq_parallel=TRAIN[n])},
    }
    if n == 2:
        for i in (1, 2):  # dropout on, twice
            jobs[f"drop{i}"] = {"kind": "sp_train", "corpus": corpus, "dropout": 0.2,
                                "cfg": _kw(tmp / "world2", f"drop{i}", seq_parallel="ring")}
    else:
        jobs["contracts"] = {"kind": "sp_contracts", "corpus": corpus,
                             "cfg": _kw(tmp / "world4", "bad", world_size=4)}
    return launch(n, jobs, tmp / f"world{n}", timeout=300)


def _jax_contracts(tmp) -> dict:
    """The JAX trainer's messages for ``bptt`` 18 and Ulysses' 2 heads on 4
    devices, and for a vision model."""
    from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus

    out = {}
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_sp, "data_mesh", lambda: jax_data_mesh(jax.devices()[:4]))
    try:
        for name, over in (("bptt", {"bptt": 18, "seq_parallel": "ring"}),
                           ("ulysses", {"seq_parallel": "ulysses"})):
            try:
                jax_sp.SeqParallelLMTrainer(JaxConfig(**_kw(tmp, "jbad", world_size=4, **over)),
                                            corpus=JaxCorpus(str(tmp / "corpus")),
                                            log_to_file=False)
            except ValueError as e:
                out[name] = ("ValueError", str(e))
    finally:
        mp.undo()
    try:
        jax_sp.SeqParallelLMTrainer(JaxConfig(**_vision_kw(tmp)), corpus=None, log_to_file=False)
    except ValueError as e:
        out["vision"] = str(e)
    return out


def _vision_kw(tmp):
    return _kw(tmp, "vision", model="mnistnet", dataset="mnist", seq_parallel="ring")


def _compute(tmp) -> dict:
    """Every run the tests read: the JAX references (attention, value and
    gradient, the trainers, the contracts' messages) and the 2-rank and
    4-rank worlds."""
    make_tiny_corpus(tmp / "corpus")
    single = jax_build_model("transformer", **DIMS).module
    lm_params = single.init({"params": jax.random.PRNGKey(0)},
                            jnp.asarray(_lm_inputs()[0]), train=False)
    jax_trainers = _jax_trainers(tmp)
    inputs = _attn_inputs()
    return {
        "jax_attn": {(n, mode, causal): _jax_attention(n, inputs, mode, causal)
                     for n in (2, 4) for mode in ("ring", "ulysses") for causal in (False, True)},
        "jax_grad": {(n, mode): _jax_value_and_grad(lm_params, n, mode)
                     for n in (2, 4) for mode in ("ring", "ulysses")},
        "jax_train": {n: t["data"] for n, t in jax_trainers.items()},
        "jax_contracts": _jax_contracts(tmp),
        "world2": _world(tmp, jax_trainers, lm_params, 2),
        "world4": _world(tmp, jax_trainers, lm_params, 4),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "seq_parallel", _compute)


# ---------------------------------------------------------------- attention


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode,causal,flash", ATTN_CASES)
def test_attention_and_its_gradients_equal_the_jax_function(runs, n, mode, causal, flash):
    want, grads = runs["jax_attn"][(n, mode, causal)]
    for rank, out in enumerate(runs[f"world{n}"]):
        got = out["attn"][(mode, causal, flash)]
        sl = slice(rank * T_LOCAL, (rank + 1) * T_LOCAL)
        np.testing.assert_allclose(got["o"].numpy(), want[:, :, sl], atol=2e-5, rtol=0)
        for name, g in zip(("dq", "dk", "dv"), grads):
            np.testing.assert_allclose(got[name].numpy(), g[:, :, sl], atol=5e-5, rtol=0,
                                       err_msg=name)


# ------------------------------------------------------- value and gradient


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_value_and_grad_equal_the_jax_function(runs, n, mode):
    loss, want = runs["jax_grad"][(n, mode)]
    for out in runs[f"world{n}"]:
        got = out["grad"][mode]
        assert got["loss"] == pytest.approx(loss, rel=1e-5)
        for k, g in want.items():
            np.testing.assert_allclose(got["grads"][k].numpy(), g.numpy(), atol=5e-4, rtol=0,
                                       err_msg=k)


# ------------------------------------------------------------------ trainer


@pytest.mark.parametrize("n", sorted(TRAIN))
def test_trainer_follows_the_jax_trainer(runs, n):
    outs, jdata = runs[f"world{n}"], runs["jax_train"][n]
    for out in outs:
        data = out["train"]["data"]
        np.testing.assert_allclose(data["train_loss"], jdata["train_loss"], rtol=1e-4)
        np.testing.assert_allclose(data["val_loss"], jdata["val_loss"], rtol=1e-4)
        assert data["accuracy"] == [1.0 - v for v in data["val_loss"]]
        assert data["partition"] == jdata["partition"] == [[1.0 / n] * n] * 2
        assert [len(w) for w in data["node_time"]] == [n, n]
        assert len(data["tokens_per_s"]) == 2
        meta = out["train"]["meta"]
        assert meta["wall_excludes_probes"] and "eager" in meta["steps"]
        assert meta["paths"] == [f"seq_parallel_{TRAIN[n]}"] * 2
    assert len({o["train"]["report"]["param_sha256"] for o in outs}) == 1


def test_dropout_runs_repeat_and_the_ranks_agree(runs):
    world2 = runs["world2"]
    for out in world2:
        a, b = out["drop1"], out["drop2"]
        assert a["data"]["train_loss"] == b["data"]["train_loss"]
        for k, p in a["params"].items():
            assert torch.equal(p, b["params"][k]), k
        losses = a["data"]["train_loss"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert world2[0]["drop1"]["report"]["param_sha256"] == world2[1]["drop1"]["report"]["param_sha256"]


def test_the_jax_contracts_raise_with_the_jax_messages(runs, tmp_path):
    """On 4 ranks: ``bptt`` 18 does not divide by 4, and Ulysses' 2 heads do
    not either; in one process, a model other than the transformer."""
    want = runs["jax_contracts"]
    for rank in range(4):
        got = runs["world4"][rank]["contracts"]
        assert got == {k: want[k] for k in ("bptt", "ulysses")}
    with pytest.raises(ValueError) as got_e:
        SeqParallelLMTrainer(Config(**_vision_kw(tmp_path)), device="cpu", log_to_file=False)
    assert str(got_e.value) == want["vision"]
