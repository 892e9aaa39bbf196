"""The port's language model across gloo ranks (``tests/_torch_dist_helpers.py``
worlds) against the JAX package's ``LMTrainer`` and against itself.

Every run: the Transformer LM at the reference's full width (EMSIZE 200, 2
heads, NHID 200, 2 layers) on the tiny corpus of ``tests/conftest.py``
(``make_tiny_corpus``, 50 words), B 16 columns, bptt 16, bucket 4, 2
epochs, dropout 0 on both sides (the ``DROPOUT`` class attribute), from
the JAX trainer's initial weights through ``bridge.py``, so no step draws
a random number.

- **Window-mode DBS against JAX**: ``-ws 2`` over 2 ranks against the JAX
  trainer at ``-gpu 0,1`` under the same 3:1 ``timing_model``: the
  partitions are equal and the train losses within rtol 1e-5.
- **Two ranks against one process**: the same run is bit for bit the port's
  one-process 2-worker run: parameters, momentum and every series (the
  per-worker clip, then a 2-way sum: one addition either way).
- **The fused paths**: ``--fused_dbs`` gives the JAX trainer's partitions;
  ``-dbs false --grad_accum 2`` (the columns split in two micro-batches, at
  the bucketed width, as the JAX package splits them) follows the JAX fused
  path within rtol 1e-5; ``_cap_b`` equals the JAX trainer's.
- **The int8 wire**: on the same LM gradients and keys, the port's
  ``--compress_grads int8`` combine and its ZeRO-1 twin give the JAX
  ``_compressed_psum`` and ``_zero1_update`` parameters bit for bit (the
  dither at each ``DenseGeneral`` element's flax position).
- **ZeRO-1**: ``--shard_update`` is bit for bit with the replicated update
  at 2 ranks; ZeRO-1 on the int8 wire with ``--grad_accum 2`` follows the
  JAX trainer at ``-gpu 0,1`` (a mean parameter difference under 1e-6,
  under 0.5 % of the parameters farther than 1e-5, losses within rtol
  1e-5), learns and keeps the ranks equal.
- **The tree**: ``--grad_comm hier --hier_hosts 2`` at 4 ranks (tree (2,
  2), int8 outer hop) ends within a mean parameter difference of 1e-5 of
  the JAX trainer at ``-gpu 0,1,2,3``.
- **Validation across ranks**: split by chunks (chunks of 3 rows here) over
  2 ranks, the validation loss is the one-process value bit for bit.

Every run is made once a session (``computed_once``), however many
pytest-xdist workers run these tests.
"""

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.train.lm_engine import LMTrainer as JaxLMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.train.lm_engine import LMTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.ops.kernels import xent
from dynamic_load_balance_distributeddnn_tpu_torch.train import lm_engine
from tests._torch_dist_helpers import (
    computed_once,
    launch,
    lm_trainer,
    straggler_time,
    train_outputs,
)
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_dist_engine import COMBINE_SEED, _combine_grads, _flat, _jax_combine, _tree

VARIANTS = {"psum8": {"compress": "int8"}, "zero1_8": {"compress": "int8", "shard_update": True}}
HIER_MEAN_ATOL = 1e-5
ZERO1C_MEAN_ATOL, ZERO1C_SHARE = 1e-6, 0.005  # the int8 wire + ZeRO-1 + accum against JAX


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=2, batch_size=16, learning_rate=0.1, epoch_size=2,
              dataset="wikitext2", model="transformer", seed=1234, bucket=4, bptt=16,
              n_train=2400, lm_data_dir=str(tmp / "corpus"),
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


JAX_RUNS = {  # name: (flags, timing model)
    "win": ({"device": [0, 1]}, "3,1"),
    "fdbs": ({"device": [0, 1], "fused_dbs": True}, "3,1"),
    "accum": ({"device": [0, 1], "dynamic_batch_size": False, "grad_accum": 2}, None),
    "zero1c": ({"device": [0, 1], "dynamic_batch_size": False, "grad_accum": 2,
                "compress_grads": "int8", "shard_update": True}, None),
    "hier": ({"device": [0, 1, 2, 3], "world_size": 4, "grad_comm": "hier", "hier_hosts": 2},
             "3,1,1,1"),
}


def _lm(ntoken: int):
    return build_model("transformer", ntoken=ntoken, ninp=LMTrainer.EMSIZE, nhead=LMTrainer.NHEAD,
                       nhid=LMTrainer.NHID, nlayers=LMTrainer.NLAYERS, dropout=0.0)


def _port_state(flat, ntoken: int) -> dict:
    return params_from_flax(_tree(flat), _lm(ntoken))


def _jax_runs(tmp, ntoken: int) -> dict:
    """The JAX ``LMTrainer`` on each of ``JAX_RUNS``, dropout 0, each in its
    own directories: its series, its final parameters (the port's state
    dict), its combine and its initial weights (flax paths)."""
    from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus

    mp = pytest.MonkeyPatch()
    mp.setattr(JaxLMTrainer, "DROPOUT", 0.0)
    out = {}
    try:
        for name, (over, timing) in JAX_RUNS.items():
            factors = None if timing is None else tuple(float(f) for f in timing.split(","))
            tr = JaxLMTrainer(JaxConfig(**_kw(tmp, "jax_" + name, **over)),
                              bundle=JaxCorpus(str(tmp / "corpus")),
                              timing_model=None if factors is None else straggler_time(factors),
                              log_to_file=False)
            init = {k: np.asarray(v) for k, v in _flat(tr.state.params).items()}
            rec = tr.run()
            out[name] = {"data": {k: list(v) for k, v in rec.data.items()}, "init": init,
                         "params": _port_state(_flat(tr.state.params), ntoken),
                         "grad_comm": tr.grad_comm}
    finally:
        mp.undo()
    return out


def _job(tmp, cfg, state, timing=None, **extra):
    return dict({"kind": "lm_train", "cfg": cfg, "state": state, "timing": timing,
                 "corpus": str(tmp / "corpus")}, **extra)


def _compute(tmp) -> dict:
    """Every run the tests read: the JAX trainers, the 2-rank and 4-rank
    worlds, the one-process run, the one-process validation in chunks of 3
    rows and the JAX combine of the LM gradients."""
    make_tiny_corpus(tmp / "corpus")
    ntoken = Corpus(str(tmp / "corpus")).ntokens
    jax_runs = _jax_runs(tmp, ntoken)
    init = jax_runs["win"]["init"]
    state = _port_state(init, ntoken)
    grads = _combine_grads(init)
    dbs = _kw(tmp, "dbs", device=[0, 0])
    off = _kw(tmp, "off", device=[0, 0], dynamic_batch_size=False)
    chunk3 = 3 * 16 * ntoken  # MAX_LOGITS for chunks of 3 rows
    jobs = {
        "win": _job(tmp, dbs, state, "3,1"),
        "fdbs": _job(tmp, dict(dbs, fused_dbs=True), state, "3,1"),
        "fused": _job(tmp, off, state),
        "accum": _job(tmp, dict(off, grad_accum=2), state),
        "zero1": _job(tmp, dict(off, shard_update=True), state),
        "zero1c": _job(tmp, dict(off, grad_accum=2, compress_grads="int8", shard_update=True),
                       state),
        "val3": _job(tmp, _kw(tmp, "val3", device=[0, 0], epoch_size=1), state, "3,1",
                     max_logits=chunk3),
        "comb": {"kind": "combine", "seed": COMBINE_SEED, "variants": VARIANTS,
                 "grads": [_port_state(g, ntoken) for g in grads],
                 "model": ("transformer", {"ntoken": ntoken, "dropout": 0.0})},
    }
    world2 = launch(2, jobs, tmp / "world2", timeout=300)
    over, timing = JAX_RUNS["hier"]
    hier = _kw(tmp, "hier4", **dict(over, device=[0, 0, 0, 0]))
    world4 = launch(4, {"hier": _job(tmp, hier, state, timing)}, tmp / "world4", timeout=300)
    tr = lm_trainer(_job(tmp, _kw(tmp, "one", device=[0, 0]), state, "3,1"))
    tr.run()
    one = train_outputs(tr)
    val = lm_trainer(_job(tmp, _kw(tmp, "val1", device=[0, 0], epoch_size=1), state, "3,1",
                          max_logits=chunk3))
    try:
        val.model.load_state_dict(world2[0]["val3"]["params"])
        val1 = {"rows": len(val.eval_x), "validate": val.validate()}
    finally:
        lm_engine.MAX_LOGITS = xent.MAX_LOGITS
    want = _jax_combine(grads)
    combine = {v: _port_state(_flat(want[v]), ntoken) for v in VARIANTS}
    return {"jax": jax_runs, "world2": world2, "world4": world4, "one": one, "val1": val1,
            "combine": combine}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "lm_dist", _compute)


@pytest.fixture(scope="module")
def world2(runs):
    return runs["world2"]


# ------------------------------------------------------------ window mode


def test_lm_window_mode_follows_the_jax_trainer(runs, world2):
    jdata = runs["jax"]["win"]["data"]
    for out in (o["win"] for o in world2):
        assert out["mode"] == "window" and out["meta"]["paths"] == ["elastic"] * 2
        assert out["data"]["partition"] == jdata["partition"]
        np.testing.assert_allclose(out["data"]["train_loss"], jdata["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(out["data"]["val_loss"], jdata["val_loss"], rtol=1e-5)
    assert world2[0]["win"]["data"]["partition"][-1][0] < 0.5


def test_lm_two_ranks_equal_one_process_bit_for_bit(runs, world2):
    two, one = world2[0]["win"], runs["one"]
    assert one["mode"] == "scan"
    for k, p in one["params"].items():
        assert torch.equal(p, two["params"][k]), k
        assert torch.equal(one["momentum"][k], two["momentum"][k]), k
    for k in ("partition", "node_time", "train_loss", "val_loss", "accuracy"):
        assert two["data"][k] == one["data"][k], k


def test_lm_ranks_end_equal(world2):
    for name in set(world2[0]) - {"comb"}:
        r0, r1 = world2[0][name]["report"], world2[1][name]["report"]
        assert r0["param_sha256"] == r1["param_sha256"], name
        assert r0["workers"] == [0] and r1["workers"] == [1]


def test_lm_validation_across_ranks_is_the_one_process_value(runs, world2):
    """Chunks of 3 rows (``MAX_LOGITS`` cut to fit them) split over 2 ranks:
    the loss is the one-process value, from the same parameters."""
    got = world2[0]["val3"]["validate"]
    assert got == world2[1]["val3"]["validate"]
    assert runs["val1"]["rows"] > 6  # several chunks on each rank
    assert got == runs["val1"]["validate"]


# ------------------------------------------------------------- fused paths


def test_lm_fused_dbs_partitions_equal_the_jax_trainer(runs, world2):
    jdata = runs["jax"]["fdbs"]["data"]
    for out in (o["fdbs"] for o in world2):
        assert out["meta"]["paths"] == ["fused_dbs"] * 2
        assert out["data"]["partition"] == jdata["partition"]
        np.testing.assert_allclose(out["data"]["train_loss"], jdata["train_loss"], rtol=1e-5)
    assert world2[0]["fdbs"]["meta"]["supersteps"][-1]["keys"] == 1  # the capacity width


def test_lm_grad_accum_follows_the_jax_fused_path(runs, world2):
    jdata = runs["jax"]["accum"]["data"]
    for out in (o["accum"] for o in world2):
        assert out["meta"]["paths"] == ["fused"] * 2
        np.testing.assert_allclose(out["data"]["train_loss"], jdata["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(out["data"]["val_loss"], jdata["val_loss"], rtol=1e-5)


@pytest.mark.parametrize("over", [
    {}, {"batch_size": 80, "world_size": 4}, {"capacity_factor": 1.5, "world_size": 4},
    {"bucket": 8, "batch_size": 20},
])
def test_lm_cap_b_equals_the_jax_trainer(over, tmp_path):
    from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus

    make_tiny_corpus(tmp_path / "corpus")
    kw = _kw(tmp_path, "cap", **over)
    port = LMTrainer(Config(**kw), bundle=Corpus(str(tmp_path / "corpus")), device="cpu",
                     log_to_file=False)
    jtr = JaxLMTrainer(JaxConfig(**kw), bundle=JaxCorpus(str(tmp_path / "corpus")),
                       log_to_file=False)
    assert port._cap_b == jtr._cap_b


# ------------------------------------------------------- wire and ZeRO-1


def test_lm_int8_combine_is_the_jax_combine_bit_for_bit(runs, world2):
    """On the same LM gradients and keys the port's int8 combine and its
    ZeRO-1 twin give the JAX package's parameters bit for bit."""
    for variant, exp in runs["combine"].items():
        assert all(float(v.abs().max()) > 0 for v in exp.values())
        for rank in (0, 1):
            got = world2[rank]["comb"][variant]
            for k, v in exp.items():
                assert torch.equal(got[k], v), (variant, rank, k)


def test_lm_shard_update_is_bit_for_bit_with_the_replicated_update(world2):
    for rank in (0, 1):
        z, r = world2[rank]["zero1"], world2[rank]["fused"]
        for k, p in r["params"].items():
            assert torch.equal(z["params"][k], p), (rank, k)
        comb = z["meta"]["combine"]
        assert comb["shard_update"] and 2 * comb["momentum_chunk_elems"] == comb["padded_elems"]
        assert not z["momentum"]


def test_lm_zero1_on_the_int8_wire_with_grad_accum_follows_the_jax_trainer(runs, world2):
    """``-dbs false --grad_accum 2 --compress_grads int8 --shard_update``
    over 2 ranks against the JAX trainer at ``-gpu 0,1``. A code is a
    floor, so where the two frameworks' gradients differ in their last bits
    an element's code now and then lands one step apart and later steps
    carry that on: the test bounds the mean parameter difference and the
    share of parameters farther than 1e-5 from JAX's. Measured (CPU): 1.6e-8
    and 0.066 %, the train and validation losses within 1.1e-7 relative."""
    want, jdata = runs["jax"]["zero1c"]["params"], runs["jax"]["zero1c"]["data"]
    for out in (o["zero1c"] for o in world2):
        assert out["meta"]["paths"] == ["fused"] * 2
        d = torch.cat([(out["params"][k] - want[k]).abs().flatten() for k in want])
        assert float(d.mean()) < ZERO1C_MEAN_ATOL, float(d.mean())
        assert float((d > 1e-5).float().mean()) < ZERO1C_SHARE, float((d > 1e-5).float().mean())
        np.testing.assert_allclose(out["data"]["train_loss"], jdata["train_loss"], rtol=1e-5)
        np.testing.assert_allclose(out["data"]["val_loss"], jdata["val_loss"], rtol=1e-5)


def test_lm_zero1_on_the_int8_wire_with_grad_accum_learns(world2):
    out = world2[0]["zero1c"]
    losses = out["data"]["train_loss"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert out["meta"]["combine"]["compress_grads"] == "int8"
    np.testing.assert_allclose(losses, world2[0]["fused"]["data"]["train_loss"], rtol=0.08)
    assert out["data"]["comm_bytes_ici"][0] * 2 == world2[0]["fused"]["data"]["comm_bytes_ici"][0]


# ------------------------------------------------------------------ tree


def test_lm_hier_on_four_ranks_follows_the_jax_trainer(runs):
    jax_hier = runs["jax"]["hier"]
    assert jax_hier["grad_comm"] == "hier"
    want, jdata = jax_hier["params"], jax_hier["data"]
    for out in (o["hier"] for o in runs["world4"]):
        assert out["meta"]["grad_comm"] == "hier"
        assert out["meta"]["grad_comm_levels"] == [["host", 2], ["device", 2]]
        assert out["meta"]["grad_comm_wires"] == ["int8", "fp32"]
        assert out["data"]["partition"] == jdata["partition"]
        d = torch.cat([(out["params"][k] - want[k]).abs().flatten() for k in want])
        assert float(d.mean()) < HIER_MEAN_ATOL, float(d.mean())
        assert out["data"]["comm_bytes_ici"] == jdata["comm_bytes_ici"]
        assert out["data"]["comm_bytes_dcn"] == jdata["comm_bytes_dcn"]
    assert len({o["hier"]["report"]["param_sha256"] for o in runs["world4"]}) == 1

