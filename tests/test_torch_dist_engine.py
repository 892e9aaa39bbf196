"""The port's trainer across gloo ranks (``tests/_torch_dist_helpers.py``
worlds, ``file://`` rendezvous, one torch thread a rank) against the JAX
package's trainer and against itself.

Every run: MnistNet on the synthetic FashionMNIST stand-in (no augmentation),
512 training examples, B 64, bucket 8, 2 epochs, dropout off on both sides
(the JAX package's ``_MnistNetNoDropout`` and the port's dropout at p 0,
from the JAX trainer's initial weights through ``bridge.py``), so no step
draws a random number.

- **Window-mode DBS against JAX**: ``-ws 2`` over 2 ranks against the JAX
  trainer at ``-gpu 0,1`` on two of its 8 CPU devices (its window mode),
  under the same 3:1 ``timing_model``: the ``partition`` and ``node_time``
  series are equal, the parameters agree within ``ATOL`` (the two
  frameworks sum the convolutions' terms in other orders).
- **Two ranks against one process**: the same 2-rank run is bit for bit the
  port's one-process 2-worker elastic run (``--packed off``): parameters,
  momentum buffers and every series; a 2-way sum is one addition either way.
- **The fused paths**: ``-dbs false`` (the fused path) agrees with the JAX
  fused path within ``ATOL``; ``_cap_b`` equals the JAX trainer's;
  ``--fused_dbs`` gives the JAX trainer's partitions.
- **The int8 wire against JAX**: on the same gradients and keys, one step
  of the port's ``--compress_grads int8`` combine and of its ZeRO-1 twin
  gives the JAX package's ``_compressed_psum`` and ``_zero1_update``
  results bit for bit (``tests/_torch_dist_helpers.py`` ``_combine``);
  trained over 16 steps, both stay within a mean difference of the JAX
  trainer's parameters (``test_compressed_training_follows_the_jax_trainer``).
- **The fused path's options**: ``--grad_accum 2`` agrees with 1 within
  ``ACCUM_ATOL`` (two micro-batch sums in place of one); ``--compress_grads
  int8`` tracks the exact run's losses within rtol 0.08 and learns (the JAX
  ``test_compress_grads.py`` band); ``--shard_update`` is bit for bit with
  the replicated update at 2 ranks, on the fused and the window-mode paths,
  each rank keeping half the momentum, and within ``ZERO1_ATOL_4`` at 4
  ranks (gloo's reduce-scatter and all-reduce add four terms in other
  orders); ZeRO-1 on the int8 wire with ``--grad_accum 2`` runs, learns and
  keeps the ranks equal.
"""

import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models import build_model
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_dist_helpers import launch, straggler_time, train_outputs, trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_online_dbs import _MnistNetNoDropout

ATOL = 1e-6  # port against JAX, parameters after 16 steps (measured 1.2e-7, 1.6e-7)
ACCUM_ATOL = 1e-6  # measured 8.9e-8
ZERO1_ATOL_4 = 1e-6  # gloo on the CPU gave 0
N_TRAIN, N_TEST = 512, 256
COMBINE_SEED = 0x5D1E + 7
# the combine's variants (tests/_torch_dist_helpers.py ``_combine``) and the
# JAX step each must equal
COMBINE_VARIANTS = {
    "psum8": {"compress": "int8"},
    "psum8_cl": {"compress": "int8", "channels_last": True},
    "zero1_8": {"compress": "int8", "shard_update": True},
    "zero1_8_cl": {"compress": "int8", "shard_update": True, "channels_last": True},
}


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
              dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=N_TRAIN,
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _jax_run(kw, timing):
    tr = JaxTrainer(JaxConfig(**kw), bundle=jax_synthetic("mnist", n_train=N_TRAIN, n_test=N_TEST),
                    timing_model=timing, log_to_file=False)
    init = {k: np.asarray(v) for k, v in _flat(tr.state.params).items()}
    rec = tr.run()
    return tr, rec, init


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict) or hasattr(v, "items"):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer at ``-gpu 0,1``: window-mode DBS (3:1 timing model),
    the fused path (``-dbs false``) and the fused-DBS path, dropout off."""
    tmp = tmp_path_factory.mktemp("jax")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    try:
        timing = straggler_time((3.0, 1.0))
        win = _jax_run(_kw(tmp, "win", device=[0, 1]), timing)
        fused = _jax_run(_kw(tmp, "fused", device=[0, 1], dynamic_batch_size=False), None)
        fdbs = _jax_run(_kw(tmp, "fdbs", device=[0, 1], fused_dbs=True), timing)
        off = _kw(tmp, "compress", device=[0, 1], dynamic_batch_size=False, compress_grads="int8")
        compress = _jax_run(off, None)
        zero1c = _jax_run(_kw(tmp, "zero1c", device=[0, 1], dynamic_batch_size=False,
                              compress_grads="int8", shard_update=True, grad_accum=2), None)
    finally:
        mp.undo()
    return {"win": win, "fused": fused, "fdbs": fdbs, "compress": compress, "zero1c": zero1c}


def _tree(flat) -> dict:
    """``_flat``'s paths back into a nested tree."""
    tree = {}
    for path, v in flat.items():
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.asarray(v)
    return tree


def _port_state(flat) -> dict:
    """Flax parameters (``_flat``'s paths) as the port MnistNet's state dict."""
    return params_from_flax(_tree(flat), build_model("mnistnet", num_classes=10, in_channels=1))


def _combine_grads(init) -> list:
    """Two devices' gradients in the flax layout (``init``: the flax
    parameters by ``_flat`` path), from a seed."""
    rng = np.random.default_rng(7)
    return [{k: (rng.standard_normal(np.shape(v)) * 1e-2).astype(np.float32)
             for k, v in init.items()} for _ in range(2)]


def _jax_combine(grads) -> dict:
    """The JAX package's combines of ``grads`` (one ``_flat`` dict a device)
    on two CPU devices, each device's key ``fold_in(PRNGKey(COMBINE_SEED),
    index)``: ``psum8``, minus ``_compressed_psum``'s sum, and ``zero1_8``,
    the parameters after ``_zero1_update`` on the int8 wire from zero
    parameters at lr 1 (minus the same sum's ZeRO-1 twin)."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding
    from jax.sharding import PartitionSpec as P

    from dynamic_load_balance_distributeddnn_tpu.models import build_model as jax_build_model
    from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import data_mesh, shard_map
    from dynamic_load_balance_distributeddnn_tpu.train.state import (
        TrainState,
        make_optimizer,
        shard_optimizer_state,
        zero1_padded_size,
    )
    from dynamic_load_balance_distributeddnn_tpu.train.steps import StepLibrary

    mesh = data_mesh(jax.devices()[:2])
    stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *[_tree(g) for g in grads])

    def key():
        return jax.random.fold_in(jax.random.PRNGKey(COMBINE_SEED), jax.lax.axis_index("data"))

    lib = StepLibrary(jax_build_model("mnistnet"), mesh, make_optimizer(0.1), compress_grads="int8")

    def psum(st):
        local = jax.tree_util.tree_map(lambda g: g[0], st)
        return jax.tree_util.tree_map(lambda g: g[None], lib._compressed_psum(local, key()))

    fn = jax.jit(shard_map(psum, mesh=mesh, in_specs=P("data"), out_specs=P("data"),
                           check_vma=False))
    psum8 = jax.tree_util.tree_map(lambda a: -np.asarray(a)[0], fn(stacked))

    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=1.0, momentum=0.9)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, _tree(grads[0]))
    zl = StepLibrary.zero1_shell(mesh, tx, zero1_padded_size(zeros, 2), compress="int8")
    st = shard_optimizer_state(TrainState(params=zeros, opt_state=tx.init(zeros),
                                          step=jnp.zeros((), jnp.int32)), mesh, tx)

    def body(state, st):
        local = jax.tree_util.tree_map(lambda g: jnp.sum(g, axis=0), st)
        return zl._zero1_update(state, local, key(), with_comm=True)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(zl._state_spec(), P(zl._batch_entry)),
                           out_specs=zl._state_spec(), check_vma=False))
    out = fn(st, jax.device_put(stacked, NamedSharding(mesh, P(zl._batch_entry))))
    zero1_8 = jax.tree_util.tree_map(np.asarray, out.params)
    return {"psum8": psum8, "zero1_8": zero1_8}


@pytest.fixture(scope="module")
def state(jax_runs):
    """The JAX trainer's initial weights as the port model's state dict."""
    return _port_state(jax_runs["win"][2])


def _job(cfg, state, timing=None):
    return {"kind": "train", "cfg": cfg, "state": state, "no_dropout": True, "timing": timing}


@pytest.fixture(scope="module")
def world2(jax_runs, state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world2")
    off = _kw(tmp, "off", dynamic_batch_size=False, device=[0, 0])
    dbs = _kw(tmp, "dbs", device=[0, 0])
    jobs = {
        "win": _job(dbs, state, "3,1"),
        "winz": _job(dict(dbs, shard_update=True), state, "3,1"),
        "fused": _job(off, state),
        "zero1": _job(dict(off, shard_update=True), state),
        "accum2": _job(dict(off, grad_accum=2), state),
        "compress": _job(dict(off, compress_grads="int8"), state),
        "zero1c": _job(dict(off, shard_update=True, compress_grads="int8", grad_accum=2), state),
        "fdbs": _job(dict(dbs, fused_dbs=True), state, "3,1"),
        "comb": {"kind": "combine",
                 "grads": [_port_state(g) for g in _combine_grads(jax_runs["win"][2])],
                 "seed": COMBINE_SEED, "variants": COMBINE_VARIANTS},
    }
    return launch(2, jobs, tmp, timeout=300)


@pytest.fixture(scope="module")
def world4(state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4")
    off = _kw(tmp, "off", world_size=4, dynamic_batch_size=False)
    jobs = {"fused": _job(off, state), "zero1": _job(dict(off, shard_update=True), state)}
    return launch(4, jobs, tmp, timeout=300)


@pytest.fixture(scope="module")
def one_process(state, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("one")
    tr = trainer(_job(_kw(tmp, "one", packed="off"), state, "3,1"))
    tr.run()
    return train_outputs(tr)


def _max_diff(a, b):
    return max(float((a[k] - b[k]).abs().max()) for k in a)


def _jax_params(tr) -> dict:
    return _port_state(_flat(tr.state.params))


# ------------------------------------------------------------ window mode


def test_window_mode_series_equal_the_jax_trainer(jax_runs, world2):
    jtr, jrec, _ = jax_runs["win"]
    assert jtr._elastic_mode() == "window"
    for out in (o["win"] for o in world2):
        assert out["mode"] == "window" and out["meta"]["paths"] == ["elastic"] * 2
        assert out["data"]["partition"] == jrec.data["partition"]
        assert out["data"]["node_time"] == jrec.data["node_time"]
    assert world2[0]["win"]["data"]["partition"][-1][0] < 0.5
    want = _jax_params(jtr)
    assert _max_diff(world2[0]["win"]["params"], want) < ATOL


def test_two_ranks_equal_one_process_bit_for_bit(world2, one_process):
    two = world2[0]["win"]
    assert one_process["mode"] == "scan"
    for k, p in one_process["params"].items():
        assert torch.equal(p, two["params"][k]), k
        assert torch.equal(one_process["momentum"][k], two["momentum"][k]), k
    for k in ("partition", "node_time", "train_loss", "val_loss", "accuracy"):
        assert two["data"][k] == one_process["data"][k], k


def test_ranks_end_equal_and_report_the_collectives(world2):
    for name in set(world2[0]) - {"comb"}:  # every train job
        r0, r1 = world2[0][name]["report"], world2[1][name]["report"]
        assert r0["param_sha256"] == r1["param_sha256"], name
        assert r0["ranks"]["backend"] == "gloo" and r0["ranks"]["size"] == 2
        assert r0["workers"] == [0] and r1["workers"] == [1]
        coll = world2[0][name]["meta"]["collective"]
        assert [c["steps"] for c in coll] == [8, 8], name


# ------------------------------------------------------------- fused paths


def test_fused_path_matches_the_jax_fused_path(jax_runs, world2):
    jtr, jrec, _ = jax_runs["fused"]
    out = world2[0]["fused"]
    assert out["meta"]["paths"] == ["fused"] * 2
    assert jrec.data["partition"] == out["data"]["partition"]
    assert _max_diff(out["params"], _jax_params(jtr)) < ATOL
    np.testing.assert_allclose(out["data"]["train_loss"], jrec.data["train_loss"], rtol=1e-5)


@pytest.mark.parametrize("over", [
    {}, {"batch_size": 512, "world_size": 4}, {"capacity_factor": 1.5, "world_size": 4},
    {"bucket": 32, "batch_size": 100}, {"capacity_factor": 3.0, "batch_size": 48, "bucket": 16},
])
def test_cap_b_equals_the_jax_trainer(over, tmp_path):
    kw = _kw(tmp_path, "cap", **over)
    port = Trainer(Config(**kw), bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                   device="cpu", log_to_file=False)
    jtr = JaxTrainer(JaxConfig(**kw), bundle=jax_synthetic("mnist", n_train=256, n_test=64),
                     log_to_file=False)
    assert port._cap_b == jtr._cap_b


def test_fused_dbs_partitions_equal_the_jax_trainer(jax_runs, world2):
    _, jrec, _ = jax_runs["fdbs"]
    for out in (o["fdbs"] for o in world2):
        assert out["meta"]["paths"] == ["fused_dbs"] * 2
        assert out["data"]["partition"] == jrec.data["partition"]
    # one step graph key serves every plan: the capacity width
    keys = world2[0]["fdbs"]["meta"]["supersteps"][-1]["keys"]
    assert keys == 1


def test_grad_accum_2_matches_one_micro_batch(world2):
    a, b = world2[0]["accum2"], world2[0]["fused"]
    assert _max_diff(a["params"], b["params"]) < ACCUM_ATOL
    np.testing.assert_allclose(a["data"]["train_loss"], b["data"]["train_loss"], rtol=1e-6)


def test_combine_step_is_the_jax_combine_bit_for_bit(jax_runs, world2):
    """On the same gradients and keys, the port's int8 combine and its
    ZeRO-1 twin give the JAX package's parameters bit for bit, the
    convolutions laid out contiguous or channels-last: each element's
    dither is drawn at its flax position, in JAX's leaf order."""
    want = _jax_combine(_combine_grads(jax_runs["win"][2]))
    for variant in COMBINE_VARIANTS:
        exp = _port_state(_flat(want[variant.removesuffix("_cl")]))
        assert any(float(v.abs().max()) > 0 for v in exp.values())
        for rank in (0, 1):
            got = world2[rank]["comb"][variant]
            for k, v in exp.items():
                assert torch.equal(got[k], v), (variant, rank, k)


@pytest.mark.parametrize("name,mean_atol,share", [("compress", 1e-6, 0.001), ("zero1c", 1e-4, 0.3)])
def test_compressed_training_follows_the_jax_trainer(jax_runs, world2, name, mean_atol, share):
    """``-dbs false --compress_grads int8`` and ``--shard_update
    --compress_grads int8 --grad_accum 2`` over 2 ranks against the JAX
    trainer at ``-gpu 0,1``. A code is a floor: where the two frameworks'
    gradients differ in their last bits (``ATOL`` above), an element's code
    now and then lands one step apart, and the later steps carry that on.
    So the test bounds the mean difference and the share of parameters
    farther than ``ATOL`` from JAX's. Measured: 1.2e-8 and 0.014 % (int8),
    1.6e-5 and 16.8 % (ZeRO-1, one global scale, so a step apart is larger);
    with the dither drawn at torch-layout positions, 5.2e-4 and 86 %, and
    6.9e-4 and 86 %."""
    jtr, jrec, _ = jax_runs[name]
    want = _jax_params(jtr)
    for out in (world2[0][name], world2[1][name]):
        d = torch.cat([(out["params"][k] - want[k]).abs().flatten() for k in want])
        assert float(d.mean()) < mean_atol, (name, float(d.mean()))
        assert float((d > ATOL).float().mean()) < share, name
        np.testing.assert_allclose(out["data"]["train_loss"], jrec.data["train_loss"], rtol=1e-4)


def test_compressed_training_tracks_the_exact_run(world2):
    quant, exact = world2[0]["compress"]["data"], world2[0]["fused"]["data"]
    assert np.isfinite(quant["train_loss"]).all()
    assert quant["train_loss"][-1] < quant["train_loss"][0]
    np.testing.assert_allclose(quant["train_loss"], exact["train_loss"], rtol=0.08)
    # the int8 wire moves half the f32 bytes
    assert quant["comm_bytes_ici"][0] * 2 == exact["comm_bytes_ici"][0]


@pytest.mark.parametrize("zero1,replicated", [("zero1", "fused"), ("winz", "win")])
def test_shard_update_is_bit_for_bit_with_the_replicated_update(world2, zero1, replicated):
    for rank in (0, 1):
        z, r = world2[rank][zero1], world2[rank][replicated]
        for k, p in r["params"].items():
            assert torch.equal(z["params"][k], p), (rank, k)
        comb = z["meta"]["combine"]
        assert comb["shard_update"] and 2 * comb["momentum_chunk_elems"] == comb["padded_elems"]
        assert not z["momentum"]  # no rank holds a full momentum buffer
    # the chunks are the replicated momentum, raveled in the flat order
    full = torch.cat([world2[0][zero1]["chunk"], world2[1][zero1]["chunk"]])
    assert full.numel() == world2[0][zero1]["meta"]["combine"]["padded_elems"]


def test_shard_update_at_4_ranks_within_tolerance(world4):
    for rank in range(4):
        z, r = world4[rank]["zero1"], world4[rank]["fused"]
        assert z["meta"]["combine"]["momentum_chunk_elems"] * 4 == z["meta"]["combine"]["padded_elems"]
        assert _max_diff(z["params"], r["params"]) < ZERO1_ATOL_4
    assert len({o["zero1"]["report"]["param_sha256"] for o in world4}) == 1


def test_zero1_on_the_int8_wire_with_grad_accum_learns(world2):
    out = world2[0]["zero1c"]
    losses = out["data"]["train_loss"]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert out["report"]["param_sha256"] == world2[1]["zero1c"]["report"]["param_sha256"]
    np.testing.assert_allclose(losses, world2[0]["fused"]["data"]["train_loss"], rtol=0.08)

