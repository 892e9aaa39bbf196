"""``--grad_comm hier`` across gloo ranks against the JAX package.

- **Topology** (``parallel/topology.py``): ``factor_hosts``,
  ``parse_hier_levels`` and ``TopologyTree``'s ``declared``,
  ``from_process_topology``, ``learned`` and ``restrict`` equal the JAX
  package's on the cases of ``tests/test_grad_comm.py`` and more. The port
  reads a rank's host name where the JAX package reads a device's
  ``process_index``.
- **Wires** (``parallel/wire.py``): ``tree_hop_widths`` and
  ``choose_wires`` equal the JAX package's, the int4 wire's int8 sum
  included (1 byte an element up to 18 participants).
- **The spine**: ``tree_allreduce`` on a 4-rank gloo world, tree (2, 2),
  and an 8-rank one, (2, 2, 2), against the JAX ``tree_allreduce`` in
  ``shard_map`` over as many CPU devices, the same vector and key
  ``fold_in(PRNGKey(seed), index)`` a device, with and without incoming
  residuals: the outputs and the new residuals are equal bit for bit
  (integer sums are exact in any order, and so is a sum of two f32 terms).
- **The combine** (``train/combine.py``): one step of ``RankCombine`` on
  the tree, replicated and ZeRO-1, against the JAX ``_hier_combine`` and
  the hier branch of ``_zero1_update``: the parameters and residuals bit
  for bit.
- **Training**: 4 ranks with ``--grad_comm hier --hier_hosts 2`` beside the
  JAX ``Trainer`` at ``-gpu 0,1,2,3`` (dropout off, the same weights):
  window-mode DBS on the default wires (int8 outer hop), the same with
  ``--shard_update``, and the fused path on int4: the partitions equal, a
  mean parameter difference bound (as
  ``test_compressed_training_follows_the_jax_trainer``), ranks equal, the
  recorded bytes the hier formula.
- **The probe**: ``--hier_levels learned --dcn_bandwidth_probe true
  --grad_comm_wires auto`` gives every rank the same numbers and verdict.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import synthetic_dataset as jax_synthetic
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.parallel import topology as jtopo
from dynamic_load_balance_distributeddnn_tpu.parallel import wire as jwire
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.parallel import topology as ptopo
from dynamic_load_balance_distributeddnn_tpu_torch.parallel import wire as pwire
from tests._torch_dist_helpers import launch, straggler_time
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_dist_engine import _flat, _port_state, _tree
from tests.test_torch_online_dbs import _MnistNetNoDropout

N_TRAIN, N_TEST = 512, 256
SPINE_LEN = 1001  # odd: the tree pads it
SPINE_SEED, COMBINE_SEED = 0x71EE, 0x5D1E + 11
SPINE_CASES = {  # name: (sizes, wires, with incoming residuals)
    "fp32": ((2, 2), ("fp32", "fp32"), False),
    "int8": ((2, 2), ("int8", "fp32"), False),
    "int4": ((2, 2), ("int4", "fp32"), False),
    "int8_res": ((2, 2), ("int8", "fp32"), True),
    "int4_res": ((2, 2), ("int4", "fp32"), True),
}
SPINE8 = {"int4_int8": ((2, 2, 2), ("int4", "int8", "fp32"), True),
          "int4_int8_fresh": ((2, 2, 2), ("int4", "int8", "fp32"), False)}
LEVEL_NAMES = {2: ("host", "device"), 3: ("pod", "host", "device")}
TREE = (("host", "device"), (2, 2))
COMBINE_VARIANTS = {
    "hier8": {"tree": TREE, "wires": ("int8", "fp32")},
    "hier4_cl": {"tree": TREE, "wires": ("int4", "fp32"), "channels_last": True},
    "hier8_zero1": {"tree": TREE, "wires": ("int8", "fp32"), "shard_update": True},
    "hier4_zero1_cl": {"tree": TREE, "wires": ("int4", "fp32"), "shard_update": True,
                       "channels_last": True},
}
# 16 steps beside the JAX trainer: mean parameter difference and the share
# of parameters farther than 1e-6 (a code now and then a step apart where
# the frameworks' gradients differ in their last bits; see
# test_compressed_training_follows_the_jax_trainer). Measured on the CPU:
# win 2.7e-6 and 12.7 %, winz 4.2e-8 and 0.32 %, fused4 4.6e-8 and 0.023 %;
# on the fp32 wire the window run is 3.6e-9 and 0 % from JAX's.
TRAIN_BOUNDS = {"win": (2e-5, 0.3), "winz": (1e-6, 0.05), "fused4": (1e-6, 0.01)}


# ------------------------------------------------------------- topology


def _devices(procs):
    return [types.SimpleNamespace(process_index=p) for p in procs]


HOST_LAYOUTS = [[0] * 8, [0, 0, 1, 1], [0, 0, 0, 0, 1, 1, 1, 1], [0, 0, 1, 1, 1],
                [0, 1, 0, 1], [0, 0, 1, 1, 2, 2], [0, 1, 2, 3], [0, 0, 0, 1, 1, 1, 2, 2, 2]]


@pytest.mark.parametrize("procs", HOST_LAYOUTS, ids=lambda p: "".join(map(str, p)))
def test_factor_hosts_and_the_process_split_equal_the_jax_package(procs):
    for requested in (0, 1, 2, 3, 4, 8, 16):
        want = jtopo.factor_hosts(_devices(procs), requested)
        assert ptopo.factor_hosts([f"host{p}" for p in procs], requested) == want, requested
        jt = jtopo.TopologyTree.from_process_topology(_devices(procs), requested)
        pt = ptopo.TopologyTree.from_process_topology([f"host{p}" for p in procs], requested)
        assert (None if pt is None else pt.levels) == (None if jt is None else jt.levels)


@pytest.mark.parametrize("spec", ["host:4", "pod:2,host:2", " rack:2 , host:2,", "", "host",
                                  "host:x", "host:1", "host:2,host:2", "a:2,device:2"])
def test_parse_hier_levels_and_declared_trees_equal_the_jax_package(spec):
    try:
        want = jtopo.parse_hier_levels(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            ptopo.parse_hier_levels(spec)
        assert str(got.value) == str(e)
        return
    assert ptopo.parse_hier_levels(spec) == want
    for n in (2, 4, 6, 8, 16, 24):
        jt, pt = jtopo.TopologyTree.declared(spec, n), ptopo.TopologyTree.declared(spec, n)
        assert (None if pt is None else pt.levels) == (None if jt is None else jt.levels), n


LEARN_CASES = [
    ((("pod", 2), ("host", 2), ("device", 2)), [1e6, 0.9e6, 1e9]),
    ((("pod", 2), ("host", 2), ("device", 2)), [1e9, 1e9, 1e9]),
    ((("pod", 2), ("host", 2), ("device", 2)), [0.0, 0.0, 0.0]),
    ((("pod", 2), ("host", 2), ("device", 2)), [1e6, 1e8, 1.5e8]),
    ((("host", 2), ("device", 2)), [5.69e8, 5.58e8]),
    ((("host", 2), ("device", 4)), [1e7, -1.0]),
]


@pytest.mark.parametrize("levels,rates", LEARN_CASES)
def test_learned_and_restricted_trees_equal_the_jax_package(levels, rates):
    jt, pt = jtopo.TopologyTree(levels), ptopo.TopologyTree(levels)
    jl, pl = jtopo.TopologyTree.learned(jt, rates), ptopo.TopologyTree.learned(pt, rates)
    assert (None if pl is None else pl.levels) == (None if jl is None else jl.levels)
    for n in range(1, 17):
        jr, pr = jt.restrict(n), pt.restrict(n)
        assert (None if pr is None else pr.levels) == (None if jr is None else jr.levels), n


# ---------------------------------------------------------------- wires


@pytest.mark.parametrize("sizes", [(2, 2), (2, 4), (4, 2), (2, 2, 2), (3, 2, 2), (8, 2)])
def test_tree_hop_widths_equal_the_jax_package(sizes):
    inner = int(np.prod(sizes[1:]))
    for n in (1, 7, 133, 1001, 6_956_298):
        for pad in (0, inner, int(np.prod(sizes)), 2 * int(np.prod(sizes))):
            assert pwire.tree_hop_widths(n, sizes, pad) == jwire.tree_hop_widths(n, sizes, pad)


RATES = [[1e9, 1e9, 1e9], [1e8, 1e9, 1e9], [1e7, 1e8, 1e9], [5e7, 1e9, 1e9], [2e8, 1e9, 1e9],
         [0.0, 1e9, 1e9], [1e6, 0.0, 1e9], [4.5e7, 4.4e8, 1e9]]


@pytest.mark.parametrize("rates", RATES, ids=lambda r: "-".join(f"{x:.0e}" for x in r))
def test_choose_wires_and_payload_bytes_equal_the_jax_package(rates):
    # up to 16 participants a hop (above, the int8 wire's sum rides int32
    # here, 4 bytes, where JAX's int16 takes 2)
    for sizes in ((2, 2, 2), (16, 2, 2), (9, 2, 2), (2, 4, 2)):
        assert pwire.choose_wires(sizes, rates) == jwire.choose_wires(sizes, rates), sizes
        assert pwire.choose_wires(sizes[:2], rates[1:]) == jwire.choose_wires(sizes[:2], rates[1:])
    for wire in ("fp32", "int8", "int4"):
        for n in range(1, 17):
            assert pwire.wire_payload_bytes(wire, n) == jwire.wire_payload_bytes(wire, n), (wire, n)
    # the int4 wire's sum rides int8 (one byte) up to 18 participants
    assert pwire.transport_dtype("int4", 18) == torch.int8
    assert pwire.transport_dtype("int4", 19) == torch.float16


@pytest.mark.parametrize("sizes,wires", [
    ((2, 2), ("fp32", "fp32")), ((2, 2), ("int8", "fp32")), ((4, 2), ("int4", "fp32")),
    ((2, 2, 2), ("int4", "int8", "fp32")), ((3, 2, 2), ("int8", "int4", "fp32")),
    ((2, 4, 2), ("fp32", "int8", "fp32"))])
def test_comm_bytes_and_modeled_combine_equal_the_jax_formula(sizes, wires):
    """The recorder's hier bytes a step and the modeled combine wall
    (``Trainer._comm_bytes_per_step``, ``_modeled_comm_step_s``) equal the
    JAX package's methods on the same tree, wires, rates and element count,
    both computed from the port's per-hop bytes (``tree_hop_bytes``)."""
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer as PortTrainer

    rates = [4.5e7, 4.4e8, 1e9][-len(sizes):]
    for elems in (1001, 6_956_298):
        state = dict(grad_comm="hier", _topo_tree=types.SimpleNamespace(sizes=sizes),
                     _grad_comm_wires=wires, _link_bw={"level_bytes_per_s": rates},
                     _param_elems=elems, cfg=types.SimpleNamespace(compress_grads=""), n_proc=1)
        j, p = types.SimpleNamespace(**state), types.SimpleNamespace(**state)
        got = PortTrainer._comm_bytes_per_step(p)
        assert got == jax_engine.Trainer._comm_bytes_per_step(j), (elems, got)
        assert got[1] == pwire.tree_hop_bytes(elems, sizes, wires)[-1][1]
        modeled = PortTrainer._modeled_comm_step_s(p)
        assert modeled > 0 and modeled == jax_engine.Trainer._modeled_comm_step_s(j), elems
        p._link_bw = {"level_bytes_per_s": rates[:-1] + [0.0]}  # a level unmeasured: no model
        assert PortTrainer._modeled_comm_step_s(p) == 0.0


# --------------------------------------------------------------- spine


def _spine_inputs(world, cases):
    rng = np.random.default_rng(world)
    v = (rng.standard_normal((world, SPINE_LEN)) * 1e-2).astype(np.float32)
    jobs = {}
    for name, (sizes, wires, with_res) in cases.items():
        widths = jwire.tree_hop_widths(SPINE_LEN, sizes)
        res = None
        if with_res:
            res = [(rng.standard_normal((world, w)) * 1e-3).astype(np.float32) for w in widths[:-1]]
        jobs[name] = (LEVEL_NAMES[len(sizes)], sizes, wires, res)
    return v, jobs


def _jax_spine(v, names, sizes, wires, res):
    """The JAX ``tree_allreduce`` in ``shard_map`` over ``prod(sizes)`` CPU
    devices, each device's key ``fold_in(PRNGKey(SPINE_SEED), index)``."""
    from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import shard_map, tree_mesh

    n = int(np.prod(sizes))
    mesh = tree_mesh(jax.devices()[:n], names, sizes)
    k = len(sizes) - 1

    def body(x, *r):
        idx = jax.lax.axis_index(names[0])
        for a in names[1:]:
            idx = idx * mesh.shape[a] + jax.lax.axis_index(a)
        key = jax.random.fold_in(jax.random.PRNGKey(SPINE_SEED), idx)
        out, new = jwire.tree_allreduce(x[0], key, names, sizes, wires,
                                        tuple(q[0] for q in r) if r else None)
        return out[None], tuple(q[None] for q in new)

    args = (v,) + (tuple(res) if res is not None else ())
    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(names),) * len(args),
                           out_specs=(P(names), (P(names),) * k), check_vma=False))
    put = [jax.device_put(a, NamedSharding(mesh, P(names))) for a in args]
    out, new = fn(*put)
    return np.asarray(out), [np.asarray(q) for q in new]


def _check_spine(world_out, v, jobs):
    for name, (names, sizes, wires, res) in jobs.items():
        want, want_res = _jax_spine(v, names, sizes, wires, res)
        assert np.abs(want).max() > 0
        for rank, out in enumerate(world_out):
            got = out["spine"][name]
            assert np.array_equal(got["out"].numpy(), want[rank]), (name, rank)
            assert len(got["residuals"]) == len(sizes) - 1
            for hop, (g, w) in enumerate(zip(got["residuals"], want_res)):
                assert np.array_equal(g.numpy(), w[rank]), (name, rank, hop)
            if wires[0] == "fp32":
                assert all(not r.any() for r in got["residuals"])
            assert got.get("two_level_same", len(sizes) > 2)


# ------------------------------------------------------------ trainers


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=4, batch_size=64, learning_rate=0.05, epoch_size=2,
              dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=N_TRAIN,
              grad_comm="hier", hier_hosts=2,
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


TRAIN_RUNS = {  # name: (flags, timing model)
    "win": ({}, "3,1,1,1"),
    "winz": ({"shard_update": True}, "3,1,1,1"),
    "fused4": ({"dynamic_batch_size": False, "grad_comm_wires": "int4,fp32"}, None),
}


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX trainer at ``-gpu 0,1,2,3`` on each of ``TRAIN_RUNS``, dropout
    off, each in its own directories."""
    tmp = tmp_path_factory.mktemp("jax_hier")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    out = {}
    try:
        for name, (over, timing) in TRAIN_RUNS.items():
            tr = JaxTrainer(JaxConfig(**_kw(tmp, name, device=[0, 1, 2, 3], **over)),
                            bundle=jax_synthetic("mnist", n_train=N_TRAIN, n_test=N_TEST),
                            timing_model=None if timing is None else straggler_time(
                                tuple(float(f) for f in timing.split(","))),
                            log_to_file=False)
            init = {k: np.asarray(v) for k, v in _flat(tr.state.params).items()}
            out[name] = (tr, tr.run(), init)
    finally:
        mp.undo()
    return out


def _grads(init, world):
    rng = np.random.default_rng(17)
    return [{k: (rng.standard_normal(np.shape(v)) * 1e-2).astype(np.float32)
             for k, v in init.items()} for _ in range(world)]


@pytest.fixture(scope="module")
def world4(jax_runs, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world4_hier")
    init = jax_runs["win"][2]
    state = _port_state(init)
    v, spine = _spine_inputs(4, SPINE_CASES)
    jobs = {
        name: {"kind": "train", "cfg": _kw(tmp, name, device=[0, 0, 0, 0], **over),
               "state": state, "no_dropout": True, "timing": timing}
        for name, (over, timing) in TRAIN_RUNS.items()
    }
    jobs["probe"] = {"kind": "train", "state": state, "no_dropout": True, "timing": "3,1,1,1",
                     "cfg": _kw(tmp, "probe", device=[0, 0, 0, 0], epoch_size=1,
                                hier_levels="learned", dcn_bandwidth_probe=True,
                                grad_comm_wires="auto")}
    jobs["comb"] = {"kind": "combine", "grads": [_port_state(g) for g in _grads(init, 4)],
                    "seed": COMBINE_SEED, "variants": COMBINE_VARIANTS}
    jobs["spine"] = {"kind": "tree", "v": v, "seed": SPINE_SEED, "cases": spine}
    return launch(4, jobs, tmp, timeout=300), v, spine


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("world8_hier")
    v, spine = _spine_inputs(8, SPINE8)
    return launch(8, {"spine": {"kind": "tree", "v": v, "seed": SPINE_SEED, "cases": spine}},
                  tmp, timeout=300), v, spine


def test_spine_on_four_ranks_is_the_jax_spine_bit_for_bit(world4):
    out, v, spine = world4
    _check_spine(out, v, spine)
    # the groups: hosts {0, 1} and {2, 3} at the device level, {0, 2} and
    # {1, 3} at the host level (the JAX tree_mesh's rows and columns)
    assert [tuple(g) for g in out[1]["spine"]["int8"]["groups"]] == [(1, 3), (0, 1)]
    assert [tuple(g) for g in out[2]["spine"]["int8"]["groups"]] == [(0, 2), (2, 3)]


def test_spine_on_eight_ranks_is_the_jax_spine_bit_for_bit(world8):
    _check_spine(*world8)


def _jax_tree_combine(grads, wires, zero1: bool):
    """The JAX package's hier combine of ``grads`` (one ``_flat`` dict a
    device) on 4 CPU devices, tree (2, 2), each device's key
    ``fold_in(PRNGKey(COMBINE_SEED), index)``, from zero residuals: minus
    ``_hier_combine``'s sum, or the parameters after the hier
    ``_zero1_update`` at lr 1 from zero parameters; and the new residuals."""
    import optax

    from dynamic_load_balance_distributeddnn_tpu.parallel.mesh import shard_map, tree_mesh
    from dynamic_load_balance_distributeddnn_tpu.train.state import (
        TrainState,
        attach_comm_residual,
        shard_optimizer_state,
        zero1_padded_size,
    )
    from dynamic_load_balance_distributeddnn_tpu.train.steps import StepLibrary

    mesh = tree_mesh(jax.devices()[:4], *TREE)
    stacked = jax.tree_util.tree_map(lambda *ls: jnp.stack(ls), *[_tree(g) for g in grads])
    tx = optax.inject_hyperparams(optax.sgd)(learning_rate=1.0, momentum=0.9)
    zeros = jax.tree_util.tree_map(jnp.zeros_like, _tree(grads[0]))
    lib = StepLibrary.zero1_shell(mesh, tx, zero1_padded_size(zeros, 4), hier=True, wires=wires)
    st = TrainState(params=zeros, opt_state=tx.init(zeros), step=jnp.zeros((), jnp.int32))
    if zero1:
        st = shard_optimizer_state(st, mesh, tx)
    else:
        lib.shard_update = False
    st = attach_comm_residual(st, mesh, pad_multiple=4 if zero1 else 0)

    def key():
        return jax.random.fold_in(jax.random.PRNGKey(COMBINE_SEED), lib._data_axis_index())

    def body(state, g):
        local = jax.tree_util.tree_map(lambda x: jnp.sum(x, axis=0), g)
        if zero1:
            return lib._zero1_update(state, local, key(), with_comm=True)
        total, res = lib._hier_combine(local, key(), state.comm_residual)
        return state.replace(params=jax.tree_util.tree_map(lambda x: -x, total),
                             comm_residual=res)

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(lib._state_spec(), P(lib._batch_entry)),
                           out_specs=lib._state_spec(), check_vma=False))
    out = fn(st, jax.device_put(stacked, NamedSharding(mesh, P(lib._batch_entry))))
    return (jax.tree_util.tree_map(np.asarray, out.params),
            [np.asarray(r) for r in out.comm_residual])


def test_tree_combine_is_the_jax_combine_bit_for_bit(jax_runs, world4):
    """One step of ``RankCombine`` on the tree, replicated and ZeRO-1, the
    convolutions contiguous or channels-last, against the JAX package on
    the same gradients and keys: parameters and residuals bit for bit."""
    out = world4[0]
    grads = _grads(jax_runs["win"][2], 4)
    for variant, kw in COMBINE_VARIANTS.items():
        params, res = _jax_tree_combine(grads, kw["wires"], kw.get("shard_update", False))
        exp = _port_state(_flat(params))
        assert any(float(x.abs().max()) > 0 for x in exp.values())
        for rank in range(4):
            got = out[rank]["comb"]
            for k, x in exp.items():
                assert torch.equal(got[variant][k], x), (variant, rank, k)
            (r,) = got[variant + ":residuals"]
            assert r.any() and np.array_equal(r.numpy(), res[0][rank]), (variant, rank)


@pytest.mark.parametrize("name", list(TRAIN_RUNS))
def test_hier_training_follows_the_jax_trainer(jax_runs, world4, name):
    jtr, jrec, _ = jax_runs[name]
    assert jtr.grad_comm == "hier" and jtr._grad_comm_wires == tuple(
        world4[0][0][name]["meta"]["grad_comm_wires"])
    want = _port_state(_flat(jtr.state.params))
    mean_atol, share = TRAIN_BOUNDS[name]
    for out in (o[name] for o in world4[0]):
        assert out["meta"]["grad_comm"] == "hier"
        assert out["meta"]["grad_comm_levels"] == [["host", 2], ["device", 2]]
        assert out["data"]["partition"] == jrec.data["partition"]
        d = torch.cat([(out["params"][k] - want[k]).abs().flatten() for k in want])
        assert float(d.mean()) < mean_atol, (name, float(d.mean()))
        assert float((d > 1e-6).float().mean()) < share, name
        np.testing.assert_allclose(out["data"]["train_loss"], jrec.data["train_loss"], rtol=1e-4)
        # the recorded bytes: the JAX package's hier formula
        assert out["data"]["comm_bytes_ici"] == jrec.data["comm_bytes_ici"]
        assert out["data"]["comm_bytes_dcn"] == jrec.data["comm_bytes_dcn"]
    assert len({o[name]["report"]["param_sha256"] for o in world4[0]}) == 1


def test_hier_shard_update_keeps_a_quarter_of_the_momentum(world4):
    for rank, o in enumerate(world4[0]):
        comb = o["winz"]["meta"]["combine"]
        assert comb["shard_update"] and comb["grad_comm"] == "hier"
        assert 4 * comb["momentum_chunk_elems"] == comb["padded_elems"]
        assert comb["residual_elems"] == [comb["padded_elems"] // 2]
        assert not o["winz"]["momentum"]


def test_the_probe_verdict_is_the_same_on_every_rank(world4):
    outs = [o["probe"] for o in world4[0]]
    bw = outs[0]["meta"]["link_bandwidth"]
    assert bw is not None and bw["measured_on_rank"] == 0
    assert len(bw["level_bytes_per_s"]) == 2 and all(r > 0 for r in bw["level_bytes_per_s"])
    for o in outs[1:]:
        assert o["meta"]["link_bandwidth"] == bw
        assert o["report"]["link_bandwidth"] == bw
        for k in ("grad_comm", "grad_comm_levels", "grad_comm_wires"):
            assert o["meta"][k] == outs[0]["meta"][k], k
    assert len({o["report"]["param_sha256"] for o in outs}) == 1
    # every rank took the same verdict: the learned tree, or flat
    kind = outs[0]["meta"]["grad_comm"]
    assert kind in ("hier", "flat")
    if kind == "hier":
        assert outs[0]["meta"]["modeled_comm_step_s"] > 0


# --------------------------------------------------------------- config


HIER_OK = [{"grad_comm": "hier"}, {"grad_comm": "hier", "hier_hosts": 2},
           {"grad_comm": "hier", "hier_levels": "learned,pod:2", "grad_comm_wires": "auto"},
           {"grad_comm": "hier", "grad_comm_wires": "int4,int8,fp32", "dcn_bandwidth_probe": True},
           {"grad_comm": "hier", "shard_update": True, "dcn_probe_gate": 1.5}]
HIER_BAD = [{"grad_comm": "hier", "compress_grads": "int8"},
            {"grad_comm": "hier", "seq_parallel": "ring"},
            {"grad_comm": "hier", "hier_levels": "pod:1"},
            {"grad_comm": "hier", "grad_comm_wires": "int8,int16"}]
BASE = dict(model="densenet", dataset="cifar10")


@pytest.mark.parametrize("over", HIER_OK + HIER_BAD,
                         ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_hier_flags_are_checked_as_the_jax_package_checks_them(over):
    try:
        JaxConfig(**dict(BASE, **over))
    except Exception as want:
        with pytest.raises(Exception) as got:
            Config(**dict(BASE, **over))
        assert type(got.value) is type(want) and str(got.value) == str(want)
        return
    cfg = Config(**dict(BASE, **over))
    assert cfg.grad_comm == "hier"


def test_hier_in_one_process_falls_back_to_flat(tmp_path):
    """One process holds one device: no tree factors, and the run takes the
    flat combine with the JAX package's warning."""
    from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
    from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer

    cfg = Config(**_kw(tmp_path, "one", world_size=2, epoch_size=1, hier_hosts=2, device=[0, 0]))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=128, n_test=64), device="cpu",
                 log_to_file=False)
    assert tr.grad_comm == "flat" and tr._topo_tree is None
    rec = tr.run()
    assert rec.meta["grad_comm"] == "flat" and np.isfinite(rec.data["train_loss"]).all()
