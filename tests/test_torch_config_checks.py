"""The port's ``Config`` checks values as the JAX package's ``Config`` does.

Each bad value below is built on both packages' ``Config``: both raise, with
the same exception type and the same message, so a value the JAX trainer
refuses never runs here under a silent fallback (``superstep="bogus"`` used
to run as ``auto``, ``packed="bogus"`` as ``auto``, ``superstep_window=0``
as 1). Pairs of bad values show that the checks run in the JAX package's
order: the first failing check names the same flag on both sides.

More than one process (``num_processes`` / ``process_id``) is accepted,
``--elastic`` across processes too (it was refused until its tier was
ported; those cases now hold the port to the JAX ``Config``). The flags the
slices ported (``trace``, ``trace_spool``, ``ckpt_dir``, ``profile_dir``,
``fused_dbs``, ``coordinator``, ``grad_comm``, ``remat``, ``elastic``, ...)
are accepted; the flags that stay refused still raise naming themselves.
"""

import pytest

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config

BASE = dict(model="densenet", dataset="cifar10", world_size=4)

BAD = [
    {"superstep": "bogus"},
    {"packed": "bogus"},
    {"superstep_window": 0},
    {"trace": "bogus"},
    {"trace_ring": 0},
    {"trace": "on", "trace_spool_flush_s": 0.0},
    {"trace_spool": "spools"},  # with --trace off
    {"hier_levels": "host"},
    {"hier_levels": "host:x"},
    {"hier_levels": "host:1"},
    {"hier_levels": "host:2,host:2"},
    {"hier_levels": "learned,rack"},
    {"grad_comm_wires": "int3"},
    {"grad_comm_wires": "fp32,int9"},
    {"dcn_probe_gate": 0.0},
    {"dcn_probe_gate": 1.6},
    {"elastic_readmit": "never"},
    {"device_cache": "bogus"},
    {"aot_backend": "fork"},
    {"aot_pool": -1},
    {"aot_workers": -1},
    {"hier_hosts": -1},
    {"elastic": "maybe"},
    {"elastic_detect_misses": 0},
    {"compress_grads": "int4"},
    {"grad_comm": "ring"},
    {"grad_comm_wire": "int2"},
    {"grad_comm": "hier", "compress_grads": "int8"},
    {"grad_comm": "hier", "seq_parallel": "ring"},
    {"rebalance": "window", "fused_dbs": True},
]

# two bad values at once: the first check in the JAX package's order wins
PAIRS = [
    {"superstep": "bogus", "packed": "bogus"},
    {"superstep_window": 0, "trace": "bogus"},
    {"aot_pool": -1, "trace_spool": "x"},
    {"hier_levels": "x", "dcn_probe_gate": 2.0},
    {"elastic_readmit": "x", "device_cache": "x"},
    {"superstep_window": 0, "aot_backend": "x"},
    {"hier_hosts": -1, "superstep": "bogus"},
    {"trace_ring": 0, "rebalance_every": 0},
]


def _raises(cls, kw):
    with pytest.raises(Exception) as e:
        cls(**dict(BASE, **kw))
    return e.value


@pytest.mark.parametrize("bad", BAD + PAIRS, ids=lambda d: ",".join(f"{k}={v}" for k, v in d.items()))
def test_bad_value_raises_as_the_jax_config_does(bad):
    want = _raises(JaxConfig, bad)
    got = _raises(Config, bad)
    assert type(got) is type(want)
    assert str(got) == str(want)


@pytest.mark.parametrize("ok", [
    {"superstep": "off"}, {"packed": "off"}, {"superstep_window": 1},
    {"trace": "ring", "trace_spool": "spools"}, {"trace": "on", "trace_ring": 1},
    {"hier_levels": ""}, {"grad_comm_wires": "auto"}, {"dcn_probe_gate": 1.5},
    {"device_cache": "off"}, {"aot_backend": "process"}, {"aot_pool": 0},
    {"ckpt_dir": "ck"}, {"profile_dir": "prof"}, {"trace_annotations": True},
    {"num_processes": 1, "process_id": 0}, {"num_processes": 0, "process_id": -1},
    # --elastic in one process, beside the flags it combines with
    {"elastic": "on", "grad_comm": "hier", "trace": "on"},
    {"elastic": "on", "seq_parallel": "ring", "hier_levels": "host:2"},
    {"elastic": "on", "ckpt_dir": "ck"},
    {"elastic": "on", "seq_parallel": "ring", "remat": True, "profile_dir": "prof"},
    {"elastic": "on", "seq_parallel": "ulysses", "trace": "ring", "trace_spool": "s"},
    {"elastic": "on", "grad_comm": "hier", "dcn_bandwidth_probe": True},
])
def test_good_values_are_accepted_by_both(ok):
    JaxConfig(**dict(BASE, **ok))
    Config(**dict(BASE, **ok))


@pytest.mark.parametrize("flag,value", [
    ("num_processes", 2), ("num_processes", 4), ("process_id", 1), ("process_id", 3),
])
def test_more_than_one_process_raises_naming_the_flag(flag, value):
    """Several processes run the vision loop and the language model, with
    checkpoints and ``--rebalance window`` (at epoch cadence, as the JAX
    trainer runs it there) and ``--elastic on`` (refused here until the
    elastic tier across processes was ported; accepted by both now)."""
    procs = {"num_processes": value} if flag == "num_processes" else {
        "num_processes": 4, "process_id": value}
    Config(**dict(BASE, **procs))
    Config(**dict(BASE, **procs, model="transformer", dataset="wikitext2"))
    for lifted in ({"ckpt_dir": "ck", "model": "transformer", "dataset": "wikitext2"},
                   {"rebalance": "window"}, {"ckpt_dir": "ck"}):
        JaxConfig(**dict(BASE, **procs, **lifted))
        Config(**dict(BASE, **procs, **lifted))
    for lifted in ({"elastic": "on"}, {"elastic": "on", "model": "transformer",
                                       "dataset": "wikitext2"}):
        JaxConfig(**dict(BASE, **procs, **lifted))
        Config(**dict(BASE, **procs, **lifted))


@pytest.mark.parametrize("override", [
    {"elastic": "on", "grad_comm": "hier", "trace": "on", "num_processes": 4},
    {"elastic": "on", "seq_parallel": "ring", "hier_levels": "host:2", "num_processes": 2},
    {"elastic": "on", "ckpt_dir": "ck", "num_processes": 2},
    {"elastic": "on", "seq_parallel": "ring", "remat": True, "profile_dir": "prof",
     "num_processes": 4, "process_id": 3},
    {"elastic": "on", "seq_parallel": "ulysses", "trace": "ring", "trace_spool": "s",
     "num_processes": 2},
    {"elastic": "on", "grad_comm": "hier", "dcn_bandwidth_probe": True, "num_processes": 4},
])
def test_flags_that_stay_refused_raise_beside_the_ported_ones(override):
    """``--elastic`` across processes beside the flags it combines with:
    refused until its tier was ported, now accepted as the JAX ``Config``
    accepts it."""
    JaxConfig(**dict(BASE, **override))
    Config(**dict(BASE, **override))
