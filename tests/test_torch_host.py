"""The port's own copies of the JAX package's host-side modules (config,
solver, partitioner, recorder) against the originals: the copies must give
identical results, so the DBS control loop cannot drift between packages.
"""

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.balance import solver as jax_solver
from dynamic_load_balance_distributeddnn_tpu.config import get_parser as jax_parser
from dynamic_load_balance_distributeddnn_tpu.data import partitioner as jax_part
from dynamic_load_balance_distributeddnn_tpu.obs.recorder import SERIES as JAX_SERIES
from dynamic_load_balance_distributeddnn_tpu.train.schedule import one_cycle_lr as jax_lr
from dynamic_load_balance_distributeddnn_tpu_torch.balance import solver
from dynamic_load_balance_distributeddnn_tpu_torch.config import (
    Config,
    config_from_args,
    get_parser,
)
from dynamic_load_balance_distributeddnn_tpu_torch.data import partitioner
from dynamic_load_balance_distributeddnn_tpu_torch.obs import SERIES
from dynamic_load_balance_distributeddnn_tpu_torch.train.schedule import one_cycle_lr

# defaults the port changes on purpose (config.py module docstring)
CHANGED_DEFAULTS = {"probe_mode": "always", "use_pallas": True}


def _options(parser):
    return {
        a.dest: (tuple(sorted(a.option_strings)), a.default, a.type, a.choices)
        for a in parser._actions if a.dest != "help"
    }


def test_parser_has_the_jax_flags_and_defaults():
    want, got = _options(jax_parser()), _options(get_parser())
    assert set(got) == set(want)
    for dest, (opts, default, coerce, choices) in want.items():
        g_opts, g_default, g_coerce, g_choices = got[dest]
        assert g_opts == opts, dest
        assert g_default == CHANGED_DEFAULTS.get(dest, default), dest
        assert (g_coerce.__name__ if g_coerce else None) == (
            coerce.__name__ if coerce else None
        ), dest
        assert (sorted(g_choices) if g_choices else None) == (
            sorted(choices) if choices else None
        ), dest


def test_canonical_recipe_parses():
    cfg = config_from_args(
        "-m densenet -ds cifar10 -d false -ws 4 -b 512 -gpu 0,0,0,0 "
        "--use_pallas true --straggler 3,1,1,1 --fault_mode virtual -e 3 "
        "--n_train 4096".split()
    )
    assert cfg.device == [0, 0, 0, 0] and cfg.straggler_factors() == [3, 1, 1, 1]
    assert cfg.base_filename().startswith("densenet-cifar10-debug0-n4-bs512")


BASE = dict(model="densenet", dataset="cifar10")


@pytest.mark.parametrize("override", [
    {"probe_mode": "adaptive"}, {"fused_dbs": True}, {"shard_update": True},
    {"grad_comm": "hier"}, {"compress_grads": "int8"},
    {"grad_accum": 2}, {"rebalance": "window"},
    {"elastic": "on"}, {"coordinator": "localhost:1"}, {"trace": "on"},
    {"fault_mode": "compute"}, {"precision": "bfloat16"}, {"remat": True},
    {"ckpt_dir": "ck"}, {"fault_tolerance": True},
    {"model": "resnet"}, {"seq_parallel": "ring"},
    {"device": [0, 1], "world_size": 2},
])
def test_unported_settings_raise_naming_the_flag(override):
    with pytest.raises(NotImplementedError) as e:
        Config(**dict(BASE, **override))
    name = next(iter(override))
    flag = {"device": "-gpu", "model": "-m"}.get(name, f"--{name}")
    assert flag in str(e.value)


def test_lm_recipe_parses():
    cfg = config_from_args(
        "-m transformer -ds wikitext2 -d false -ws 4 -b 80 -gpu 0,0,0,0 --bptt 35 "
        "--grad_clip 0.25 --straggler 3,1,1,1 --fault_mode virtual "
        "--use_flash_attention true -e 3".split()
    )
    assert (cfg.model, cfg.grad_clip, cfg.use_flash_attention, cfg.bptt) == (
        "transformer", 0.25, True, 35)
    assert cfg.base_filename().startswith("transformer-wikitext2-debug0-n4-bs80")
    assert Config().model == "transformer"  # the JAX package's defaults parse


def test_vision_model_on_the_lm_corpus_is_refused():
    with pytest.raises(ValueError, match="wikitext2"):
        Config(model="densenet", dataset="wikitext2")


def test_contention_device_map_is_accepted():
    assert Config(**BASE, world_size=4, device=[0, 0, 0, 0]).device == [0, 0, 0, 0]


@pytest.mark.parametrize("seed", range(6))
def test_rebalance_and_quantize_equal_the_jax_solver(seed):
    rng = np.random.RandomState(seed)
    ws = rng.randint(2, 9)
    times = rng.uniform(0.1, 5.0, ws)
    shares = rng.dirichlet(np.ones(ws))
    for cap in (None, min(1.0, 2.0 / ws)):
        got = solver.rebalance(times, shares, 512, max_share=cap)
        want = jax_solver.rebalance_py(times, shares, 512, max_share=cap)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert np.array_equal(
            solver.quantize_batches(got[1], 16, 512),
            jax_solver.quantize_batches(want[1], 16, 512),
        )


@pytest.mark.parametrize("epoch", [0, 3])
def test_epoch_plan_equals_the_jax_partitioner(epoch):
    shares = np.array([0.1, 0.3, 0.3, 0.3])
    args = (1000, shares, np.array([16, 48, 48, 48]), 160, epoch)
    got = partitioner.build_epoch_plan(*args, seed=1234, bucket=16)
    want = jax_part.build_epoch_plan(*args, seed=1234, bucket=16)
    assert got.num_steps == want.num_steps
    for r in range(4):
        gi, gm = got.epoch_indices(r)
        wi, wm = want.epoch_indices(r)
        assert np.array_equal(gi, wi) and np.array_equal(gm, wm)


def test_series_and_schedule_copies():
    assert SERIES == JAX_SERIES
    for e in range(10):
        assert one_cycle_lr(0.1, e, 10) == jax_lr(0.1, e, 10)
