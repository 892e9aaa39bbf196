"""The port's controller lab (``balance/replaylab.py``) against the JAX
package's, bit for bit: both are host-side numpy over a copied controller,
solver and injector, so every report must be equal, not close.

- every checked-in corpus (``tests/corpus_replay/*.json``) replays strictly
  through the port's ``replay`` with parity and no invariant violations,
  and the whole report equals the JAX package's; so do counterfactual
  replays under other knobs;
- ``check_invariants`` flags the same seeded mutations as the JAX one;
- ``simulate`` on every ``builtin_scenarios()`` entry gives the JAX
  package's report and journal; ``sweep``, ``knob_grid`` and
  ``random_knobs`` likewise;
- a port controller's ``harvest`` and a JAX trace file of decision instants
  are corpora the port replays.
"""

import glob
import json
import os
import pathlib

import numpy as np
import pytest

from dynamic_load_balance_distributeddnn_tpu.balance import replaylab as jax_lab
from dynamic_load_balance_distributeddnn_tpu.balance.controller import (
    OnlineRebalanceController as JaxController,
)
from dynamic_load_balance_distributeddnn_tpu.obs.trace import (
    configure as configure_tracer,
    get_tracer,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab
from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import (
    OnlineRebalanceController,
)

CORPUS_DIR = pathlib.Path(__file__).resolve().parent / "corpus_replay"
CORPUS_FILES = sorted(glob.glob(str(CORPUS_DIR / "*.json")))
IDS = [os.path.basename(p) for p in CORPUS_FILES]
SCENARIOS = [sc.name for sc in replaylab.builtin_scenarios(4)]


def test_the_five_corpora_are_there():
    assert len(CORPUS_FILES) == 5


@pytest.mark.parametrize("path", CORPUS_FILES, ids=IDS)
def test_corpus_replays_bit_for_bit_as_jax(path):
    corpus = replaylab.load_corpus(path)
    assert corpus == jax_lab.load_corpus(path)
    report = replaylab.replay(corpus)
    assert report["mode"] == "strict"
    assert report["parity"], report["mismatches"][:5]
    assert report["invariant_violations"] == []
    assert report["replayed"]["switches"] == report["recorded"]["switches"]
    assert replaylab.check_invariants(corpus["config"], corpus["journal"]) == []
    assert report == jax_lab.replay(jax_lab.load_corpus(path))


@pytest.mark.parametrize("knobs", [
    {"hysteresis": 0.02, "margin": 1.0},
    {"budget_frac": 0.25, "rate_alpha": 0.9},
    {"cost_init": 0.5, "margin": 6.0},
], ids=["eager", "tight-budget", "costly"])
@pytest.mark.parametrize("path", CORPUS_FILES, ids=IDS)
def test_counterfactual_replay_equals_jax(path, knobs):
    got = replaylab.replay(replaylab.load_corpus(path), knobs=knobs)
    assert got["mode"] == "counterfactual" and got["invariant_violations"] == []
    assert got == jax_lab.replay(jax_lab.load_corpus(path), knobs=knobs)
    with pytest.raises(ValueError):
        replaylab.replay(replaylab.load_corpus(path), knobs={"warp_speed": 9})


@pytest.mark.parametrize("mutation", ["overspend", "no-gain"])
def test_invariant_checker_flags_what_jax_flags(mutation):
    corpus = replaylab.load_corpus(CORPUS_FILES[0])
    bad = [dict(e) for e in corpus["journal"]]
    victim = next(e for e in bad if e.get("switch"))
    if mutation == "overspend":
        victim["spent_s"] = 1e9
    else:
        victim["predicted_win_s"] = -1.0
    got = replaylab.check_invariants(corpus["config"], bad)
    assert got and got == jax_lab.check_invariants(corpus["config"], bad)


@pytest.mark.parametrize("name", SCENARIOS)
def test_simulate_equals_jax(name):
    sc = next(s for s in replaylab.builtin_scenarios(4) if s.name == name)
    jsc = next(s for s in jax_lab.builtin_scenarios(4) if s.name == name)
    got = replaylab.simulate(sc, include_journal=True)
    assert got["invariant_violations"] == [] and got["journal"]
    assert got == jax_lab.simulate(jsc, include_journal=True)
    # a simulated journal is a corpus the port replays bit for bit
    report = replaylab.replay({"config": got["config"], "journal": got["journal"]})
    assert report["parity"] and report["replayed"]["switches"] == got["switches"]


def test_sweep_and_knob_sets_equal_jax():
    assert replaylab.knob_grid("small") == jax_lab.knob_grid("small")
    assert replaylab.knob_grid("full") == jax_lab.knob_grid("full")
    assert replaylab.random_knobs(6, seed=3) == jax_lab.random_knobs(6, seed=3)
    knobs = replaylab.knob_grid("small")[:4] + replaylab.random_knobs(2, seed=1)
    got = replaylab.sweep(replaylab.builtin_scenarios(4)[:3], knobs)
    want = jax_lab.sweep(jax_lab.builtin_scenarios(4)[:3], knobs)
    assert got == want and got["invariant_violations"] == 0
    with pytest.raises(ValueError):
        replaylab.knob_grid("huge")


def _drive(ctl):
    """Two evaluations: a committed switch, then a deferred one."""
    ctl.eval_context = {"epoch": 0, "window": 0}
    dec = ctl.propose(np.array([0.001, 0.003]), np.array([32, 32]), 100)
    assert dec.switch
    ctl.commit(dec, 0.002, epoch=0, window=0)
    ctl.eval_context = {"epoch": 0, "window": 1}
    dec2 = ctl.propose(np.array([0.003, 0.001]), np.asarray(dec.candidate_batches), 50)
    assert dec2.switch
    ctl.note_deferred()
    return ctl


def test_harvest_is_a_corpus(tmp_path):
    ctl = _drive(OnlineRebalanceController(2, 64, [[0], [1]], hysteresis=0.0, margin=0.5,
                                           cost_init=0.001))
    path = tmp_path / "run.json"
    path.write_text(json.dumps(replaylab.harvest(ctl, label="run")))
    corpus = replaylab.load_corpus(str(path))
    assert corpus["label"] == "run" and len(corpus["journal"]) == 2
    report = replaylab.replay(corpus)
    assert report["parity"] and report["invariant_violations"] == []
    for k in ("switches", "deferred"):
        assert report["recorded"][k] == report["replayed"][k] == 1
    # the recorder's meta holds the snapshot under "rebalance_controller"
    meta = tmp_path / "meta.json"
    meta.write_text(json.dumps({"rebalance_controller": ctl.snapshot(include_journal=True)}))
    assert replaylab.load_corpus(str(meta))["journal"] == corpus["journal"]


def test_jax_trace_file_is_a_corpus_for_the_port(tmp_path):
    """A Chrome trace of the JAX controller's decision instants rebuilds
    config, journal and outcomes in the port, and replays."""
    configure_tracer("on")
    try:
        live = _drive(JaxController(2, 64, [[0], [1]], hysteresis=0.0, margin=0.5,
                                    cost_init=0.001)).decision_journal()
        path = get_tracer().save(str(tmp_path / "run.trace.json"))
    finally:
        configure_tracer("off")
    corpus = replaylab.load_corpus(path)
    assert corpus["config"]["world_size"] == 2
    assert [e["reason"] for e in corpus["journal"]] == [e["reason"] for e in live]
    assert [e.get("outcome") for e in corpus["journal"]] == ["committed", "deferred"]
    report = replaylab.replay(corpus)
    assert report["parity"] and report["recorded"]["deferred"] == 1


def test_load_corpus_rejects_empty_foreign_and_spools(tmp_path):
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"config": {"world_size": 2}, "journal": []}))
    hollow = tmp_path / "hollow.json"
    hollow.write_text(json.dumps({"hello": 1}))
    for p in (empty, hollow):
        with pytest.raises(ValueError):
            replaylab.load_corpus(str(p))
    (tmp_path / "x.spool").write_text("")
    for p in (tmp_path, tmp_path / "x.spool"):  # no decision journal in them
        for lab in (replaylab, jax_lab):
            with pytest.raises(ValueError):
                lab.load_corpus(str(p))
