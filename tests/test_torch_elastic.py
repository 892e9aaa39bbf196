"""``--elastic on`` in one process against the JAX trainer (the JAX
package's chaos cases, ``tests/test_elastic.py``).

Each case runs the JAX ``Trainer`` and the port's ``Trainer`` with the same
``Config`` (one device, ``--packed off``: the elastic path, whose windows
of one step each are the boundaries the health checks run at), the same
synthetic MNIST bundle, an injector with the same schedule and the same
deterministic timing model (per original worker, following the live
fleet), from the JAX trainer's initial weights (``bridge.py``), dropout off
on both sides. The port runs under ``--superstep auto`` (on the CPU its
step executor, eager from the static slots) and ``off``. Held equal exactly:
``workers_alive``, ``recoveries``, ``partition`` and each elastic event's
``lost`` / ``readmitted`` / ``world_size`` / ``epoch``; ``train_loss``
within rtol 1e-5 (``tests/test_torch_dist_engine.py``'s tolerance). The
cases:

- kill worker 3 of 4 mid-epoch 1 and readmit it at epoch 3, worker 0 a 3:1
  straggler: the run completes over 3 survivors, every partition covers
  the data disjointly, and after readmission worker 0 again holds the
  smallest share;
- a permanent loss, against a fresh 3-worker run (both packages), whose
  last loss it lands near;
- detection inside the epoch the loss lands in;
- readmission from the health signal alone (the injector announces no
  rejoin);
- resume after a loss: a run that checkpointed at the survivor fleet
  resumes at that fleet;
- the language model (2 layers, 16 wide, on the tiny corpus) with a
  worker that misses the last four windows of epoch 0 and returns, below
  ``--elastic_detect_misses 5``: SUSPECT, never LOST, on both sides. The
  JAX ``LMTrainer`` cannot survive a confirmed loss (its
  ``_reshard_world`` rebuilds the vision ``StepLibrary`` from
  ``self.bundle.mean``, and the LM has no bundle: AttributeError, retried
  three times, raised), so the LM's recovery is held to the port itself:
  the epoch re-run over the survivors equals a fresh 3-worker run, bit for
  bit, and the worker rejoins at epoch 2.

Port-only: the snapshot's round trip writes in place and restores the
state bit for bit; a recovery drops the step graphs and the re-run epoch
goes through the step executor again; the recovery budget.
"""

import jax
import numpy as np
import pytest
import torch

import dynamic_load_balance_distributeddnn_tpu.train.engine as jax_engine
from dynamic_load_balance_distributeddnn_tpu import faults as jax_faults
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.corpus import Corpus as JaxCorpus
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.data.partitioner import partition_indices
from dynamic_load_balance_distributeddnn_tpu.models import ModelSpec
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch import faults
from dynamic_load_balance_distributeddnn_tpu_torch.bridge import params_from_flax
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import Corpus, synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.models.common import Dropout
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.health import WorkerLost
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_dist_helpers import computed_once
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)
from tests.conftest import make_tiny_corpus
from tests.test_torch_checkpoint import SmallJaxLM, SmallLMNoDropout
from tests.test_torch_online_dbs import _MnistNetNoDropout

LOSS_RTOL = 1e-5

# name: (events (worker, down_at, rejoin_epoch), per-worker factors, epochs, announce)
CASES = {
    "kill_readmit": ([(3, 1.4, 3)], [3.0, 1.0, 1.0, 1.0], 5, True),
    "permanent_loss": ([(3, 1.4, None)], [1.0] * 4, 4, True),
    "detect_in_epoch": ([(2, 1.2, None)], [1.0] * 4, 3, True),
    "readmit_by_signal": ([(3, 1.4, 2)], [1.0] * 4, 5, False),
}


def _kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=4, batch_size=64, learning_rate=0.05, epoch_size=5,
              dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=7, bucket=8,
              stream_chunk_steps=1, elastic="on", device=0, packed="off",
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _lm_kw(tmp, tag, **over):
    kw = dict(debug=True, world_size=4, batch_size=40, learning_rate=0.05, epoch_size=3,
              dataset="wikitext2", model="transformer", bucket=4, bptt=16, seed=7,
              stream_chunk_steps=1, superstep_window=2, elastic="on", device=0,
              lm_data_dir=str(tmp / "corpus"),
              log_dir=str(tmp / tag / "logs"), stat_dir=str(tmp / tag / "statis"))
    kw.update(over)
    return kw


def _timing(holder, factors):
    """Seconds per original worker, following the live fleet: the plan's
    workers are compact ranks, ``active_ranks`` maps them back."""

    def tm(plan):
        f = np.asarray(factors)[np.asarray(holder["tr"].active_ranks)]
        return f * np.array([w.batch_size * w.steps * 1e-3 for w in plan.workers])

    return tm


def _injector(pkg, events, announce=True):
    cls = pkg.PreemptionInjector
    if not announce:
        cls = type("NoAnnounce", (cls,), {"rejoining": lambda self, epoch: set()})
    return cls(4, [pkg.PreemptionEvent(worker=w, down_at=d, rejoin_epoch=r)
                   for w, d, r in events])


def _summary(tr, rec):
    return {"data": {k: list(v) for k, v in rec.data.items()},
            "events": rec.meta.get("elastic_events", []),
            "active": list(tr.active_ranks), "world_size": tr.world_size}


def _jax_run(tmp, tag, kw, events, factors, epochs=None, announce=True, lm=False):
    holder = {}
    inj = _injector(jax_faults, events, announce) if events is not None else None
    if lm:
        tr = SmallJaxLM(JaxConfig(**kw), bundle=JaxCorpus(str(tmp / "corpus")), injector=inj,
                        timing_model=_timing(holder, factors), log_to_file=False)
    else:
        tr = JaxTrainer(JaxConfig(**kw), bundle=jax_synthetic("mnist", n_train=256, n_test=64),
                        injector=inj, timing_model=_timing(holder, factors), log_to_file=False)
    holder["tr"] = tr
    init = jax.tree_util.tree_map(lambda a: np.array(a, copy=True), tr.state.params)
    out = _summary(tr, tr.run(epochs))
    out["init"] = init
    return out


def _compute_jax(tmp) -> dict:
    """Every JAX run the tests read, dropout off (MnistNet without its
    dropout; the LM at DROPOUT 0)."""
    tmp.mkdir(parents=True, exist_ok=True)
    make_tiny_corpus(tmp / "corpus")
    mp = pytest.MonkeyPatch()
    mp.setattr(jax_engine, "build_model", lambda name, num_classes=10, **kw: ModelSpec(
        name, _MnistNetNoDropout(num_classes=num_classes), "logits", "image"))
    out = {}
    try:
        for name, (events, factors, epochs, announce) in CASES.items():
            out[name] = _jax_run(tmp, name, _kw(tmp, name, epoch_size=epochs, superstep="off"),
                                 events, factors, announce=announce)
        kw = _kw(tmp, "fresh", epoch_size=4, superstep="off", world_size=3, elastic="off")
        out["fresh"] = _jax_run(tmp, "fresh", kw, None, [1.0] * 3)
        ck = _kw(tmp, "ckpt", epoch_size=2, superstep="off", ckpt_dir=str(tmp / "jck"))
        out["ckpt_lost"] = _jax_run(tmp, "ckpt", ck, [(1, 0.4, None)], [1.0] * 4)
        out["ckpt_resumed"] = _jax_run(tmp, "ckpt2", dict(ck, epoch_size=3), None, [1.0] * 4)
        out["lm"] = _jax_run(tmp, "lm", _lm_kw(tmp, "lm", superstep="off",
                                                elastic_detect_misses=5),
                             [(2, 0.5, 1)], [3.0, 1.0, 1.0, 1.0], lm=True)
    finally:
        mp.undo()
    return out


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    return computed_once(tmp_path_factory, "elastic_jax", _compute_jax)


def _port(tmp, kw, events, factors, init, announce=True, lm=False):
    holder = {}
    inj = _injector(faults, events, announce) if events is not None else None
    if lm:
        if not (tmp / "corpus").exists():
            make_tiny_corpus(tmp / "corpus")
        tr = SmallLMNoDropout(Config(**kw), bundle=Corpus(str(tmp / "corpus")), injector=inj,
                              timing_model=_timing(holder, factors), device="cpu",
                              log_to_file=False)
    else:
        tr = Trainer(Config(**kw), bundle=synthetic_dataset("mnist", n_train=256, n_test=64),
                     injector=inj, timing_model=_timing(holder, factors), device="cpu",
                     log_to_file=False)
    holder["tr"] = tr
    tr.model.load_state_dict(params_from_flax(init, tr.model))
    for m in tr.model.modules():
        if isinstance(m, Dropout):
            m.p = 0.0
    return tr


def _assert_follows(got, want):
    """The fleet series and partitions exactly, the events' fleet fields
    exactly, the train losses within ``LOSS_RTOL``."""
    g, w = got["data"], want["data"]
    assert g["epoch"] == w["epoch"]
    for key in ("workers_alive", "recoveries", "partition"):
        assert g.get(key) == w.get(key), key
    fields = ("epoch", "lost", "readmitted", "world_size")
    assert [{k: e[k] for k in fields if k in e} for e in got["events"]] == [
        {k: e[k] for k in fields if k in e} for e in want["events"]]
    np.testing.assert_allclose(g["train_loss"], w["train_loss"], rtol=LOSS_RTOL, atol=0)
    assert got["active"] == want["active"] and got["world_size"] == want["world_size"]


def _run_case(tmp, jax_runs, name, superstep):
    events, factors, epochs, announce = CASES[name]
    tr = _port(tmp, _kw(tmp, name, epoch_size=epochs, superstep=superstep), events, factors,
               jax_runs[name]["init"], announce)
    got = _summary(tr, tr.run())
    _assert_follows(got, jax_runs[name])
    return tr, got


def _coverage(shares, n):
    parts = partition_indices(n, shares)
    owned = np.concatenate(list(parts))
    assert len(set(owned.tolist())) == len(owned)  # disjoint
    assert len(owned) >= n - len(shares)  # all but the int() truncation


SUPERSTEPS = ["auto", "off"]


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_chaos_kill_midepoch_survive_and_readmit(tmp_path, jax_runs, superstep):
    tr, got = _run_case(tmp_path, jax_runs, "kill_readmit", superstep)
    alive = got["data"]["workers_alive"]
    assert alive[0] == 4.0 and 3.0 in alive and alive[-1] == 4.0
    assert got["data"]["recoveries"][-1] == 1.0
    ev = got["events"][0]
    assert ev["lost"] == [3] and ev["world_size"] == 3 and ev["detect_to_resume_s"] > 0
    assert any("readmitted" in e for e in got["events"])
    for shares in got["data"]["partition"]:
        assert abs(sum(shares) - 1.0) < 1e-9
        _coverage(np.asarray(shares), 256)
    final = np.asarray(got["data"]["partition"][-1])
    assert len(final) == 4 and final[0] == final.min() and final[0] < 0.25
    assert tr.recorder.meta["paths"] == ["elastic"] * 5  # the re-run epoch recorded once


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_chaos_loss_matches_fresh_reduced_run(tmp_path, jax_runs, superstep):
    _, got = _run_case(tmp_path, jax_runs, "permanent_loss", superstep)
    assert got["data"]["workers_alive"][-1] == 3.0
    fresh = _port(tmp_path, _kw(tmp_path, "fresh", epoch_size=4, superstep=superstep,
                                world_size=3, elastic="off"),
                  None, [1.0] * 3, jax_runs["fresh"]["init"])
    want = jax_runs["fresh"]
    rec = fresh.run()
    assert rec.data["partition"] == want["data"]["partition"]
    np.testing.assert_allclose(rec.data["train_loss"], want["data"]["train_loss"],
                               rtol=LOSS_RTOL, atol=0)
    # other partitions and visit orders: not bit for bit, the same budget
    assert got["data"]["train_loss"][-1] == pytest.approx(rec.data["train_loss"][-1], abs=0.15)


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_detection_within_one_epoch(tmp_path, jax_runs, superstep):
    _, got = _run_case(tmp_path, jax_runs, "detect_in_epoch", superstep)
    assert got["events"][0]["epoch"] == 1
    assert got["data"]["workers_alive"][1] == 3.0


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_chaos_readmission_via_health_signal(tmp_path, jax_runs, superstep):
    _, got = _run_case(tmp_path, jax_runs, "readmit_by_signal", superstep)
    assert got["data"]["workers_alive"][1] == 3.0 and got["data"]["workers_alive"][-1] == 4.0
    readmit = next(e for e in got["events"] if "readmitted" in e)
    assert readmit["readmitted"] == [3] and readmit["epoch"] == 3


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_checkpoint_resume_after_loss(tmp_path, jax_runs, superstep):
    """The sidecar stamps the survivor fleet; a resumed run adopts it and
    trains only the remaining epoch, as the JAX trainer's does."""
    ck = _kw(tmp_path, "ckpt", epoch_size=2, superstep=superstep,
             ckpt_dir=str(tmp_path / "ck"))
    first = _port(tmp_path, ck, [(1, 0.4, None)], [1.0] * 4, jax_runs["ckpt_lost"]["init"])
    _assert_follows(_summary(first, first.run()), jax_runs["ckpt_lost"])
    assert first.world_size == 3
    tr = _port(tmp_path, dict(ck, epoch_size=3), None, [1.0] * 4,
               jax_runs["ckpt_resumed"]["init"])
    got = _summary(tr, tr.run())
    _assert_follows(got, jax_runs["ckpt_resumed"])
    assert tr.world_size == 3 and tr.active_ranks == [0, 2, 3]
    assert got["data"]["epoch"] == [2] and len(got["data"]["partition"][0]) == 3


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_lm_suspect_worker_follows_the_jax_lm_trainer(tmp_path, jax_runs, superstep):
    want = jax_runs["lm"]
    tr = _port(tmp_path, _lm_kw(tmp_path, "lm", superstep=superstep, elastic_detect_misses=5),
               [(2, 0.5, 1)], [3.0, 1.0, 1.0, 1.0], want["init"], lm=True)
    got = _summary(tr, tr.run())
    _assert_follows(got, want)
    assert got["data"]["workers_alive"] == [4.0] * 3 and got["events"] == []
    assert tr.health.snapshot()["status"] == ["alive"] * 4


@pytest.mark.parametrize("superstep", SUPERSTEPS)
def test_lm_recovery_reruns_the_epoch_as_a_fresh_reduced_run(tmp_path, jax_runs, superstep):
    """Worker 2 of 4 lost in epoch 0 and back at epoch 2, dropout on: the
    re-run epochs 0 and 1 over workers 0, 1, 3 equal a fresh run of 3
    workers with their factors, bit for bit."""
    init = jax_runs["lm"]["init"]
    kw = _lm_kw(tmp_path, "lm_loss", superstep=superstep)

    def lm(kw, events, factors):
        tr = _port(tmp_path, kw, events, factors, init, lm=True)
        for m in tr.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.2
        return tr

    tr = lm(kw, [(2, 0.5, 2)], [3.0, 1.0, 1.0, 1.0])
    rec = tr.run()
    fresh = lm(dict(kw, world_size=3, elastic="off", epoch_size=3,
                    log_dir=str(tmp_path / "fresh")), None, [3.0, 1.0, 1.0])
    want = fresh.run(2)
    assert rec.data["workers_alive"] == [3.0, 3.0, 4.0]
    assert tr.recorder.meta["elastic_events"][0]["lost"] == [2]
    for key in ("train_loss", "val_loss", "partition"):
        assert rec.data[key][:2] == want.data[key], key
    assert len(rec.data["partition"][2]) == 4 and np.isfinite(rec.data["train_loss"]).all()


# ------------------------------------------------------------- port only


def _mnist(tmp, **over):
    return Trainer(Config(**_kw(tmp, "unit", **over)),
                   bundle=synthetic_dataset("mnist", n_train=256, n_test=64), device="cpu",
                   log_to_file=False, timing_model=lambda plan: np.ones(len(plan.workers)))


def test_snapshot_round_trip_writes_in_place(tmp_path):
    tr = _mnist(tmp_path, epoch_size=1)
    tr.run()
    snap = tr._state_to_host()
    ptrs = [(p.data_ptr(), tr.optimizer.state[p]["momentum_buffer"].data_ptr())
            for p in tr.params]
    want = [(p.detach().clone(), tr.optimizer.state[p]["momentum_buffer"].clone())
            for p in tr.params]
    gens = {k: g.get_state() for k, g in tr._generators().items()}
    steps = tr.steps_done
    with torch.no_grad():
        for p in tr.params:
            p.mul_(3.0)
            tr.optimizer.state[p]["momentum_buffer"].add_(1.0)
    for g in tr._generators().values():
        torch.rand(5, generator=g)
    tr.steps_done += 7
    tr._state_from_host(snap)
    assert ptrs == [(p.data_ptr(), tr.optimizer.state[p]["momentum_buffer"].data_ptr())
                    for p in tr.params]
    for p, (w, m) in zip(tr.params, want):
        assert torch.equal(p, w) and torch.equal(tr.optimizer.state[p]["momentum_buffer"], m)
    assert tr.steps_done == steps
    for k, g in tr._generators().items():
        assert torch.equal(g.get_state(), gens[k])


def test_recovery_drops_the_step_graphs_and_reruns_through_the_executor(tmp_path):
    inj = faults.PreemptionInjector(4, [faults.PreemptionEvent(worker=1, down_at=0.5)])
    tr = Trainer(Config(**_kw(tmp_path, "exec", epoch_size=2)),
                 bundle=synthetic_dataset("mnist", n_train=256, n_test=64), injector=inj,
                 device="cpu", log_to_file=False,
                 timing_model=lambda plan: np.ones(len(plan.workers)))
    tr.run()
    recs = tr.recorder.meta["supersteps"]
    assert [r["epoch"] for r in recs] == [0, 1]  # epoch 0 recorded once, after its re-run
    # the re-run epoch made its keys anew (the old fleet's were dropped)
    assert recs[0]["new_keys"] == recs[0]["keys"] > 0
    assert all(r["mode"] == "scan" and r["eager_runs"] > 0 for r in recs)
    assert [len(r["batch_sizes"]) for r in recs] == [3, 3]
    assert len(tr.recorder.meta["elastic_snapshot_s"]) == 3  # epoch 0 twice, epoch 1
    assert tr.recorder.data["workers_alive"] == [3.0, 3.0]
    snap = tr.obs.snapshot()["health"]
    assert snap["status"][1] == "lost" and snap["alive"] == 3


def test_the_recovery_budget_is_kept(tmp_path):
    inj = faults.PreemptionInjector(4, [faults.PreemptionEvent(worker=1, down_at=0.2),
                                        faults.PreemptionEvent(worker=2, down_at=0.6)])
    tr = Trainer(Config(**_kw(tmp_path, "budget", epoch_size=2, elastic_max_recoveries=1)),
                 bundle=synthetic_dataset("mnist", n_train=256, n_test=64), injector=inj,
                 device="cpu", log_to_file=False,
                 timing_model=lambda plan: np.ones(len(plan.workers)))
    with pytest.raises(WorkerLost) as e:
        tr.run()
    assert e.value.ranks == [2] and tr._recoveries == 1 and tr.active_ranks == [0, 2, 3]


def test_a_run_without_the_flag_takes_no_snapshot(tmp_path):
    tr = _mnist(tmp_path, epoch_size=1, elastic="off")
    tr.run()
    assert "elastic_snapshot_s" not in tr.recorder.meta
    assert "workers_alive" not in tr.recorder.data


def test_the_readmission_probe_runs_the_equal_split_batch(tmp_path):
    """Without a timing model the readmitted worker's cost comes from one
    probe step at the equal split's width (B / world_size rows, at least
    ``bucket``), not the JAX package's ``bucket`` rows: on one card a step of
    ``bucket`` rows is bound by its launches and over-reads the cost an
    example. The probe leaves the parameters and the dropout stream as
    they were."""
    tr = Trainer(Config(**_kw(tmp_path, "probe", epoch_size=1)),
                 bundle=synthetic_dataset("mnist", n_train=256, n_test=64), device="cpu",
                 log_to_file=False)
    widths = []
    dummy = tr._dummy_batch
    tr._dummy_batch = lambda b: widths.append(b) or dummy(b)
    before = [p.detach().clone() for p in tr.params]
    state = tr.dropout_gen.get_state()
    cost = tr._probe_readmitted(3)
    assert widths == [64 // 4] and np.isfinite(cost) and cost > 0
    assert all(torch.equal(p, q) for p, q in zip(tr.params, before))
    assert torch.equal(tr.dropout_gen.get_state(), state)
    assert tr.health.snapshot()["latency_s"][3] > 0
