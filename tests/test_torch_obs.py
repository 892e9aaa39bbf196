"""The port's observability against the JAX package's, on the CPU.

- **Spans**: MnistNet, 2 workers, a 3:1 virtual straggler, every epoch
  probed, ``--trace on``, on the elastic path (``--packed off``) and the
  packed one: the port's trace holds the JAX trainer's span names and
  categories, less the phases this port does not have (the AOT compile
  service's ``aot_*`` and its ``aot_drain`` phase, the transfer pipeline's ``gather`` / ``stage`` /
  ``fused_put``, the fused scan's ``fused_dispatch``, ``speculate`` and the
  watchdog's ``heartbeat``). Its phases tile at least 95% of each epoch's
  wall (``attribution``), and the JAX ``attribution`` reads the port's file
  the same way.
- **Spool**: the run's ``--trace_spool`` file holds the trace's events; cut
  mid-frame, the port's ``read_spool`` and the JAX one return the same
  complete frames and ``truncated``.
- **graftscope**: on a window-cadence run's trace and spool directory, the
  port's ``summarize``, ``decisions``, ``replay`` and ``postmortem`` print
  what the JAX package's print, and the replay keeps every verdict;
  ``conformance`` exits 2 naming what it needs.
- **FLOPs**: ``step_flops`` against the JAX trainer's ``compiled_flops`` for
  the same MnistNet worker step (below for the measured ratio and its
  bound); no peak and no MFU on the CPU.
- **Wall feedback**: with a fake event timer standing in for the card's
  CUDA events, ``observe_wall`` receives the events' time; on the CPU it
  receives the JAX formula (host wall less launch time).
- ``--profile_dir`` writes a Chrome trace; ``--trace_annotations`` puts each
  span into the profiler as a ``record_function`` range.

No test here waits on a clock.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.obs import scope_cli as jax_scope
from dynamic_load_balance_distributeddnn_tpu.obs.spool import read_spool as jax_read_spool
from dynamic_load_balance_distributeddnn_tpu.obs.trace import attribution as jax_attribution
from dynamic_load_balance_distributeddnn_tpu.obs.trace import configure as jax_configure
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab
from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import (
    OnlineRebalanceController,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.timing import DeviceWindowTimer
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.obs import MetricsRegistry, Tracer
from dynamic_load_balance_distributeddnn_tpu_torch.obs import scope_cli
from dynamic_load_balance_distributeddnn_tpu_torch.obs.flops import chip_peak_flops, mfu
from dynamic_load_balance_distributeddnn_tpu_torch.obs.spool import read_spool
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import (
    EPOCH_CAT,
    attribution,
    configure,
    load_trace,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)

# the JAX trainer's spans of phases this port does not have (its warm
# service captures nothing pending at an epoch's start in these runs, so no
# aot_drain)
PORT_LACKS = {"aot_compile", "aot_lower", "aot_drain", "gather", "stage", "fused_put",
              "fused_dispatch"}
# the port's spans the JAX trainer lacks on a path: the port's packed epoch
# runs at the plan's true widths, whose tail step's key moves with the plan,
# so its warm service speculates after it; the JAX packed scan runs at one
# width and has nothing to speculate
PORT_ADDS = {"elastic": set(), "packed": {("speculate", "phase")}}


def _kw(tmp, tag, packed, **kw):
    base = dict(
        debug=True, world_size=2, batch_size=64, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=256, packed=packed,
        device=0, superstep_window=2, straggler="3,1", probe_mode="always", trace="on",
        trace_dir=str(tmp / tag / "traces"), stat_dir=str(tmp / tag / "statis"),
        log_dir=str(tmp / tag / "logs"),
    )
    base.update(kw)
    return base


def _trace_file(cfg):
    return os.path.join(cfg.trace_dir, cfg.base_filename().format(0) + ".trace.json")


@pytest.fixture(scope="module", params=["off", "auto"], ids=["elastic", "packed"])
def traced(request, tmp_path_factory):
    """The JAX trainer and the port's, both traced, on one path."""
    tmp = tmp_path_factory.mktemp("obs")
    packed = request.param
    jcfg = JaxConfig(**_kw(tmp, "jax", packed))
    jtr = JaxTrainer(jcfg, bundle=jax_synthetic("mnist", n_train=256, n_test=64),
                     log_to_file=False)
    jtr.run()
    cfg = Config(**_kw(tmp, "torch", packed, trace_spool=str(tmp / "spool")))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=256, n_test=64), device="cpu",
                 log_to_file=False)
    tr.run()
    yield {"jtr": jtr, "jevents": load_trace(_trace_file(jcfg)), "tr": tr,
           "adds": PORT_ADDS["elastic" if packed == "off" else "packed"],
           "path": _trace_file(cfg), "events": load_trace(_trace_file(cfg)),
           "spool_dir": tmp / "spool", "tmp": tmp}
    jax_configure("off")
    configure("off")


def _names(events):
    return {(e["name"], e.get("cat")) for e in events if e.get("ph") != "M"}


def test_span_names_and_categories_equal_the_jax_trainers(traced):
    want = {nc for nc in _names(traced["jevents"]) if nc[0] not in PORT_LACKS}
    assert _names(traced["events"]) == want | traced["adds"]
    assert ("epoch", EPOCH_CAT) in want and ("probe", "probe") in want


def test_phases_attribute_each_epochs_wall(traced):
    att = attribution(traced["events"])
    assert sorted(att["epochs"]) == [0, 1]
    assert att["coverage_min"] >= 0.95
    for ep in att["epochs"].values():
        # speculate: the warm service's untimed tail (runtime/compiler.py)
        assert set(ep["phases"]) == {"plan_solve", "train", "speculate", "validate", "record"}
    assert jax_attribution(traced["events"]) == att


def test_spool_reads_back_with_a_torn_tail(traced, tmp_path):
    (spool,) = [p for p in os.listdir(traced["spool_dir"]) if p.endswith(".spool")]
    src = traced["spool_dir"] / spool
    full = read_spool(str(src))
    assert not full["truncated"] and full == jax_read_spool(str(src))

    def spans(rec):
        return [e[0] for _, evs in rec["segments"] for e in evs if e[2] == "X"]

    assert spans(full) == [e["name"] for e in traced["events"] if e.get("ph") == "X"]
    torn = tmp_path / "torn.spool"
    data = src.read_bytes()
    torn.write_bytes(data[: len(data) - 7])  # the last frame's body cut short
    got = read_spool(str(torn))
    assert got["truncated"] and got == jax_read_spool(str(torn))
    assert got["frames"] == full["frames"] - 1
    assert spans(got) == spans(full)[: len(spans(got))]


# ------------------------------------------------------------------- FLOPs

# FlopCounterMode counts MnistNet's products and convolutions (2 FLOPs a
# multiply-add), forward and the backward that the parameter gradients
# need: 2,595,000 FLOPs an example (conv1 0.288M forward + 0.288M for its
# weight gradient, conv2 0.64M + 1.28M, the two dense layers 0.033M +
# 0.066M). XLA's cost model counts the same products and, on top, every
# elementwise operation: relu, max-pool and its gradient, the softmax
# cross-entropy and its weighting, and the dropout masks, whose threefry
# random bits cost a few hundred integer operations for each of the
# ~1,330 draws an example (conv2's 1,280 outputs and the dense layer's 50).
# That is 0.5-1.3M more an example, so port / JAX lies in [0.6, 0.9], and
# below 1 in any case, as XLA counts everything FlopCounterMode counts.
# Measured: 0.6730 against the elastic worker step (JAX 3,855,620 an
# example) and 0.7820 against the packed step (3,318,448 an example).
FLOPS_RATIO = (0.6, 0.9)


def test_step_flops_against_the_jax_cost_model(traced):
    port = traced["tr"]._flops_per_example
    jax_ = traced["jtr"]._flops_per_padded_example
    assert port == 2_595_000.0
    assert FLOPS_RATIO[0] <= port / jax_ <= FLOPS_RATIO[1], port / jax_
    series = traced["tr"].recorder.data
    rows = 256  # every example of the epoch, at its true width
    assert series["flops_per_epoch"] == [port * rows] * 2
    assert "mfu_bf16_peak" not in series  # no card, no peak


def test_no_peak_and_no_mfu_without_a_card():
    assert chip_peak_flops() is None and chip_peak_flops("cpu") is None
    assert mfu(1e12) is None and mfu(None) is None


def test_recorder_extras_equal_the_jax_trainers(traced):
    got, want = traced["tr"].recorder.data, traced["jtr"].recorder.data
    for k in ("comm_bytes_ici", "comm_bytes_dcn", "probe_time"):
        assert k in got and len(got[k]) == len(want[k]) == 2, k
    assert got["comm_bytes_ici"] == want["comm_bytes_ici"]
    assert got["comm_bytes_dcn"] == want["comm_bytes_dcn"] == [0.0, 0.0]
    assert len(got["host_dispatch_s"]) == 2


def test_registry_snapshot(traced):
    snap = traced["tr"].obs.snapshot()
    assert snap["trace"]["mode"] == "on" and snap["trace"]["events"] > 0
    assert snap["recorder"]["epoch"] == 1 and snap["memory"]["source"] == "host_rss"
    assert snap["comm"]["comm_bytes_ici"] > 0 and "host" in snap
    # the warm service's surfaces, under the JAX registry's keys
    assert set(snap["compiles"]) == {"total", "background", "foreground"}
    assert snap["aot"]["pending"] == 0 and snap["aot"]["failed"] == 0
    with pytest.raises(ValueError):
        MetricsRegistry().attach(aot_servce=object())


# -------------------------------------------------------------- graftscope


def linear_time(plan):
    return np.array([float(w.batch_size * w.steps) for w in plan.workers])


@pytest.fixture(scope="module")
def window_run(tmp_path_factory):
    """A window-cadence run (the sin schedule switches it), traced and
    spooled, under a timing model."""
    tmp = tmp_path_factory.mktemp("window")
    cfg = Config(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=1024, packed="off",
        superstep_window=2, straggler="8,1,1,1", fault_schedule="sin", fault_period=1.0,
        rebalance="window", trace="on", trace_dir=str(tmp / "traces"),
        trace_spool=str(tmp / "spool"), stat_dir=str(tmp / "statis"), log_dir=str(tmp / "logs"),
    )
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=1024, n_test=128),
                 timing_model=linear_time, device="cpu", log_to_file=False)
    tr.run()
    yield tr, _trace_file(cfg), str(tmp / "spool")
    configure("off")


def test_scope_cli_prints_what_the_jax_one_prints(window_run):
    tr, path, spool = window_run
    assert tr._rebalance_ctl.switches >= 1
    assert scope_cli.summarize(path) == jax_scope.summarize(path)
    assert scope_cli.summarize(path, as_json=True) == jax_scope.summarize(path, as_json=True)
    for src in (path, spool):
        assert scope_cli.decisions(src) == jax_scope.decisions(src)
        got, ok = scope_cli.replay_cmd(src, {})
        want, jok = jax_scope.replay_cmd(src, {})
        assert ok and jok and got == want


def test_replay_of_the_spool_keeps_every_verdict(window_run):
    tr, _, spool = window_run
    report = replaylab.replay(replaylab.load_corpus(spool))
    assert report["parity"] and report["invariant_violations"] == []
    assert report["replayed"]["switches"] == tr._rebalance_ctl.switches


def test_postmortem_reads_the_spool(window_run, tmp_path):
    _, _, spool = window_run
    d = tmp_path / "pm"
    shutil.copytree(spool, d)
    rep = json.loads(scope_cli.postmortem(str(d), as_json=True))
    want = json.loads(jax_scope.postmortem(str(d), as_json=True))
    assert rep["processes"] and rep == want


def test_conformance_exits_2_naming_what_it_needs(capsys):
    assert scope_cli.main(["conformance", "."]) == 2
    err = capsys.readouterr().err
    assert "analysis/flow/proto.py" in err and "rendezvous" in err


# ------------------------------------------------------------ wall feedback


class FakeEvent:
    """A CUDA event stand-in: the n-th recorded event sits at 0.4 n s."""

    count = 0

    def record(self):
        FakeEvent.count += 1
        self.t = 0.4 * FakeEvent.count

    def elapsed_time(self, end):
        return (end.t - self.t) * 1e3  # milliseconds, as CUDA's


def _window_trainer(tmp_path):
    cfg = Config(
        debug=True, world_size=4, batch_size=128, learning_rate=0.05, epoch_size=2,
        dataset="mnist", model="mnistnet", seed=1234, bucket=8, n_train=1024, packed="off",
        superstep_window=2, straggler="8,1,1,1", fault_schedule="sin", fault_period=1.0,
        rebalance="window", stat_dir=str(tmp_path / "statis"), log_dir=str(tmp_path / "logs"),
    )
    return Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=1024, n_test=128),
                   device="cpu", log_to_file=False)


@pytest.mark.parametrize("events", [True, False], ids=["card-events", "cpu"])
def test_observe_wall_gets_the_card_time_or_the_jax_formula(tmp_path, monkeypatch, events):
    seen, walls = [], []
    real_observe = OnlineRebalanceController.observe_wall
    monkeypatch.setattr(OnlineRebalanceController, "observe_wall",
                        lambda self, m, p: (seen.append(m), real_observe(self, m, p)))
    real_wall = Trainer._window_wall

    def window_wall(self, now, since, host_s):
        walls.append((now, since, host_s, real_wall(self, now, since, host_s)))
        return walls[-1][3]

    monkeypatch.setattr(Trainer, "_window_wall", window_wall)
    tr = _window_trainer(tmp_path)
    if events:
        FakeEvent.count = 0
        tr._window_timer = DeviceWindowTimer("cpu", event_factory=FakeEvent)
    assert tr._window_timer.active == events
    tr.run()
    evals = tr.recorder.meta["rebalance_evals"]
    observed = [e for e in evals if e["measured_s"] is not None]
    # the second evaluation of each epoch (the first has no steps behind it)
    assert len(observed) == len(seen) == len(walls) == 2
    assert [e["measured_s"] for e in observed] == seen
    assert [e["wall_scale"] for e in evals][-1] == tr._rebalance_ctl.wall_scale
    for m, (now, since, host_s, wall) in zip(seen, walls):
        assert m == max(wall, 1e-9)
        if events:  # two evaluations apart: the events 0.4 s apart
            assert wall == pytest.approx(0.4)
        else:  # the host's wall less its launch seconds, as the JAX trainer
            assert wall == now - since - host_s and host_s > 0


# ------------------------------------------------------------- the profiler


def test_profile_dir_writes_a_chrome_trace(tmp_path):
    cfg = Config(**_kw(tmp_path, "prof", "auto", epoch_size=1, trace="off",
                       profile_dir=str(tmp_path / "prof")))
    tr = Trainer(cfg, bundle=synthetic_dataset("mnist", n_train=128, n_test=64), device="cpu",
                 log_to_file=False)
    tr.run()
    with open(tr.recorder.meta["profile_trace"]) as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any("conv" in str(n) for n in names)


def test_annotations_put_spans_into_the_profiler():
    tracer = Tracer(mode="on", annotations=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("dispatch_window", cat="dispatch"):
            torch.ones(4).add_(1)
    assert "dispatch_window" in {e.name for e in prof.events()}
    assert [e[0] for e in tracer.events()] == ["dispatch_window"]
