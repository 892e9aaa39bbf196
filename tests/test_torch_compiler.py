"""The port's warm service (``runtime/compiler.py``) on the CPU.

- The service alone, over a ``StepGraphs`` whose graphs are recorded, not
  launched (``ReplayGraph``: the capture keeps the step, a replay runs it):
  dedup (a second submit of a key, or a key the executor holds, is a
  lookup), ``wait`` on some keys or all, ``pending``, ``compile_now``,
  ``get``, ``count_keys``, ``clear``, ``stats`` with the speculative hits
  and misses, and a failing capture that raises with its key, stays known
  as failed and leaves no entry.
- ``CaptureTracker`` counts foreground captures only.
- ``balance/solver.py`` ``ShareTrajectoryPredictor`` against the JAX
  class, bit for bit, over seeded share trajectories, through a change of
  world size, and the same ``ValueError`` on an infeasible cap.
- The speculated batch tuples: the port trainer's ``_speculate_scan_tuple``
  against the JAX trainer's (its predictor, its ``_build_plan`` and its
  keys' padded widths, host-side only), on the same share trajectories,
  and re-aimed at the window controller's last candidate.
- The registry: the snapshot's ``compiles`` and ``aot`` keys are the JAX
  registry's.

No test here reads a clock.
"""

import types

import numpy as np
import pytest
import torch

from dynamic_load_balance_distributeddnn_tpu.balance.solver import (
    ShareTrajectoryPredictor as JaxPredictor,
)
from dynamic_load_balance_distributeddnn_tpu.config import Config as JaxConfig
from dynamic_load_balance_distributeddnn_tpu.data.datasets import (
    synthetic_dataset as jax_synthetic,
)
from dynamic_load_balance_distributeddnn_tpu.obs.registry import (
    MetricsRegistry as JaxRegistry,
)
from dynamic_load_balance_distributeddnn_tpu.runtime.compiler import (
    AOTCompileService as JaxService,
)
from dynamic_load_balance_distributeddnn_tpu.train import Trainer as JaxTrainer
from dynamic_load_balance_distributeddnn_tpu_torch.balance import ShareTrajectoryPredictor
from dynamic_load_balance_distributeddnn_tpu_torch.config import Config
from dynamic_load_balance_distributeddnn_tpu_torch.data import synthetic_dataset
from dynamic_load_balance_distributeddnn_tpu_torch.obs import MetricsRegistry
from dynamic_load_balance_distributeddnn_tpu_torch.runtime.compiler import (
    AOTCompileService,
    CaptureTracker,
)
from dynamic_load_balance_distributeddnn_tpu_torch.train.engine import Trainer
from dynamic_load_balance_distributeddnn_tpu_torch.train.supersteps import StepGraphs
from tests._torch_helpers import one_torch_thread  # noqa: F401  (autouse)


class ReplayGraph:
    """A CUDA graph's contract on the CPU: the capture records the step and
    runs nothing, each replay runs it."""

    def __init__(self, executor):
        self.fn = None

    def capture(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def _service():
    graphs = StepGraphs("cpu", graph_factory=ReplayGraph)
    return graphs, AOTCompileService(graphs)


def _job(seen):
    """A body and warm-up that record the steps they run."""

    def body(inputs, counts):
        seen.append(("body", float(inputs[0][0].sum())))

    def warm(inputs, counts):
        seen.append(("warm", float(inputs[0][0].sum())))

    return body, warm


# ------------------------------------------------------------ the service


def test_dedup_wait_pending_and_stats():
    graphs, svc = _service()
    seen = []
    body, warm = _job(seen)
    assert svc.submit("a", [(torch.zeros(2),)], [False], body, warm)
    assert not svc.submit("a", [(torch.zeros(2),)], [False], body, warm)  # a lookup
    assert svc.submit("b", [(torch.zeros(3),)], [False], body, warm)
    assert svc.pending() == 2 and svc.has("a") and not graphs.has("a")
    assert seen == []  # nothing is captured at submission
    assert svc.wait(["b"]) == ["b"] and svc.pending() == 1
    assert graphs.has("b") and not graphs.has("a")
    assert svc.wait() == ["a"] and svc.pending() == 0 and svc.wait() == []
    assert seen == [("warm", 0.0), ("warm", 0.0)]  # warm-ups ran, the captures ran nothing
    assert not svc.submit("a", None, [False], body, warm)
    st = svc.stats()
    assert (st["submitted"], st["deduped"], st["captured"], st["failed"], st["pending"]) == (
        2, 2, 2, 0, 0)
    assert graphs.stats()["service_captures"] == 2 and graphs.foreground_captures == 0
    assert svc.keys() == ["a", "b"] and svc.get("a") is graphs._entries["a"]


def test_a_key_the_executor_holds_is_a_lookup():
    graphs, svc = _service()
    body, warm = _job([])
    graphs.run("k", [(torch.ones(2),)], [0], body, warm)  # a foreground capture
    assert not svc.submit("k", None, [False], body, warm)
    assert svc.stats()["deduped"] == 1 and svc.get("k") is None and svc.pending() == 0
    assert CaptureTracker(graphs).take() == 0  # counted from the tracker's start


def test_compile_now_count_keys_and_clear():
    graphs, svc = _service()
    body, warm = _job([])
    svc.compile_now(("elastic", 1), [(torch.zeros(1),)], [False], body, warm)
    svc.submit(("packed", 2), [(torch.zeros(1),)], [False], body, warm)
    assert graphs.has(("elastic", 1)) and svc.pending() == 1
    assert svc.count_keys(("elastic",)) == 1 and svc.count_keys(("packed",)) == 0
    svc.clear()
    assert svc.pending() == 0 and svc.keys() == [] and not svc.has(("packed", 2))
    assert svc.submit(("packed", 2), [(torch.zeros(1),)], [False], body, warm)


def test_speculative_hits_and_misses():
    graphs, svc = _service()
    seen = []
    body, warm = _job(seen)
    for k in ("hit", "miss"):
        svc.submit(k, [(torch.zeros(2),)], [False], body, warm, speculative=True)
    svc.wait()
    graphs.run("hit", [(torch.full((2,), 2.0),)], [0], body, warm)
    graphs.run("hit", [(torch.full((2,), 3.0),)], [0], body, warm)
    st = svc.stats()
    assert (st["speculative"], st["speculative_captured"], st["speculative_hits"],
            st["speculative_misses"]) == (2, 2, 1, 1)
    # the prepared slots took each step's batch before the replay
    assert seen[-2:] == [("body", 4.0), ("body", 6.0)]
    assert graphs.foreground_captures == 0 and graphs.replays == 2


def test_a_failed_capture_raises_with_its_key():
    graphs, svc = _service()

    def body(inputs, counts):
        raise RuntimeError("operation not permitted when stream is capturing")

    class Failing(ReplayGraph):
        def capture(self, fn):
            fn()

    graphs._factory = Failing
    svc.submit(("elastic", 7), [(torch.zeros(1),)], [False], body, lambda i, c: None)
    with pytest.raises(RuntimeError, match=r"\('elastic', 7\)"):
        svc.wait()
    assert svc.failed(("elastic", 7)) and not graphs.has(("elastic", 7))
    assert svc.pending() == 0 and svc.stats()["failed"] == 1 and svc.get(("elastic", 7)) is None
    assert not svc.submit(("elastic", 7), None, [False], body, lambda i, c: None)  # known


def test_the_tracker_counts_foreground_captures():
    graphs, svc = _service()
    tracker = CaptureTracker(graphs)
    body, warm = _job([])
    svc.compile_now("a", [(torch.zeros(1),)], [False], body, warm)
    graphs.run("a", [(torch.zeros(1),)], [0], body, warm)
    assert tracker.take() == 0
    graphs.run("b", [(torch.zeros(1),)], [0], body, warm)
    assert tracker.take() == 1 and tracker.take() == 0
    st = graphs.stats()
    assert (st["captures"], st["service_captures"], st["foreground_captures"]) == (2, 1, 1)


# ------------------------------------------------------------- predictor


def _trajectory(rng, n, ws):
    shares = rng.dirichlet(np.ones(ws))
    out = [shares]
    for _ in range(n - 1):
        shares = np.clip(shares + rng.normal(0, 0.03, ws), 0.01, None)
        out.append(shares / shares.sum())
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("alpha", [0.5, 1.0, 0.25])
def test_predictor_equals_the_jax_class_bit_for_bit(seed, alpha):
    rng = np.random.default_rng(seed)
    port, jax = ShareTrajectoryPredictor(alpha), JaxPredictor(alpha)
    assert port.predict() is None and jax.predict() is None
    # a change of world size restarts the track on both
    for shares in _trajectory(rng, 6, 4) + _trajectory(rng, 4, 3):
        port.observe(shares)
        jax.observe(shares)
        np.testing.assert_array_equal(port.predict(), jax.predict())
        for bucket, cap, B in ((0, None, 512), (16, 0.5, 512), (8, 0.75, 128), (4, 1.0, 40)):
            np.testing.assert_array_equal(port.predict_batches(B, bucket=bucket, max_share=cap),
                                          jax.predict_batches(B, bucket=bucket, max_share=cap))


def test_predictor_raises_as_the_jax_class_on_an_infeasible_cap():
    for cls in (ShareTrajectoryPredictor, JaxPredictor):
        p = cls()
        p.observe(np.full(4, 0.25))
        with pytest.raises(ValueError, match="infeasible"):
            p.predict_batches(512, bucket=16, max_share=0.2)
        with pytest.raises(ValueError):
            cls(alpha=0.0)


# --------------------------------------------- speculated tuples against JAX


def _kw(**kw):
    base = dict(debug=True, world_size=4, batch_size=64, learning_rate=0.05, epoch_size=4,
                dataset="mnist", model="mnistnet", dynamic_batch_size=True, seed=11, bucket=8,
                packed="off", device=0, superstep="auto", warm_start=True, aot_warm=True,
                aot_speculate=True, speculate_scan=True, n_train=512)
    base.update(kw)
    return base


@pytest.fixture(scope="module")
def trainers():
    jtr = JaxTrainer(JaxConfig(**_kw()), bundle=jax_synthetic("mnist", n_train=512, n_test=64),
                     log_to_file=False)
    tr = Trainer(Config(**_kw()), bundle=synthetic_dataset("mnist", n_train=512, n_test=64),
                 device="cpu", log_to_file=False)
    return jtr, tr


def _speculated(jtr, tr, trajectory, candidate=None):
    """The padded widths the JAX trainer's ``_speculate_scan_tuple`` queues,
    and the full-step batch tuples the port's submits."""
    jcalls, calls = [], []
    jtr._aot_submit_superstep = lambda padded, win, speculative=False: (
        jcalls.append(tuple(int(b) for b in padded)) or [])
    tr._aot_submit = lambda path, pairs, lr=None, speculative=False: (
        calls.extend(rows for rows, _ in pairs) or [])
    jtr._share_predictor, tr._share_predictor = JaxPredictor(), ShareTrajectoryPredictor()
    jtr._rebalance_ctl = tr._rebalance_ctl = (
        None if candidate is None else types.SimpleNamespace(last_candidate_batches=candidate))
    for shares in trajectory:
        jtr._share_predictor.observe(shares)
        tr._share_predictor.observe(shares)
    tr._epoch_flags = {("elastic", (False,) * 4)}
    jtr._speculate_scan_tuple()
    tr._speculate_scan_tuple(0)
    return set(jcalls), {c for c in calls if all(c)}


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_speculated_tuples_equal_the_jax_trainers(trainers, seed):
    jtr, tr = trainers
    assert jtr._elastic_mode() == tr._elastic_mode() == "scan"
    traj = _trajectory(np.random.default_rng(seed), 3, 4)
    want, got = _speculated(jtr, tr, traj)
    assert want and got == want  # bucketed: a worker's full-step rows are its padded width


def test_speculation_re_aims_at_the_controllers_candidate(trainers):
    jtr, tr = trainers
    cand = np.array([8, 16, 16, 24], dtype=np.int64)
    want, got = _speculated(jtr, tr, _trajectory(np.random.default_rng(5), 3, 4), candidate=cand)
    assert got == want == {(8, 16, 16, 24)}


# ---------------------------------------------------------------- registry


def test_registry_keys_equal_the_jax_registrys():
    jsvc = JaxService(workers=1)
    try:
        want = JaxRegistry().attach(aot_service=jsvc).snapshot()
    finally:
        jsvc.close()
    graphs, svc = _service()
    got = MetricsRegistry().attach(aot_service=svc, compile_tracker=CaptureTracker(graphs)).snapshot()
    assert set(got) == set(want)
    assert set(got["compiles"]) == set(want["compiles"]) == {"total", "background", "foreground"}
    assert {"submitted", "deduped", "failed", "speculative"} <= set(got["aot"]) & set(want["aot"])
    assert "compiles" in MetricsRegistry().snapshot()  # always there, as in the JAX registry
