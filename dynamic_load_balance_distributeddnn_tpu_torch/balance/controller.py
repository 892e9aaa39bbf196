"""The window-cadence online rebalance controller (the JAX package's
``balance/controller.py``, copied).

The reference re-solves the inverse-time partition once an epoch, so a
straggler that appears mid-epoch is paid for until the next boundary. This
controller runs at window boundaries inside the elastic epoch
(``--rebalance window``) and decides when a switch of the remaining windows
onto a new plan is worth its cost.

Signal path (engine -> controller):

* **EMA per-worker rates**, seconds an example per worker, seeded from the
  engine's probe anchors (``per_example_cost``) or its last multiplier-free
  compute vector and folded with ``observe_rates`` at each evaluation;
* **the schedule's factors at the next window's midpoint**, the injector's
  ``faults_at``, which the engine composes into the effective rates it
  hands ``propose``;
* **measured wall feedback**: the wall of the windows since the last
  evaluation against the model's prediction, folded in as a bounded scale
  (``observe_wall``), which moves the absolute win estimate without
  changing the relative allocation.

Decision rule (hysteresis and a regret budget):

    switch  iff  candidate != current plan
            and  win >= hysteresis * predicted remaining time   (relative)
            and  win >= margin * switch_cost                    (absolute)
            and  spent + switch_cost <= budget_frac * (credit + win)

with ``win = (step_time(current) - step_time(candidate)) * remaining_steps``
under the per-device step-time model, ``switch_cost`` the EMA of measured
switch costs (seeded by ``cost_init``), and (spent, credit) the cumulative
ledgers. Every evaluation, hold or switch, goes into the decision journal
with the inputs it was decided on, which ``balance/replaylab.py`` replays.

Each decision is also mirrored as a graftscope ``decision`` instant when
tracing is on (``obs/trace.py``), so a trace or a ``--trace_spool`` spool
alone is a replayable corpus. This port compiles nothing ahead of time, so the engine never
defers a switch; ``note_deferred`` stays for journals recorded elsewhere.
Everything here is host-side numpy.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Dict, List, Optional, Sequence

import numpy as np
# np.median (observe_rates) imports numpy.ma on its first call, which took
# 80 ms on the card's host (scripts/window_profile.py); importing it here
# keeps that one-time cost out of the evaluation the engine times
import numpy.ma  # noqa: F401

from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import (
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import get_tracer

# decision-journal ring cap: one entry per controller evaluation; a week-long
# run at window cadence stays bounded, and the postmortem question ("why did
# epoch 7 rebalance?") only ever needs the recent tail
JOURNAL_CAP = 4096


@dataclasses.dataclass
class SwitchDecision:
    """One evaluation's outcome. ``switch`` is the controller's verdict; the
    engine may still defer (cold executables) via ``note_deferred``."""

    switch: bool
    reason: str
    candidate_batches: Optional[np.ndarray] = None
    candidate_shares: Optional[np.ndarray] = None
    predicted_win_s: float = 0.0
    cur_step_s: float = 0.0
    new_step_s: float = 0.0
    cost_est_s: float = 0.0
    remaining_steps: int = 0


def step_time(
    rates: np.ndarray,
    batches: np.ndarray,
    groups: Sequence[Sequence[int]],
    comm_s: float = 0.0,
) -> float:
    """Modeled per-step wall under a batch split: workers sharing a device
    serialize (sum), devices run in parallel (max) — the elastic dispatch
    topology's cost model. ``comm_s`` is the gradient-collective wall the
    step pays after the slowest device finishes its compute:
    batch-split-independent (the wire moves the same bytes whatever the
    shares), so it is additive — it shifts both modeled walls equally and
    therefore damps the RELATIVE win (hysteresis sees win/cur_step), keeping
    the controller honest on comm-bound topologies where a compute
    rebalance buys less of the step than the compute-only model claims."""
    r = np.asarray(rates, dtype=np.float64)
    b = np.asarray(batches, dtype=np.float64)
    per_worker = r * b
    compute = float(
        max(sum(per_worker[w] for w in g) for g in groups if len(g))
    )
    return compute + max(float(comm_s), 0.0)


class OnlineRebalanceController:
    """Window-cadence hysteresis controller over the inverse-time solver."""

    def __init__(
        self,
        world_size: int,
        global_batch: int,
        groups: Sequence[Sequence[int]],
        *,
        bucket: int = 0,
        max_share: Optional[float] = None,
        hysteresis: float = 0.1,
        margin: float = 3.0,
        budget_frac: float = 0.5,
        rate_alpha: float = 0.5,
        cost_init: float = 0.01,
        logger=None,
    ):
        if not 0.0 < rate_alpha <= 1.0:
            raise ValueError("rate_alpha must be in (0, 1]")
        if hysteresis < 0.0 or margin < 0.0 or budget_frac <= 0.0:
            raise ValueError("hysteresis/margin must be >= 0, budget_frac > 0")
        self.world_size = int(world_size)
        self.global_batch = int(global_batch)
        self.groups = [list(g) for g in groups if len(g)]
        self.bucket = int(bucket)
        self.max_share = float(max_share) if max_share is not None else None
        self.hysteresis = float(hysteresis)
        self.margin = float(margin)
        self.budget_frac = float(budget_frac)
        self.rate_alpha = float(rate_alpha)
        self.cost_init = float(cost_init)
        self.logger = logger
        # modeled per-step gradient-collective wall (seconds); 0.0 is the
        # compute-only model, which is what one process with a flat combine
        # has (the engine's _modeled_comm_step_s)
        self.comm_step_s = 0.0
        # EMA state
        self.rates: Optional[np.ndarray] = None  # seconds/example per worker
        self.wall_scale = 1.0  # bounded measured/modeled wall feedback
        self.switch_cost_s: Optional[float] = None  # EMA of measured costs
        # ledgers (the regret-style account)
        self.spent_s = 0.0  # switch cost actually paid
        self.credit_s = 0.0  # predicted wins banked at executed switches
        self.switches = 0
        self.evals = 0
        self.deferred = 0  # engine vetoes (candidate executables cold)
        self.last_candidate_batches: Optional[np.ndarray] = None
        self.events: List[Dict] = []
        self.on_switch = None  # test/observability hook: fn(event_dict)
        # decision journal: EVERY evaluation's verdict — hold or switch —
        # with the inputs it was decided on, so "why did epoch 7
        # rebalance?" (and "why did it NOT?") is answerable offline.
        # Ring-bounded; mirrored as graftscope ``decision`` instants when
        # tracing is enabled.
        self.journal: deque = deque(maxlen=JOURNAL_CAP)
        # ring evictions: a replayed corpus must be honest about truncation —
        # a journal that silently lost its head is not the full history
        self.journal_dropped = 0
        # engine-owned position tag ({"epoch": e, "window": w}) merged into
        # every journal entry at decision time, so HOLD verdicts carry their
        # epoch too (commit() only annotates executed switches)
        self._config_traced = False
        self.eval_context: Dict = {}

    # ---------------------------------------------------------- replay seam

    def journal_config(self) -> Dict:
        """The construction surface a replay needs to rebuild THIS controller
        (balance/replaylab.py): topology + knobs, JSON-safe. Carried in
        ``snapshot(include_journal=True)`` and (once, lazily) as a
        ``dbs_config`` trace instant, so snapshots, spools and traces are
        self-describing corpora."""
        return {
            "world_size": self.world_size,
            "global_batch": self.global_batch,
            "groups": [list(g) for g in self.groups],
            "bucket": self.bucket,
            "max_share": self.max_share,
            "hysteresis": self.hysteresis,
            "margin": self.margin,
            "budget_frac": self.budget_frac,
            "rate_alpha": self.rate_alpha,
            "cost_init": self.cost_init,
        }

    @classmethod
    def from_journal_config(
        cls, config: Dict, **knob_overrides
    ) -> "OnlineRebalanceController":
        """Rebuild a fresh controller from a recorded ``journal_config()``,
        optionally overriding the decision knobs (hysteresis / margin /
        budget_frac / rate_alpha / cost_init) for counterfactual replay."""
        kw = {
            "bucket": int(config.get("bucket", 0)),
            "max_share": config.get("max_share"),
            "hysteresis": float(config.get("hysteresis", 0.1)),
            "margin": float(config.get("margin", 3.0)),
            "budget_frac": float(config.get("budget_frac", 0.5)),
            "rate_alpha": float(config.get("rate_alpha", 0.5)),
            "cost_init": float(config.get("cost_init", 0.01)),
        }
        for k, v in knob_overrides.items():
            if k not in kw:
                raise ValueError(f"unknown controller knob override: {k!r}")
            if v is not None:
                kw[k] = float(v)
        return cls(
            int(config["world_size"]),
            int(config["global_batch"]),
            [list(g) for g in config["groups"]],
            **kw,
        )

    # ------------------------------------------------------------- signal

    def observe_rates(self, rates: np.ndarray) -> None:
        """Fold a fresh per-worker per-example rate estimate into the EMA
        (``rate_alpha`` weights the newest sample). A world-size change
        restarts the track — stale per-worker identities mean nothing."""
        r = np.asarray(rates, dtype=np.float64)
        if not np.isfinite(r).all() or (r <= 0).any():
            return
        if self.rates is None or self.rates.shape != r.shape:
            self.rates = r.copy()
            return
        scale = float(np.median(r) / max(np.median(self.rates), 1e-300))
        if not 0.25 <= scale <= 4.0:
            # a whole-track scale jump is a re-anchoring (fresh probe
            # baseline, clock regime change), not a gradual drift — folding
            # it through the EMA would leave the absolute win estimates at
            # the wrong scale for a half-life of evaluations
            self.rates = r.copy()
            return
        self.rates = self.rate_alpha * r + (1.0 - self.rate_alpha) * self.rates

    def observe_wall(self, measured_s: float, modeled_s: float) -> None:
        """Step-wall feedback: the measured wall of the windows since the
        last evaluation vs the model's prediction for the same windows. The
        bounded ratio scales the ABSOLUTE win estimate (a uniformly slow or
        fast host moves every worker the same way — the relative allocation
        stays with the rates); the clip keeps one outlier wall from swinging
        the hysteresis decision."""
        if modeled_s <= 0 or measured_s <= 0 or not np.isfinite(measured_s):
            return
        scale = float(np.clip(measured_s / modeled_s, 0.25, 4.0))
        self.wall_scale = 0.5 * scale + 0.5 * self.wall_scale

    # ----------------------------------------------------------- decision

    def cost_estimate(self) -> float:
        return self.switch_cost_s if self.switch_cost_s is not None else self.cost_init

    def _record_decision(
        self,
        dec: SwitchDecision,
        eff_rates: Optional[np.ndarray] = None,
        cur_batches: Optional[np.ndarray] = None,
    ) -> SwitchDecision:
        """Journal one evaluation: verdict + the inputs it was decided on
        (EMA rates, modeled walls, regret ledgers, hysteresis state). Also
        emitted as a graftscope ``decision`` instant so the flight
        recorder's spool carries the journal."""
        ev: Dict = {
            "eval": int(self.evals),
            "switch": bool(dec.switch),
            "reason": dec.reason,
            "predicted_win_s": round(float(dec.predicted_win_s), 6),
            "cur_step_s": round(float(dec.cur_step_s), 6),
            "new_step_s": round(float(dec.new_step_s), 6),
            "cost_est_s": round(float(dec.cost_est_s), 6),
            "remaining_steps": int(dec.remaining_steps),
            # replay INPUTS (balance/replaylab.py restores these before
            # re-proposing): full precision, NOT rounded — JSON round-trips
            # float64 exactly, and the decision gates sit at exact
            # equalities often enough that a 1e-6 display round flips
            # borderline verdicts and breaks bit-for-bit parity
            "wall_scale": float(self.wall_scale),
            "comm_step_s": float(self.comm_step_s),
            "hysteresis": self.hysteresis,
            "margin": self.margin,
            "budget_frac": self.budget_frac,
            "spent_s": float(self.spent_s),
            "credit_s": float(self.credit_s),
            "switch_cost_ema_s": (
                float(self.switch_cost_s)
                if self.switch_cost_s is not None
                else None
            ),
        }
        for k, v in self.eval_context.items():
            ev.setdefault(k, v)
        if eff_rates is not None:
            ev["eff_rates"] = [float(r) for r in eff_rates]
        if cur_batches is not None:
            ev["cur_batches"] = [int(b) for b in cur_batches]
        if dec.candidate_batches is not None:
            ev["candidate_batches"] = [int(b) for b in dec.candidate_batches]
        if dec.candidate_shares is not None:
            ev["candidate_shares"] = [
                round(float(s), 6) for s in dec.candidate_shares
            ]
        if len(self.journal) == self.journal.maxlen:
            self.journal_dropped += 1
        self.journal.append(ev)
        tracer = get_tracer()
        if tracer.enabled:
            if not self._config_traced:
                # once per controller: the construction surface, so a spool
                # or trace file alone is a replayable corpus
                self._config_traced = True
                tracer.instant("dbs_config", cat="decision", args=self.journal_config())
            # a COPY: commit/note_deferred annotate the journal entry later,
            # and the trace must keep the verdict as decided
            args = dict(ev)
            if self.journal_dropped:
                args["journal_dropped"] = self.journal_dropped
            tracer.instant("dbs_decision", cat="decision", args=args)
        return dec

    def decision_journal(self) -> List[Dict]:
        """The journal as a JSON-safe list (oldest first, ring-bounded)."""
        return [dict(ev) for ev in self.journal]

    def propose(
        self,
        eff_rates: np.ndarray,
        cur_batches: np.ndarray,
        remaining_steps: int,
    ) -> SwitchDecision:
        """One evaluation: solve the inverse-time partition on the effective
        rates and decide whether switching the remaining windows onto it
        beats the measured switch cost under hysteresis + budget."""
        self.evals += 1
        c = np.asarray(eff_rates, dtype=np.float64)
        b_cur = np.asarray(cur_batches, dtype=np.int64)
        if remaining_steps <= 0:
            return self._record_decision(SwitchDecision(False, "no-horizon"))
        if not np.isfinite(c).all() or (c <= 0).any():
            return self._record_decision(SwitchDecision(False, "no-signal"))
        cur_shares = b_cur.astype(np.float64) / max(b_cur.sum(), 1)
        times = c * np.maximum(b_cur, 1)
        new_shares, batches = rebalance(
            times, cur_shares, self.global_batch, max_share=self.max_share
        )
        if self.bucket > 0:
            batches = quantize_batches(batches, self.bucket, self.global_batch)
            new_shares = batches.astype(np.float64) / batches.sum()
        self.last_candidate_batches = batches.copy()
        if np.array_equal(batches, b_cur):
            return self._record_decision(
                SwitchDecision(
                    False, "same-plan", batches, new_shares,
                    remaining_steps=int(remaining_steps),
                ),
                c, b_cur,
            )
        cur_step = (
            step_time(c, b_cur, self.groups, comm_s=self.comm_step_s)
            * self.wall_scale
        )
        new_step = (
            step_time(c, batches, self.groups, comm_s=self.comm_step_s)
            * self.wall_scale
        )
        win = (cur_step - new_step) * remaining_steps
        cost = self.cost_estimate()
        dec = SwitchDecision(
            False,
            "",
            batches,
            new_shares,
            predicted_win_s=win,
            cur_step_s=cur_step,
            new_step_s=new_step,
            cost_est_s=cost,
            remaining_steps=int(remaining_steps),
        )
        if win < self.hysteresis * cur_step * remaining_steps:
            dec.reason = "below-hysteresis"
            return self._record_decision(dec, c, b_cur)
        if win < self.margin * cost:
            dec.reason = "below-margin"
            return self._record_decision(dec, c, b_cur)
        if self.spent_s + cost > self.budget_frac * (self.credit_s + win):
            dec.reason = "budget-exhausted"
            return self._record_decision(dec, c, b_cur)
        dec.switch = True
        dec.reason = "switch"
        return self._record_decision(dec, c, b_cur)

    # --------------------------------------------------------- bookkeeping

    def commit(
        self, dec: SwitchDecision, measured_cost_s: float, **extra
    ) -> Dict:
        """The engine EXECUTED the switch: pay the measured cost into the
        ledger, bank the predicted win, fold the cost EMA, and record the
        event (the engine mirrors it into the recorder's meta)."""
        self.switches += 1
        self.spent_s += float(measured_cost_s)
        self.credit_s += max(float(dec.predicted_win_s), 0.0)
        prev = self.switch_cost_s
        self.switch_cost_s = (
            float(measured_cost_s)
            if prev is None
            else 0.5 * float(measured_cost_s) + 0.5 * prev
        )
        ev = {
            "reason": dec.reason,
            "predicted_win_s": round(float(dec.predicted_win_s), 6),
            "switch_cost_s": round(float(measured_cost_s), 6),
            "cur_step_s": round(float(dec.cur_step_s), 6),
            "new_step_s": round(float(dec.new_step_s), 6),
            "remaining_steps": int(dec.remaining_steps),
            "batches": [int(b) for b in dec.candidate_batches],
            "spent_s": round(self.spent_s, 6),
            "credit_s": round(self.credit_s, 6),
        }
        ev.update(extra)
        self.events.append(ev)
        if self.journal:
            # annotate the evaluation that produced this switch with what
            # actually happened (the engine may defer/veto between the two)
            self.journal[-1]["outcome"] = "committed"
            self.journal[-1]["measured_cost_s"] = round(float(measured_cost_s), 6)
            for k in ("epoch", "window", "step"):
                if k in extra:
                    self.journal[-1][k] = extra[k]
        tracer = get_tracer()
        if tracer.enabled:
            tracer.instant("dbs_switch", cat="decision", args=dict(ev))
        if self.logger is not None:
            self.logger.info(
                f"online-dbs: switched plan -> {ev['batches']} "
                f"(win {ev['predicted_win_s']}s over {ev['remaining_steps']} "
                f"steps, cost {ev['switch_cost_s']}s)"
            )
        if self.on_switch is not None:
            self.on_switch(ev)
        return ev

    def note_deferred(self) -> None:
        """A verdict-positive switch the engine vetoed because the candidate
        executables were still compiling (warm gating): the hysteresis
        re-evaluates at the next cadence boundary, by which time the
        speculative submit issued alongside the verdict has usually landed."""
        self.deferred += 1
        if self.journal:
            self.journal[-1]["outcome"] = "deferred"
        tracer = get_tracer()
        if tracer.enabled:
            tracer.instant("dbs_deferred", cat="decision", args={"deferred": self.deferred})

    def snapshot(self, include_journal: bool = False) -> Dict:
        """JSON-safe controller observability (the recorder's meta).
        ``include_journal=True`` additionally embeds the construction config
        and the full decision journal — the shape `balance/replaylab.py`
        loads as a replay corpus."""
        out = {
            "evals": self.evals,
            "switches": self.switches,
            "deferred": self.deferred,
            "spent_s": round(self.spent_s, 6),
            "credit_s": round(self.credit_s, 6),
            "switch_cost_ema_s": (
                round(self.switch_cost_s, 6)
                if self.switch_cost_s is not None
                else None
            ),
            "wall_scale": round(self.wall_scale, 4),
            "comm_step_s": round(self.comm_step_s, 6),
            "decisions": len(self.journal),
            "journal_dropped": self.journal_dropped,
            "last_decision": dict(self.journal[-1]) if self.journal else None,
        }
        if include_journal:
            out["config"] = self.journal_config()
            out["journal"] = self.decision_journal()
        return out
