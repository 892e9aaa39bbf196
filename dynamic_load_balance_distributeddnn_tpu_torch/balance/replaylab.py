"""The controller lab (the JAX package's ``balance/replaylab.py``, copied):
counterfactual replay, scenario synthesis and knob sweeps over the real
:class:`OnlineRebalanceController`, with no device and pure host-side numpy.

The controller's decision journal records every verdict with the inputs it
was decided on, which makes it a dataset for replay:

* **replay** (:func:`load_corpus` + :func:`replay`): load a decision journal
  from a corpus JSON, a controller snapshot (the recorder's
  ``rebalance_controller`` meta holds one), a trace file, a spool or a
  directory of spools and traces; rebuild a fresh
  controller from the recorded ``journal_config()`` (optionally overriding
  ``hysteresis`` / ``margin`` / ``budget_frac`` / ``rate_alpha`` /
  ``cost_init``); drive it with the recorded input stream; report the
  counterfactual modeled wall, switch count and ledgers against the
  recording. With no knob overrides the replay is a strict parity check:
  every recorded verdict must come out again bit for bit.

* **synthesize** (:class:`Scenario` + :func:`simulate`): per-worker rate
  traces from every :class:`ScheduledStragglerInjector` schedule, run
  closed-loop through the controller under :func:`step_time`.

* **sweep** (:func:`knob_grid` / :func:`random_knobs` + :func:`sweep`):
  knob sets across a scenario library, ranked by the geometric-mean speedup
  over never switching.

Every replayed or simulated journal goes through :func:`check_invariants`:
switch spend admissible under the regret budget at every switch, hold when
there is no modeled gain, ledger monotonicity and recurrence.

"Modeled wall" is the controller's own cost model (:func:`step_time` times
the recorded ``wall_scale``) over the recorded horizon: a basis for
comparing knob sets, not a promise about any fleet's seconds.

The lab's command line is ``obs/scope_cli.py``'s ``replay`` and ``sweep``,
which also reads the spools (``python -m
dynamic_load_balance_distributeddnn_tpu_torch.obs.scope_cli replay <path>``).
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import math
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from dynamic_load_balance_distributeddnn_tpu_torch.balance.controller import (
    OnlineRebalanceController,
    step_time,
)
from dynamic_load_balance_distributeddnn_tpu_torch.balance.solver import (
    quantize_batches,
    rebalance,
)
from dynamic_load_balance_distributeddnn_tpu_torch.faults import (
    ScheduledStragglerInjector,
)

# decision-gate comparison slack: journal quantities are recorded at 1e-6
# resolution and the hysteresis gate multiplies a rounded step wall by the
# remaining-step horizon, so honest recordings can miss exact equality by
# ~1e-3 in the worst case — violations the checker exists for are orders of
# magnitude larger
GATE_EPS = 1e-3
# ledger recurrence slack: two rounded 1e-6 quantities per hop
LEDGER_EPS = 5e-6

KNOBS = ("hysteresis", "margin", "budget_frac", "rate_alpha", "cost_init")


# --------------------------------------------------------------- corpus IO


def _entries_from_decision_instants(events: List[dict]) -> "Tuple[Optional[Dict], List[Dict]]":
    """Reconstruct (config, journal) from ``cat=="decision"`` trace
    instants. The live journal annotates outcomes in place; the trace
    stream instead interleaves ``dbs_switch``/``dbs_deferred`` instants
    after the ``dbs_decision`` they resolve, so outcomes are re-paired
    here. ``dbs_config`` (emitted once per controller) carries the
    construction surface."""
    config: Optional[Dict] = None
    journal: List[Dict] = []
    for ev in events:
        name, args = ev.get("name"), dict(ev.get("args") or {})
        if name == "dbs_config":
            config = args
        elif name == "dbs_decision":
            args.pop("journal_dropped", None)
            journal.append(args)
        elif name == "dbs_switch" and journal:
            journal[-1]["outcome"] = "committed"
            if "switch_cost_s" in args:
                journal[-1]["measured_cost_s"] = args["switch_cost_s"]
            for k in ("epoch", "window", "step"):
                if k in args:
                    journal[-1][k] = args[k]
        elif name == "dbs_deferred" and journal:
            journal[-1]["outcome"] = "deferred"
    return config, journal


def _corpus_from_snapshot(obj: Dict) -> Optional[Dict]:
    """A controller ``snapshot(include_journal=True)`` — possibly nested
    inside a registry snapshot's ``controller`` section or a corpus file's
    top level — normalised to {"config", "journal", ...}."""
    for candidate in (obj, obj.get("controller"), obj.get("rebalance_controller")):
        if (
            isinstance(candidate, dict)
            and isinstance(candidate.get("journal"), list)
            and isinstance(candidate.get("config"), dict)
        ):
            return {
                "config": candidate["config"],
                "journal": candidate["journal"],
                "journal_dropped": int(candidate.get("journal_dropped", 0)),
                "label": obj.get("label"),
            }
    return None


def load_corpus(path: str) -> Dict:
    """Load a replay corpus: ``{"config": journal_config, "journal":
    [entries...], "journal_dropped", "label", "source"}``.

    Accepts a corpus JSON (:func:`harvest`), a controller
    ``snapshot(include_journal=True)`` or a dict holding one under
    ``controller`` or ``rebalance_controller`` (the recorder's meta), a
    Chrome-trace file of decision instants, a ``.spool`` file, or a
    directory of spools and traces (``--trace_spool``). Raises
    ``ValueError`` when no decision journal can be reconstructed — an empty
    corpus is an error, not a clean replay."""
    if os.path.isdir(path) or path.endswith(".spool"):
        config, journal = _entries_from_decision_instants(
            _decision_instants(path)
        )
    else:
        with open(path) as fh:
            try:
                obj = json.load(fh)
            except json.JSONDecodeError as exc:
                raise ValueError(f"{path}: not JSON ({exc})") from exc
        if isinstance(obj, dict) and (got := _corpus_from_snapshot(obj)):
            got["source"] = path
            got["label"] = got.get("label") or os.path.basename(path)
            if not got["journal"]:
                raise ValueError(f"{path}: corpus journal is empty")
            return got
        if isinstance(obj, dict) and "traceEvents" in obj:
            config, journal = _entries_from_decision_instants(
                [
                    e
                    for e in obj["traceEvents"]
                    if e.get("ph") == "i" and e.get("cat") == "decision"
                ]
            )
        else:
            raise ValueError(
                f"{path}: neither a replay corpus (config+journal), a "
                "controller snapshot, nor a trace file"
            )
    if not journal:
        raise ValueError(f"{path}: no decision journal entries found")
    if config is None:
        raise ValueError(
            f"{path}: decision entries found but no dbs_config instant / "
            "config section — cannot rebuild the controller (re-record "
            "with a current build, or wrap the journal in a corpus JSON)"
        )
    return {
        "config": config,
        "journal": journal,
        "journal_dropped": 0,
        "label": os.path.basename(path.rstrip("/")),
        "source": path,
    }


def _decision_instants(path: str) -> List[dict]:
    # scope_cli owns the spool/trace merge machinery; imported lazily so
    # replaylab stays importable without the CLI module loaded (and the
    # CLI's replay/sweep handlers import replaylab lazily in turn)
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.scope_cli import (
        _decision_events,
    )

    return _decision_events(path)


def harvest(ctl: OnlineRebalanceController, label: str = "") -> Dict:
    """One live controller -> one corpus record (the shape
    :func:`load_corpus` reads)."""
    snap = ctl.snapshot(include_journal=True)
    return {
        "label": label,
        "config": snap["config"],
        "journal": snap["journal"],
        "journal_dropped": snap["journal_dropped"],
        "snapshot": {
            k: v for k, v in snap.items() if k not in ("config", "journal")
        },
    }


# -------------------------------------------------------------- invariants


def check_invariants(config: Dict, journal: Sequence[Dict]) -> List[Dict]:
    """Check a decision journal against the controller's contract. Returns
    violation records (empty == clean):

    * ``switch-gate-hysteresis`` — a switch verdict whose predicted win is
      below the relative hysteresis threshold;
    * ``switch-gate-margin`` — a switch verdict whose win does not cover
      ``margin ×`` the cost estimate;
    * ``switch-gate-budget`` — cumulative spend + this cost exceeds
      ``budget_frac × (banked credit + this win)`` at a switch verdict;
    * ``no-modeled-gain`` — a switch verdict with non-positive win;
    * ``hold-reason`` — a hold whose recorded reason contradicts its own
      recorded inputs;
    * ``ledger-monotone`` / ``ledger-recurrence`` — spend/credit ledgers
      must be non-decreasing and evolve exactly by the recorded committed
      costs and banked wins.

    Gates use each ENTRY's recorded knobs (not ``config``'s), so a journal
    spanning a knob change is still checked against what the controller
    believed at each decision."""
    out: List[Dict] = []

    def flag(i: int, inv: str, detail: str) -> None:
        out.append({"index": i, "eval": journal[i].get("eval"),
                    "invariant": inv, "detail": detail})

    prev = None
    for i, e in enumerate(journal):
        if "predicted_win_s" not in e:  # foreign journal shape: skip entry
            continue
        win = float(e.get("predicted_win_s", 0.0))
        cur = float(e.get("cur_step_s", 0.0))
        cost = float(e.get("cost_est_s", 0.0))
        rem = int(e.get("remaining_steps", 0))
        h = float(e.get("hysteresis", config.get("hysteresis", 0.0)))
        m = float(e.get("margin", config.get("margin", 0.0)))
        bf = float(e.get("budget_frac", config.get("budget_frac", 1.0)))
        spent = float(e.get("spent_s", 0.0))
        credit = float(e.get("credit_s", 0.0))
        reason = e.get("reason", "")
        if e.get("switch"):
            if win <= 0.0:
                flag(i, "no-modeled-gain", f"switch with win {win} <= 0")
            if win + GATE_EPS < h * cur * rem:
                flag(i, "switch-gate-hysteresis",
                     f"win {win} < {h} * {cur} * {rem}")
            if win + GATE_EPS < m * cost:
                flag(i, "switch-gate-margin", f"win {win} < {m} * {cost}")
            if spent + cost > bf * (credit + win) + GATE_EPS:
                flag(i, "switch-gate-budget",
                     f"spent {spent} + cost {cost} > "
                     f"{bf} * (credit {credit} + win {win})")
        elif reason == "below-hysteresis" and win - GATE_EPS > h * cur * rem:
            flag(i, "hold-reason", f"win {win} >= {h} * {cur} * {rem}")
        elif reason == "below-margin" and win - GATE_EPS > m * cost:
            flag(i, "hold-reason", f"win {win} >= {m} * {cost}")
        elif (
            reason == "budget-exhausted"
            and spent + cost + GATE_EPS < bf * (credit + win)
        ):
            flag(i, "hold-reason",
                 f"budget had room: spent {spent} + cost {cost} < "
                 f"{bf} * (credit {credit} + win {win})")
        if prev is not None:
            p = journal[prev]
            p_spent = float(p.get("spent_s", 0.0))
            p_credit = float(p.get("credit_s", 0.0))
            if spent + LEDGER_EPS < p_spent or credit + LEDGER_EPS < p_credit:
                flag(i, "ledger-monotone",
                     f"spent {p_spent}->{spent} credit {p_credit}->{credit}")
            committed = p.get("outcome") == "committed"
            exp_spent = p_spent + (
                float(p.get("measured_cost_s", 0.0)) if committed else 0.0
            )
            exp_credit = p_credit + (
                max(float(p.get("predicted_win_s", 0.0)), 0.0)
                if committed
                else 0.0
            )
            if abs(spent - exp_spent) > LEDGER_EPS:
                flag(i, "ledger-recurrence",
                     f"spent {spent} != expected {exp_spent}")
            if abs(credit - exp_credit) > LEDGER_EPS:
                flag(i, "ledger-recurrence",
                     f"credit {credit} != expected {exp_credit}")
        prev = i
    return out


# ------------------------------------------------------------------ replay


def _knobs_of(config: Dict, overrides: Optional[Dict]) -> Dict:
    eff = {k: config.get(k) for k in KNOBS}
    for k, v in (overrides or {}).items():
        if k not in KNOBS:
            raise ValueError(f"unknown controller knob: {k!r}")
        if v is not None:
            eff[k] = float(v)
    return eff


def _elapsed_steps(journal: Sequence[Dict], i: int) -> int:
    """Steps the fleet ran between decision ``i`` and the next decision:
    the drop in the remaining-horizon counter, or — when the horizon GREW
    (an epoch boundary re-armed it) or this is the final entry — the rest
    of entry ``i``'s own horizon."""
    rem = int(journal[i].get("remaining_steps", 0))
    if i + 1 < len(journal):
        nxt = int(journal[i + 1].get("remaining_steps", 0))
        if 0 < nxt <= rem:
            return rem - nxt
    return max(rem, 0)


def replay(corpus: Dict, knobs: Optional[Dict] = None) -> Dict:
    """Re-run a recorded decision journal through a fresh controller.

    With no ``knobs`` this is STRICT parity: each entry's recorded inputs
    (eff rates, current batches, horizon, ledger/EMA state) are restored
    before the corresponding ``propose``, and the fresh controller's
    verdict must match the recording bit-for-bit — the corpus regression
    gate. With knob overrides it is a COUNTERFACTUAL: the controller keeps
    its own ledgers, batch trajectory, and switch-cost EMA (measured wall
    feedback and the rate stream stay the recorded, exogenous inputs), and
    the report compares modeled wall / switches / spend against the
    recording and the never-switch hold baseline.

    The replayed journal is always re-checked with
    :func:`check_invariants` — a counterfactual that breaks the budget
    contract is a bug, not a tuning datapoint."""
    config, journal = corpus["config"], corpus["journal"]
    strict = not knobs
    eff_knobs = _knobs_of(config, knobs)
    ctl = OnlineRebalanceController.from_journal_config(
        config, **{k: eff_knobs[k] for k in KNOBS}
    )
    ws = int(config["world_size"])
    groups = [list(g) for g in config["groups"]]
    filler_b = np.ones(ws, dtype=np.int64)

    mismatches: List[Dict] = []
    wall_rec = wall_rep = wall_hold = 0.0
    spend_rec = spend_rep = 0.0
    ledger: List[Dict] = []
    cur_cf: Optional[np.ndarray] = None  # counterfactual batch trajectory
    hold_b: Optional[np.ndarray] = None  # never-switch baseline trajectory
    prev_rem = None
    measured = [
        float(e["measured_cost_s"])
        for e in journal
        if e.get("outcome") == "committed" and "measured_cost_s" in e
    ]
    cf_cost = (
        float(np.mean(measured)) if measured else float(eff_knobs["cost_init"])
    )

    for i, e in enumerate(journal):
        reason = e.get("reason", "")
        rem = int(e.get("remaining_steps", 0))
        eff = e.get("eff_rates")
        cur_b = e.get("cur_batches")
        # exogenous measured-feedback state is replayed in BOTH modes: the
        # wall ratio and comm model are properties of the fleet, not of
        # the knob set under test
        ctl.wall_scale = float(e.get("wall_scale", ctl.wall_scale))
        if "comm_step_s" in e:
            ctl.comm_step_s = float(e["comm_step_s"])
        if strict:
            # parity mode makes each verdict a pure function of its
            # recorded inputs: restore the decision-time ledger/EMA state
            ctl.spent_s = float(e.get("spent_s", 0.0))
            ctl.credit_s = float(e.get("credit_s", 0.0))
            ema = e.get("switch_cost_ema_s")
            ctl.switch_cost_s = None if ema is None else float(ema)
        if reason == "no-horizon":
            dec = ctl.propose(np.ones(ws), filler_b, 0)
        elif reason == "no-signal":
            dec = ctl.propose(np.full(ws, -1.0), filler_b, max(rem, 1))
        elif eff is None or cur_b is None:
            mismatches.append(
                {"index": i, "field": "inputs",
                 "detail": f"entry lacks eff_rates/cur_batches ({reason})"}
            )
            continue
        else:
            rec_b = np.asarray(cur_b, dtype=np.int64)
            if hold_b is None or prev_rem is None or rem > prev_rem:
                # epoch boundary (or first sight): the engine re-plans at
                # boundaries outside this controller — both the hold
                # baseline and the counterfactual trajectory re-anchor on
                # the recorded plan
                hold_b = rec_b.copy()
                cur_cf = rec_b.copy()
            prev_rem = rem
            drive_b = rec_b if strict else cur_cf
            dec = ctl.propose(np.asarray(eff, dtype=np.float64), drive_b, rem)

        # verdict parity (strict mode is the gate; counterfactuals expect
        # drift — that is the point)
        if strict:
            if bool(dec.switch) != bool(e.get("switch")) or dec.reason != reason:
                mismatches.append(
                    {"index": i, "field": "verdict",
                     "detail": f"recorded ({e.get('switch')}, {reason!r}) "
                     f"replayed ({dec.switch}, {dec.reason!r})"}
                )
            elif "candidate_batches" in e and dec.candidate_batches is not None:
                if [int(b) for b in dec.candidate_batches] != [
                    int(b) for b in e["candidate_batches"]
                ]:
                    mismatches.append(
                        {"index": i, "field": "candidate_batches",
                         "detail": f"recorded {e['candidate_batches']} "
                         f"replayed {[int(b) for b in dec.candidate_batches]}"}
                    )

        # outcome bookkeeping + modeled-wall integration
        rec_committed = e.get("outcome") == "committed"
        rec_cost = float(e.get("measured_cost_s", cf_cost))
        if strict:
            if rec_committed and dec.switch:
                ctl.commit(dec, rec_cost)
            elif e.get("outcome") == "deferred" and dec.switch:
                ctl.note_deferred()
        elif dec.switch:
            # counterfactual: no warm-gate model — a verdict executes, at
            # the recorded measured cost when the recording has one for
            # this evaluation, else the corpus-mean measured cost
            ctl.commit(dec, rec_cost if rec_committed else cf_cost)
            cur_cf = np.asarray(dec.candidate_batches, dtype=np.int64)
        if eff is not None and cur_b is not None:
            steps = _elapsed_steps(journal, i)
            rates = np.asarray(eff, dtype=np.float64)
            scale = float(e.get("wall_scale", 1.0))
            comm = float(e.get("comm_step_s", 0.0))
            rec_b = np.asarray(cur_b, dtype=np.int64)
            rec_plan = (
                np.asarray(e["candidate_batches"], dtype=np.int64)
                if rec_committed and "candidate_batches" in e
                else rec_b
            )
            rep_plan = (
                rec_plan
                if strict
                else (cur_cf if cur_cf is not None else rec_b)
            )
            wall_rec += step_time(rates, rec_plan, groups, comm) * scale * steps
            wall_rep += step_time(rates, rep_plan, groups, comm) * scale * steps
            wall_hold += (
                step_time(rates, hold_b, groups, comm) * scale * steps
            )
            if rec_committed:
                wall_rec += rec_cost
                spend_rec += rec_cost
        if not strict and dec.switch:
            paid = rec_cost if rec_committed else cf_cost
            wall_rep += paid
            spend_rep += paid
        ledger.append(
            {"eval": e.get("eval", i), "spent_s": round(ctl.spent_s, 6),
             "credit_s": round(ctl.credit_s, 6)}
        )

    if strict:
        wall_rep, spend_rep = wall_rec, spend_rec
    replayed_journal = ctl.decision_journal()
    violations = check_invariants(ctl.journal_config(), replayed_journal)
    rec_switches = sum(1 for e in journal if e.get("outcome") == "committed")
    rec_deferred = sum(1 for e in journal if e.get("outcome") == "deferred")
    return {
        "label": corpus.get("label"),
        "mode": "strict" if strict else "counterfactual",
        "entries": len(journal),
        "knobs": eff_knobs,
        "parity": not mismatches if strict else None,
        "mismatches": mismatches,
        "invariant_violations": violations,
        "recorded": {
            "switches": rec_switches,
            "deferred": rec_deferred,
            "modeled_wall_s": round(wall_rec, 6),
            "switch_spend_s": round(spend_rec, 6),
        },
        "replayed": {
            "switches": ctl.switches,
            "deferred": ctl.deferred,
            "modeled_wall_s": round(wall_rep, 6),
            "switch_spend_s": round(spend_rep, 6),
            "spent_s": round(ctl.spent_s, 6),
            "credit_s": round(ctl.credit_s, 6),
        },
        "hold_modeled_wall_s": round(wall_hold, 6),
        "ledger": ledger,
    }


# -------------------------------------------------------------- synthesize


def _even_batches(global_batch: int, ws: int) -> np.ndarray:
    base, rem = divmod(int(global_batch), ws)
    return np.array(
        [base + (1 if i < rem else 0) for i in range(ws)], dtype=np.int64
    )


@dataclasses.dataclass
class Scenario:
    """One synthesized fleet: per-worker base rates modulated by an
    injection schedule, stepped at window cadence through the controller.
    Times are in the same abstract seconds the controller reasons in."""

    name: str
    world_size: int = 4
    base_rates: Tuple[float, ...] = ()   # s/example; default mildly skewed
    factors: Tuple[float, ...] = ()      # straggler factors; default (6,1..)
    schedule: str = "sin"
    period: float = 2.0
    phase: float = 0.0
    duty: float = 0.25
    seed: int = 0
    epochs: int = 4
    windows_per_epoch: int = 8
    steps_per_window: int = 4
    global_batch: int = 256
    bucket: int = 8
    switch_cost_s: float = 0.05
    comm_step_s: float = 0.0
    noise: float = 0.05                  # relative rate-measurement noise

    def resolved_rates(self) -> np.ndarray:
        if self.base_rates:
            return np.asarray(self.base_rates, dtype=np.float64)
        # mild deterministic skew so "even" is never accidentally optimal
        return 0.002 * (1.0 + 0.05 * np.arange(self.world_size))

    def resolved_factors(self) -> np.ndarray:
        if self.factors:
            return np.asarray(self.factors, dtype=np.float64)
        f = np.ones(self.world_size)
        f[0] = 6.0
        return f


def builtin_scenarios(world_size: int = 4) -> List[Scenario]:
    """The stock scenario library the sweep runs against: one per
    schedule family."""
    return [
        Scenario("sin-surge", world_size, schedule="sin", period=2.0),
        Scenario("ramp-degrade", world_size, schedule="ramp", period=1.5),
        Scenario("spike-burst", world_size, schedule="spike",
                 period=1.0, duty=0.2),
        Scenario("diurnal-load", world_size, schedule="diurnal", period=2.0),
        Scenario("rack-brownout", world_size, schedule="brownout",
                 period=1.0, seed=5,
                 factors=tuple([4.0] * world_size)),
        Scenario("kill-storm", world_size, schedule="killstorm",
                 period=1.0, seed=9,
                 factors=tuple([8.0] * world_size)),
    ]


def simulate(
    scenario: Scenario,
    knobs: Optional[Dict] = None,
    include_journal: bool = False,
) -> Dict:
    """Run one scenario through a fresh controller, closed loop: noisy
    per-window rate measurements fold through the controller's own EMA
    (``rate_alpha`` matters), realized walls feed ``observe_wall``, and a
    committed switch pays ``switch_cost_s`` into the TRUE wall. Reports
    the controller's realized modeled wall against the never-switch hold
    baseline and the zero-cost per-window oracle, plus the invariant check
    over the produced journal."""
    ws = scenario.world_size
    base = scenario.resolved_rates()
    groups = [[i] for i in range(ws)]
    kw = {"bucket": scenario.bucket, "cost_init": scenario.switch_cost_s}
    for k, v in (knobs or {}).items():
        if k not in KNOBS:
            raise ValueError(f"unknown controller knob: {k!r}")
        if v is not None:
            kw[k] = float(v)
    ctl = OnlineRebalanceController(ws, scenario.global_batch, groups, **kw)
    ctl.comm_step_s = scenario.comm_step_s
    inj = ScheduledStragglerInjector(
        scenario.resolved_factors(),
        schedule=scenario.schedule,
        period=scenario.period,
        phase=scenario.phase,
        duty=scenario.duty,
        seed=scenario.seed,
    )
    rng = random.Random(scenario.seed * 7907 + 3)
    cur = _even_batches(scenario.global_batch, ws)
    hold = cur.copy()
    wall = hold_wall = oracle_wall = 0.0
    spw = scenario.steps_per_window
    for e in range(scenario.epochs):
        for w in range(scenario.windows_per_epoch):
            t_mid = e + (w + 0.5) / scenario.windows_per_epoch
            eff_true = base * inj.factors_at(t_mid)
            measured = eff_true * np.array(
                [1.0 + scenario.noise * (2.0 * rng.random() - 1.0)
                 for _ in range(ws)]
            )
            ctl.observe_rates(measured)
            signal = ctl.rates if ctl.rates is not None else measured
            remaining = (scenario.windows_per_epoch - w) * spw
            ctl.eval_context = {"epoch": e, "window": w}
            dec = ctl.propose(signal, cur, remaining)
            if dec.switch:
                ctl.commit(dec, scenario.switch_cost_s, epoch=e, window=w)
                cur = np.asarray(dec.candidate_batches, dtype=np.int64)
                wall += scenario.switch_cost_s
            true_step = step_time(
                eff_true, cur, groups, comm_s=scenario.comm_step_s
            )
            wall += true_step * spw
            modeled = (
                step_time(signal, cur, groups, comm_s=scenario.comm_step_s)
                * ctl.wall_scale
            )
            ctl.observe_wall(true_step * spw, modeled * spw)
            hold_wall += (
                step_time(eff_true, hold, groups, comm_s=scenario.comm_step_s)
                * spw
            )
            o_shares, o_b = rebalance(
                eff_true * np.maximum(hold, 1),
                hold.astype(np.float64) / max(hold.sum(), 1),
                scenario.global_batch,
            )
            if scenario.bucket > 0:
                o_b = quantize_batches(
                    o_b, scenario.bucket, scenario.global_batch
                )
            oracle_wall += (
                step_time(eff_true, o_b, groups, comm_s=scenario.comm_step_s)
                * spw
            )
    journal = ctl.decision_journal()
    violations = check_invariants(ctl.journal_config(), journal)
    out = {
        "scenario": scenario.name,
        "knobs": {k: getattr(ctl, k) for k in KNOBS},
        "evals": ctl.evals,
        "switches": ctl.switches,
        "spent_s": round(ctl.spent_s, 6),
        "credit_s": round(ctl.credit_s, 6),
        "wall_s": round(wall, 6),
        "hold_wall_s": round(hold_wall, 6),
        "oracle_wall_s": round(oracle_wall, 6),
        "speedup_vs_hold": round(hold_wall / wall, 6) if wall > 0 else None,
        "oracle_frac": (
            round((hold_wall - wall) / (hold_wall - oracle_wall), 6)
            if hold_wall > oracle_wall
            else None
        ),
        "invariant_violations": violations,
    }
    if include_journal:
        out["config"] = ctl.journal_config()
        out["journal"] = journal
    return out


# ------------------------------------------------------------------- sweep


def knob_grid(size: str = "small") -> List[Dict]:
    """Deterministic grid over the decision knobs. ``small`` (18 points)
    is the quick grid; ``full`` is the offline-tuning grid."""
    if size == "small":
        hs, ms, bfs = (0.05, 0.1, 0.2), (1.5, 3.0, 6.0), (0.5, 1.0)
    elif size == "full":
        hs = (0.02, 0.05, 0.1, 0.2, 0.4)
        ms = (1.0, 1.5, 3.0, 6.0, 12.0)
        bfs = (0.25, 0.5, 1.0, 2.0)
    else:
        raise ValueError("size must be 'small' or 'full'")
    return [
        {"hysteresis": h, "margin": m, "budget_frac": bf}
        for h, m, bf in itertools.product(hs, ms, bfs)
    ]


def random_knobs(n: int, seed: int = 0) -> List[Dict]:
    """``n`` seeded log-uniform knob draws (the fuzz arm of the sweep)."""
    rng = random.Random(seed * 104729 + 1)

    def logu(lo: float, hi: float) -> float:
        return float(
            math.exp(rng.uniform(math.log(lo), math.log(hi)))
        )

    return [
        {
            "hysteresis": round(logu(0.02, 0.4), 4),
            "margin": round(logu(1.0, 8.0), 4),
            "budget_frac": round(logu(0.25, 2.0), 4),
            "rate_alpha": round(logu(0.2, 0.9), 4),
        }
        for _ in range(n)
    ]


def _geomean(xs: Sequence[float]) -> float:
    return float(math.exp(sum(math.log(max(x, 1e-12)) for x in xs) / len(xs)))


def sweep(
    scenarios: Sequence[Scenario],
    knob_sets: Sequence[Dict],
    include_default: bool = True,
) -> Dict:
    """Run every knob set over every scenario; rank by geometric-mean
    speedup over the hold baseline. The report carries the full ranked
    table, the winner, the defaults' row, and winner-vs-default."""
    candidates: List[Optional[Dict]] = (
        [None] if include_default else []
    ) + [dict(k) for k in knob_sets]
    results = []
    total_violations = 0
    for knobs in candidates:
        runs = [simulate(sc, knobs=knobs) for sc in scenarios]
        total_violations += sum(
            len(r["invariant_violations"]) for r in runs
        )
        results.append(
            {
                "knobs": knobs if knobs is not None else "default",
                "score": round(
                    _geomean([r["speedup_vs_hold"] or 1.0 for r in runs]), 6
                ),
                "switches": sum(r["switches"] for r in runs),
                "spent_s": round(sum(r["spent_s"] for r in runs), 6),
                "per_scenario": {
                    r["scenario"]: r["speedup_vs_hold"] for r in runs
                },
                "invariant_violations": sum(
                    len(r["invariant_violations"]) for r in runs
                ),
            }
        )
    ranked = sorted(results, key=lambda r: -r["score"])
    default_row = next(
        (r for r in results if r["knobs"] == "default"), None
    )
    best = ranked[0] if ranked else None
    return {
        "scenarios": [sc.name for sc in scenarios],
        "candidates": len(candidates),
        "results": ranked,
        "best": best,
        "default": default_row,
        "best_vs_default": (
            round(best["score"] / default_row["score"], 6)
            if best and default_row and default_row["score"] > 0
            else None
        ),
        "invariant_violations": total_violations,
    }
