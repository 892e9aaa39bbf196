"""``graftscope`` for the port (the JAX package's ``obs/scope_cli.py``,
copied): read a Chrome-trace JSON written by the span tracer (``--trace
on|ring``) and answer "where did the wall go" without opening Perfetto.
Run it as ``python -m dynamic_load_balance_distributeddnn_tpu_torch.obs.scope_cli``
(the ``graftscope`` console script stays the JAX package's).

Usage::

    graftscope summarize traces/run.trace.json            # per-phase table
    graftscope summarize traces/run.trace.json --epoch 3  # one epoch only
    graftscope diff before.trace.json after.trace.json    # phase deltas
    graftscope summarize run.trace.json --json            # machine-readable
    graftscope merge run.trace.json -o merged.json        # + worker traces
    graftscope postmortem spools/                         # crash stitcher
    graftscope decisions traces/run.trace.json            # DBS journal
    graftscope decisions spools/ --outcome committed --csv  # filtered export
    graftscope replay runs/bench.json --margin 6          # counterfactual
    graftscope sweep --grid small --random 8              # knob sweep
    graftscope conformance spools/                        # protocol replay

``summarize`` and ``merge`` automatically stitch compile-worker trace files
(``compile_worker_*.trace.json``, written per process by the AOT service's
process backend — runtime/compile_worker.py) found next to the run trace,
so compile walls attribute across processes as pid-tagged tracks
(``--no-workers`` reads the run trace alone).

``postmortem`` is the flight-recorder reader: it merges every
``*.spool`` file (crash-durable spools from ``--trace_spool``, torn tails
tolerated) and any sibling ``*.trace.json`` in a directory into ONE
pid-tagged Perfetto trace — survivors' rendezvous state-machine spans next
to the victim's last spooled events, realigned by each file's unix-time
base — and prints a textual incident report (detection → drain → rebuild
per process). ``decisions`` renders the decision journal — the online-DBS
controller's switch/hold verdicts AND the outer many-stream allocator's
``pool_decision`` rows — with each row's derived outcome, filterable by
``--outcome``/``--since`` and exportable with ``--csv``, so "why did epoch
7 rebalance?" is answerable offline.

``replay`` and ``sweep`` are the device-free controller lab
(balance/replaylab.py): ``replay`` re-runs a recorded decision journal
(bench artifact, trace, spool, or spool directory) through a fresh
controller — with no overrides it is a strict parity gate (every recorded
verdict must reproduce bit-for-bit), with ``--hysteresis/--margin/
--budget-frac/--rate-alpha`` it answers the counterfactual "what would the
run have done under different knobs". ``sweep`` grids (and optionally
randomizes) knobs over the synthesized scenario library — spike bursts,
correlated rack brownouts, diurnal load, kill-storms — and ranks them by
geomean speedup over the never-switch baseline. Both check every journal
against the controller invariants (switch spend within budget, no switch
without modeled gain clearing the gates, ledger monotonicity).

``conformance`` needs the rendezvous protocol automaton
(``analysis/flow/proto.py``) and the elastic rendezvous, which this port
does not have yet: it exits 2 with a message naming them.

Exit status: 0 on success, 1 when ``replay``/``sweep`` find parity drift /
invariant violations, 2 on usage/IO errors (including ``conformance``, an
empty or missing spool directory, or a ``decisions`` query matching no rows).
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import Dict, List, Optional

from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import (
    attribution,
    attribution_by_job,
    load_trace,
    merge_trace_events,
    merge_trace_files,
    merged_names,
)


def _worker_traces(path: str) -> List[str]:
    """Compile-worker span files sitting next to a run trace that are NOT
    already stitched into it (the engine merges at save and records the
    filenames in the trace's ``graftscope.merged`` marker — re-stitching
    those would double-count their compile walls)."""
    done = set(merged_names(path))
    pattern = os.path.join(os.path.dirname(path) or ".", "compile_worker_*.trace.json")
    return sorted(
        p
        for p in glob.glob(pattern)
        if os.path.abspath(p) != os.path.abspath(path)
        and os.path.basename(p) not in done
    )


def _load_stitched(
    path: str, with_workers: bool
) -> "tuple[List[dict], List[str], List[str]]":
    """(events, worker-trace provenance, skipped): stitches un-merged
    sibling worker files in; provenance also includes files the engine
    already merged, so the per-pid compile table renders for pre-stitched
    traces too. Torn/mid-write worker files land in ``skipped`` (the chaos
    harness kills processes during save) instead of failing the load."""
    workers = _worker_traces(path) if with_workers else []
    stitched = (workers + merged_names(path)) if with_workers else []
    skipped: List[str] = []
    if workers:
        events = merge_trace_events([path] + workers, skipped=skipped)
        stitched = [w for w in stitched if os.path.basename(w) not in skipped]
        return events, stitched, skipped
    return load_trace(path), stitched, skipped


def _compile_walls_by_pid(events: List[dict]) -> Dict[int, float]:
    """Total cat=="compile" span seconds per pid — the cross-process compile
    attribution the worker stitching exists for."""
    walls: Dict[int, float] = {}
    for ev in events:
        if ev.get("ph") == "X" and ev.get("cat") == "compile":
            pid = ev.get("pid", 0)
            walls[pid] = walls.get(pid, 0.0) + float(ev.get("dur", 0.0)) / 1e6
    return walls


def _fmt_table(rows: List[List[str]], header: List[str]) -> str:
    widths = [
        max(len(str(r[i])) for r in [header] + rows) for i in range(len(header))
    ]
    def line(cells):
        return "  ".join(str(c).ljust(w) for c, w in zip(cells, widths)).rstrip()

    out = [line(header), line(["-" * w for w in widths])]
    out += [line(r) for r in rows]
    return "\n".join(out)


def summarize_by_job(
    path: str, as_json: bool = False, with_workers: bool = True
) -> str:
    """Per-TENANT wall attribution for many-stream traces: one row per job
    tag (``Tracer.set_job``), with epoch count, total epoch wall, and the
    dominant phases. Single-job traces render under the ``-`` pseudo-job."""
    events, workers, skipped = _load_stitched(path, with_workers)
    att = attribution_by_job(events)
    if as_json:
        payload = dict(att)
        if skipped:
            payload["skipped_traces"] = skipped
        return json.dumps(payload)
    jobs = att["jobs"]
    if not jobs:
        return "no epoch spans recorded (run with --trace on|ring)"
    rows = []
    for job, info in jobs.items():
        top = sorted(info["phases"].items(), key=lambda kv: -kv[1])[:3]
        rows.append(
            [
                job,
                str(info["epochs"]),
                f"{info['wall_s']:.4f}",
                ", ".join(f"{n} {s:.3f}s" for n, s in top) or "-",
            ]
        )
    out = [_fmt_table(rows, ["job", "epochs", "wall (s)", "top phases"])]
    if skipped:
        out.append(
            f"skipped {len(skipped)} unreadable worker trace file(s): "
            + ", ".join(skipped)
        )
    return "\n".join(out)


def summarize(
    path: str,
    epoch: Optional[int] = None,
    as_json: bool = False,
    with_workers: bool = True,
) -> str:
    events, workers, skipped = _load_stitched(path, with_workers)
    att = attribution(events)
    compile_walls = _compile_walls_by_pid(events) if workers else {}
    epochs = att["epochs"]
    if epoch is not None:
        epochs = {k: v for k, v in epochs.items() if int(k) == epoch}
        if not epochs:
            raise ValueError(f"epoch {epoch} not present in {path}")
    if as_json:
        payload = {"epochs": epochs, "phase_totals_s": att["phase_totals_s"],
                   "coverage_min": att["coverage_min"]}
        if workers:
            payload["worker_traces"] = workers
            payload["compile_wall_s_by_pid"] = {
                str(k): round(v, 6) for k, v in sorted(compile_walls.items())
            }
        if skipped:
            payload["skipped_traces"] = skipped
        return json.dumps(payload)
    out = []
    for ep, info in sorted(epochs.items(), key=lambda kv: int(kv[0])):
        wall = info["wall_s"]
        rows = [
            [name, f"{secs:.4f}", f"{100.0 * secs / wall:5.1f}%" if wall else "-"]
            for name, secs in sorted(
                info["phases"].items(), key=lambda kv: -kv[1]
            )
        ]
        unattributed = wall - sum(info["phases"].values())
        rows.append(
            ["(unattributed)", f"{unattributed:.4f}",
             f"{100.0 * unattributed / wall:5.1f}%" if wall else "-"]
        )
        cov = info["coverage"]
        head = f"epoch {ep}: wall {wall:.4f}s"
        if cov is not None:
            head += f", attribution {cov * 100:.1f}%"
        out.append(head)
        out.append(_fmt_table(rows, ["phase", "seconds", "% wall"]))
        out.append("")
    totals = att["phase_totals_s"]
    if totals and epoch is None:
        rows = [
            [name, f"{secs:.4f}"]
            for name, secs in sorted(totals.items(), key=lambda kv: -kv[1])
        ]
        out.append("run totals:")
        out.append(_fmt_table(rows, ["phase", "seconds"]))
        if att["coverage_min"] is not None:
            out.append(f"worst-epoch attribution: {att['coverage_min'] * 100:.1f}%")
    if workers:
        out.append("")
        out.append(
            f"stitched {len(workers)} compile-worker trace file(s); "
            "compile wall by pid:"
        )
        out.append(
            _fmt_table(
                [[str(pid), f"{secs:.4f}"] for pid, secs in sorted(compile_walls.items())],
                ["pid", "compile s"],
            )
        )
    if skipped:
        out.append("")
        out.append(
            f"skipped {len(skipped)} unreadable (torn/mid-write) worker "
            f"trace file(s): {', '.join(skipped)}"
        )
    return "\n".join(out).rstrip()


def diff(path_a: str, path_b: str, as_json: bool = False) -> str:
    """Phase-total deltas B - A: the first stop of every perf PR review
    ('which phase did this change actually move?')."""
    a = attribution(load_trace(path_a))["phase_totals_s"]
    b = attribution(load_trace(path_b))["phase_totals_s"]
    names = sorted(set(a) | set(b))
    deltas: Dict[str, Dict] = {}
    for name in names:
        va, vb = a.get(name, 0.0), b.get(name, 0.0)
        deltas[name] = {
            "a_s": round(va, 6),
            "b_s": round(vb, 6),
            "delta_s": round(vb - va, 6),
            "ratio": round(vb / va, 4) if va > 0 else None,
        }
    if as_json:
        return json.dumps(deltas)
    rows = [
        [
            name,
            f"{d['a_s']:.4f}",
            f"{d['b_s']:.4f}",
            f"{d['delta_s']:+.4f}",
            f"{d['ratio']:.3f}x" if d["ratio"] is not None else "new",
        ]
        for name, d in sorted(deltas.items(), key=lambda kv: kv[1]["delta_s"])
    ]
    return _fmt_table(rows, ["phase", "A (s)", "B (s)", "delta", "B/A"])


# ------------------------------------------------------------- postmortem


def _is_postmortem_output(path: str) -> bool:
    """Does this trace carry the postmortem stitcher's own metadata marker?
    A previous run's output (under ANY -o name) must never be re-ingested
    as a source — its trace-only tracks would double-count."""
    try:
        with open(path) as f:
            data = json.load(f)
    except (OSError, ValueError):
        return False
    return isinstance(data, dict) and bool(
        (data.get("graftscope") or {}).get("postmortem")
    )


def _gather_sources(
    dir_or_file: str, exclude: "Optional[set]" = None
) -> "tuple[List[Dict], List[str]]":
    """Load every spool and trace under a directory (or the single file
    given) into per-source dicts ``{"label", "pid", "ident", "base_unix",
    "events", "truncated", "dropped", "kind"}``. Unreadable files are
    skipped and reported, never fatal — this is the crash path.
    ``exclude`` holds resolved paths to never ingest (the run's own output);
    earlier postmortem outputs are recognized by their metadata marker."""
    exclude = {os.path.abspath(p) for p in (exclude or ())}
    if os.path.isdir(dir_or_file):
        spools = sorted(glob.glob(os.path.join(dir_or_file, "*.spool")))
        traces = sorted(
            p
            for p in glob.glob(os.path.join(dir_or_file, "*.trace.json"))
            if os.path.abspath(p) not in exclude
            and not _is_postmortem_output(p)
        )
    elif dir_or_file.endswith(".spool"):
        spools, traces = [dir_or_file], []
    else:
        spools, traces = [], [dir_or_file]
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.trace import (
        _load_trace_payload,
    )
    from dynamic_load_balance_distributeddnn_tpu_torch.obs.spool import (
        spool_to_chrome,
    )
    sources: List[Dict] = []
    skipped: List[str] = []
    for path in spools:
        label = os.path.basename(path)
        try:
            got = spool_to_chrome(path)
        except (OSError, ValueError) as exc:
            print(f"graftscope: skipping {label}: {exc}", file=sys.stderr)
            skipped.append(label)
            continue
        got.update(label=label[: -len(".spool")], kind="spool")
        sources.append(got)
    spool_pids = {s["pid"] for s in sources}
    for path in traces:
        label = os.path.basename(path)
        try:
            events, base = _load_trace_payload(path)
        except (OSError, ValueError) as exc:
            print(f"graftscope: skipping {label}: {exc}", file=sys.stderr)
            skipped.append(label)
            continue
        # a process's SPOOL is the canonical record: a run trace saved by
        # the same pid (e.g. --trace_dir pointing into the spool dir, or a
        # survivor's end-of-run save copied next to the spools) holds the
        # same events and would double-count every span; keep only the
        # tracks of pids with no spool (merged compile workers, etc.)
        dup = {
            e.get("pid")
            for e in events
            if e.get("pid") in spool_pids
        }
        if dup:
            events = [e for e in events if e.get("pid") not in spool_pids]
            print(
                f"graftscope: {label}: dropping pid(s) "
                f"{sorted(int(p) for p in dup)} already covered by a spool",
                file=sys.stderr,
            )
            if not events:
                continue
        pids = sorted(
            {e.get("pid") for e in events if e.get("pid") is not None}
        )
        sources.append(
            {
                "label": label[: -len(".trace.json")]
                if label.endswith(".trace.json")
                else label,
                "kind": "trace",
                "pid": pids[0] if pids else 0,
                "ident": None,
                "base_unix": base,
                "events": events,
                "truncated": False,
                "dropped": 0,
            }
        )
    return sources, skipped


def _merge_sources(sources: List[Dict]) -> "tuple[List[dict], Optional[float]]":
    """Shift every source's events into ONE timeline: the reference frame is
    the EARLIEST ``base_unix`` (the first process to come up), the same
    unix-twin realignment ``merge_trace_events`` uses. Sources with no base
    stamp land unshifted (best effort beats dropped evidence)."""
    bases = [s["base_unix"] for s in sources if s["base_unix"] is not None]
    base0 = min(bases) if bases else None
    out: List[dict] = []
    for s in sources:
        shift_us = 0.0
        if base0 is not None and s["base_unix"] is not None:
            shift_us = (s["base_unix"] - base0) * 1e6
        named = {
            e.get("pid")
            for e in s["events"]
            if e.get("ph") == "M" and e.get("name") == "process_name"
        }
        pids = {e.get("pid") for e in s["events"] if e.get("pid") is not None}
        for pid in sorted(p for p in pids - named if p is not None):
            out.append(
                {
                    "name": "process_name",
                    "ph": "M",
                    "pid": pid,
                    "args": {"name": s["label"]},
                }
            )
        for ev in s["events"]:
            if shift_us and "ts" in ev:
                ev = dict(ev)
                ev["ts"] = round(ev["ts"] + shift_us, 3)
            out.append(ev)
    return out, base0


# span/instant categories that narrate an incident, in rough ladder order
_INCIDENT_SPAN_CATS = ("recover", "rdzv")
_INCIDENT_INSTANT_CATS = ("elastic", "rdzv", "fault", "health")


def _incident_report(
    sources: List[Dict], merged: List[dict], base0: Optional[float]
) -> Dict:
    """Structured incident report over the merged, realigned events: per
    process, the last spooled evidence and the recovery spans (detection →
    drain → rebuild); fleet-wide, the chronological instant-event
    timeline."""

    def _wall(ts_us: float) -> Optional[float]:
        return None if base0 is None else round(base0 + ts_us / 1e6, 3)

    procs: Dict[int, Dict] = {}
    for s in sources:
        procs.setdefault(int(s.get("pid") or 0), {}).update(
            source=s["label"],
            kind=s["kind"],
            ident=s.get("ident"),
            truncated=bool(s.get("truncated")),
            dropped=int(s.get("dropped") or 0),
        )
    timeline: List[Dict] = []
    for ev in merged:
        pid = ev.get("pid", 0)
        info = procs.setdefault(int(pid), {"source": str(pid), "kind": "?"})
        if ev.get("ph") == "M":
            continue
        info["events"] = info.get("events", 0) + 1
        ts = float(ev.get("ts", 0.0))
        end = ts + float(ev.get("dur", 0.0))
        if end >= info.get("last_ts", float("-inf")):
            info["last_ts"] = end
        tail = info.setdefault("_tail", [])
        tail.append({"name": ev.get("name"), "ts_us": round(ts, 1)})
        if len(tail) > 8:
            del tail[0]
        if ev.get("ph") == "X" and ev.get("cat") in _INCIDENT_SPAN_CATS:
            info.setdefault("recovery_spans", []).append(
                {
                    "name": ev.get("name"),
                    "start_s": round(ts / 1e6, 4),
                    "dur_s": round(float(ev.get("dur", 0.0)) / 1e6, 4),
                    "wall_unix": _wall(ts),
                }
            )
        if ev.get("ph") == "i" and ev.get("cat") in _INCIDENT_INSTANT_CATS:
            timeline.append(
                {
                    "ts_us": round(ts, 1),
                    "wall_unix": _wall(ts),
                    "pid": pid,
                    "cat": ev.get("cat"),
                    "name": ev.get("name"),
                    "args": ev.get("args") or {},
                }
            )
    timeline.sort(key=lambda e: e["ts_us"])
    decisions = sum(
        1
        for ev in merged
        if ev.get("ph") == "i" and ev.get("cat") == "decision"
    )
    for info in procs.values():
        info["last_events"] = info.pop("_tail", [])
        if "last_ts" in info:
            info["last_seen_unix"] = _wall(info.pop("last_ts"))
        if "recovery_spans" in info:
            info["recovery_spans"].sort(key=lambda s: s["start_s"])
    return {
        "processes": {str(pid): info for pid, info in sorted(procs.items())},
        "timeline": timeline,
        "decision_events": decisions,
    }


def _render_incident(report: Dict, out_trace: str) -> str:
    lines: List[str] = [f"merged Perfetto trace: {out_trace}", ""]
    for pid, info in report["processes"].items():
        head = f"process {pid} ({info.get('kind', '?')}:{info.get('source')})"
        if info.get("ident") is not None:
            head += f" ident={info['ident']}"
        if info.get("truncated"):
            head += "  [TORN TAIL: died mid-write]"
        lines.append(head)
        lines.append(
            f"  events: {info.get('events', 0)}"
            + (
                f", dropped at spool: {info['dropped']}"
                if info.get("dropped")
                else ""
            )
            + (
                f", last seen unix {info['last_seen_unix']}"
                if info.get("last_seen_unix") is not None
                else ""
            )
        )
        if info.get("last_events"):
            tail = ", ".join(e["name"] for e in info["last_events"])
            lines.append(f"  last events: {tail}")
        for sp in info.get("recovery_spans", ()):
            lines.append(
                f"  recovery span {sp['name']}: start +{sp['start_s']:.3f}s, "
                f"{sp['dur_s']:.3f}s"
            )
        lines.append("")
    if report["timeline"]:
        lines.append("fleet timeline (detection → drain → rebuild):")
        rows = []
        for ev in report["timeline"]:
            args = ev["args"]
            brief = ", ".join(
                f"{k}={args[k]}"
                for k in ("peer", "reason", "ranks", "procs", "gen", "roster",
                          "worker", "verdict", "signal", "phase", "epoch")
                if k in args
            )
            rows.append(
                [
                    f"+{ev['ts_us'] / 1e6:.3f}s",
                    f"p{ev['pid']}",
                    ev["cat"],
                    ev["name"],
                    brief,
                ]
            )
        lines.append(_fmt_table(rows, ["t", "proc", "cat", "event", "detail"]))
    if report["decision_events"]:
        lines.append("")
        lines.append(
            f"{report['decision_events']} controller decision event(s) "
            "recorded — `graftscope decisions` renders the journal"
        )
    return "\n".join(lines).rstrip()


def postmortem(
    dir_or_file: str, out: Optional[str] = None, as_json: bool = False
) -> str:
    """Stitch every spool/trace under ``dir_or_file`` into one Perfetto
    trace and produce the incident report. Returns the rendered report (or
    its JSON form)."""
    out_trace = out or (
        os.path.join(dir_or_file, "postmortem.trace.json")
        if os.path.isdir(dir_or_file)
        else dir_or_file + ".postmortem.trace.json"
    )
    sources, skipped = _gather_sources(dir_or_file, exclude={out_trace})
    if not sources:
        raise ValueError(f"no readable spool/trace files under {dir_or_file}")
    merged, base0 = _merge_sources(sources)
    payload = {
        "traceEvents": merged,
        "displayTimeUnit": "ms",
        "graftscope": {
            # the marker _gather_sources keys on: this artifact is an
            # OUTPUT, never a source for a later stitch
            "postmortem": True,
            "merged": [s["label"] for s in sources],
            "skipped": skipped,
            "truncated": [
                s["label"] for s in sources if s.get("truncated")
            ],
        },
    }
    if base0 is not None:
        payload["graftscope"]["base_unix"] = base0
    tmp = out_trace + ".tmp"
    with open(tmp, "w") as f:
        json.dump(payload, f)
    os.replace(tmp, out_trace)
    report = _incident_report(sources, merged, base0)
    report["skipped"] = skipped
    report["trace"] = out_trace
    if as_json:
        return json.dumps(report)
    return _render_incident(report, out_trace)


# -------------------------------------------------------------- decisions


def _decision_events(path: str) -> List[dict]:
    """cat=="decision" instants from a trace file, spool file, or directory
    of spools — the controller journal's offline surface."""
    if os.path.isdir(path) or path.endswith(".spool"):
        sources, _ = _gather_sources(path)
        if not sources:
            # an empty/missing spool dir used to render the friendly
            # "no decision events" note and exit 0 — masking a wrong path
            # in CI scripts; no evidence at all is an error, not a journal
            raise ValueError(f"no readable spool/trace files under {path}")
        events, _ = _merge_sources(sources)
    else:
        events = load_trace(path)
    return [
        e
        for e in events
        if e.get("ph") == "i" and e.get("cat") == "decision"
    ]


def _paired_decisions(evs: List[dict]) -> "tuple[List[dict], int]":
    """Normalize decision instants into rows with a derived ``outcome``.
    The live journal annotates outcomes in place, but the trace stream
    keeps each ``dbs_decision`` as decided and interleaves ``dbs_switch``/
    ``dbs_deferred`` after it — pairing re-derives what actually happened.
    Also returns the largest ``journal_dropped`` count seen (ring-eviction
    honesty for the header). ``dbs_config`` instants are construction
    metadata, not verdicts — skipped here (the replay lab reads them)."""
    rows: List[dict] = []
    last: Optional[dict] = None
    dropped = 0
    for e in evs:
        name = e.get("name")
        a = dict(e.get("args") or {})
        dropped = max(dropped, int(a.get("journal_dropped", 0) or 0))
        if name == "dbs_config":
            continue
        row = {"name": name, "ts": e.get("ts"), "args": a}
        if name in ("dbs_decision", "pool_decision"):
            row["outcome"] = a.get("outcome") or (
                "pending" if a.get("switch") else "hold"
            )
            last = row
        elif name == "dbs_switch":
            row["outcome"] = "committed"
            if last is not None and last["name"] == "dbs_decision":
                last["outcome"] = "committed"
        elif name == "dbs_deferred":
            row["outcome"] = "deferred"
            if last is not None and last["name"] == "dbs_decision":
                last["outcome"] = "deferred"
        rows.append(row)
    return rows, dropped


def _decision_row_cells(row: dict) -> List[str]:
    a = row["args"]
    if row["name"] == "dbs_deferred":
        return ["-", "-", "deferred", "-", "-", "-", "-", "-",
                "engine warm-gate", row["outcome"]]
    if row["name"] == "pool_decision":
        # the OUTER loop's verdicts (many-stream device allocation): the
        # win column carries the modeled makespan gain, the batches column
        # the proposed per-tenant device counts
        verdict = "MIGRATE" if a.get("switch") else "hold"
        gain = a.get("modeled_gain")
        return [
            str(a.get("epoch", "-")),
            str(a.get("window", "-")),
            verdict,
            a.get("reason", "-"),
            "-" if gain is None else f"{gain:.4f}",
            "-", "-", "-",
            str(a.get("proposed_counts", "-")),
            row["outcome"],
        ]
    verdict = "SWITCH" if a.get("switch") else "hold"
    if row["name"] == "dbs_switch":
        verdict = "committed"
    return [
        str(a.get("epoch", a.get("eval", "-"))),
        str(a.get("window", "-")),
        verdict,
        a.get("reason", "-"),
        f"{a.get('predicted_win_s', 0.0):.4f}",
        f"{a.get('cur_step_s', 0.0):.4f}",
        f"{a.get('new_step_s', 0.0):.4f}",
        f"{a.get('cost_est_s', a.get('switch_cost_s', 0.0)):.4f}",
        str(a.get("candidate_batches", a.get("batches", "-"))),
        row["outcome"],
    ]


_DECISION_HEADER = ["epoch", "win", "verdict", "reason", "win_s", "cur_step",
                    "new_step", "cost_s", "batches", "outcome"]


def decisions(
    path: str,
    as_json: bool = False,
    outcome: Optional[str] = None,
    since: Optional[int] = None,
    as_csv: bool = False,
) -> str:
    """Render the decision journal (inner DBS controller AND the outer
    many-stream allocator): one row per evaluation with verdict, reason,
    derived outcome, and the inputs behind it. ``outcome`` filters to
    committed/deferred/hold rows; ``since`` keeps rows at epoch >= N (rows
    with no epoch tag are dropped under the filter); ``as_csv`` exports
    the table machine-readably. An empty result — no decision events at
    all, or none surviving the filters — raises (exit 2), consistent with
    postmortem/conformance."""
    rows, dropped = _paired_decisions(_decision_events(path))
    if outcome is not None:
        rows = [r for r in rows if r["outcome"] == outcome]
    if since is not None:
        rows = [
            r
            for r in rows
            if r["args"].get("epoch") is not None
            and int(r["args"]["epoch"]) >= int(since)
        ]
    if not rows:
        raise ValueError(
            f"no controller decision events under {path}"
            + (" (after filters)" if outcome is not None or since is not None
               else " (run with --rebalance window and --trace on|ring)")
        )
    if as_json:
        return json.dumps(
            [
                {"name": r["name"], "ts": r["ts"], "outcome": r["outcome"],
                 **r["args"]}
                for r in rows
            ]
        )
    cells = [_decision_row_cells(r) for r in rows]
    if as_csv:
        import csv
        import io

        buf = io.StringIO()
        w = csv.writer(buf)
        w.writerow(_DECISION_HEADER)
        w.writerows(cells)
        return buf.getvalue().rstrip("\n")
    head = f"{len(rows)} decision row(s)"
    if dropped:
        head += (
            f" — journal_dropped={dropped} older evaluation(s) evicted "
            "from the ring (the journal head is truncated)"
        )
    return head + "\n" + _fmt_table(cells, _DECISION_HEADER)


# ---------------------------------------------------------- controller lab


def replay_cmd(
    path: str, knobs: Dict, as_json: bool = False
) -> "tuple[str, bool]":
    """``graftscope replay``: re-run a recorded decision journal through a
    fresh controller (balance/replaylab.py). With no knob overrides this
    is the strict parity gate; with overrides it is a counterfactual.
    Returns ``(rendered, ok)`` — ``ok=False`` (exit 1) on parity drift or
    invariant violations."""
    from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab

    overrides = {k: v for k, v in knobs.items() if v is not None}
    corpus = replaylab.load_corpus(path)
    report = replaylab.replay(corpus, knobs=overrides or None)
    ok = not report["mismatches"] and not report["invariant_violations"]
    if as_json:
        return json.dumps(report), ok
    lines = [
        f"replay: {report['entries']} journal entr(ies) from "
        f"{report.get('label')} [{report['mode']}]",
        "  knobs: "
        + ", ".join(f"{k}={v}" for k, v in report["knobs"].items()),
        f"  recorded: {report['recorded']['switches']} switch(es), "
        f"{report['recorded']['deferred']} deferred, modeled wall "
        f"{report['recorded']['modeled_wall_s']}s "
        f"(spend {report['recorded']['switch_spend_s']}s)",
        f"  replayed: {report['replayed']['switches']} switch(es), "
        f"{report['replayed']['deferred']} deferred, modeled wall "
        f"{report['replayed']['modeled_wall_s']}s "
        f"(spend {report['replayed']['switch_spend_s']}s, ledger "
        f"spent {report['replayed']['spent_s']}s / credit "
        f"{report['replayed']['credit_s']}s)",
        f"  never-switch hold wall: {report['hold_modeled_wall_s']}s",
    ]
    if report["mode"] == "strict":
        lines.append(
            "  parity: OK — recorded verdict sequence reproduced"
            if report["parity"]
            else f"  parity: DRIFT — {len(report['mismatches'])} mismatch(es)"
        )
        for m in report["mismatches"][:10]:
            lines.append(f"    entry {m['index']}: {m['field']} — {m['detail']}")
    for v in report["invariant_violations"][:10]:
        lines.append(
            f"  INVARIANT VIOLATION @ eval {v['eval']}: {v['invariant']} "
            f"({v['detail']})"
        )
    if report["invariant_violations"]:
        lines.append(
            f"  invariants: {len(report['invariant_violations'])} violation(s)"
        )
    else:
        lines.append("  invariants: clean")
    return "\n".join(lines), ok


def sweep_cmd(
    scenarios: Optional[str],
    world_size: int,
    grid: str,
    n_random: int,
    seed: int,
    as_json: bool = False,
    out: Optional[str] = None,
) -> "tuple[str, bool]":
    """``graftscope sweep``: device-free knob sweep over the synthesized
    scenario library, ranked by geometric-mean speedup over the hold
    baseline. ``ok=False`` (exit 1) when any simulated journal violates
    the controller invariants."""
    from dynamic_load_balance_distributeddnn_tpu_torch.balance import replaylab

    lib = replaylab.builtin_scenarios(world_size)
    if scenarios:
        want = [s.strip() for s in scenarios.split(",") if s.strip()]
        by_name = {sc.name: sc for sc in lib}
        unknown = [w for w in want if w not in by_name]
        if unknown:
            raise ValueError(
                f"unknown scenario(s) {unknown}; available: "
                + ", ".join(sorted(by_name))
            )
        lib = [by_name[w] for w in want]
    knob_sets = replaylab.knob_grid(grid)
    if n_random > 0:
        knob_sets = knob_sets + replaylab.random_knobs(n_random, seed=seed)
    report = replaylab.sweep(lib, knob_sets)
    ok = report["invariant_violations"] == 0
    if out:
        with open(out, "w") as fh:
            json.dump(report, fh, indent=2, sort_keys=True)
    if as_json:
        return json.dumps(report), ok
    rows = [
        [
            str(i + 1),
            json.dumps(r["knobs"]) if isinstance(r["knobs"], dict)
            else r["knobs"],
            f"{r['score']:.4f}",
            str(r["switches"]),
            f"{r['spent_s']:.4f}",
        ]
        for i, r in enumerate(report["results"][:10])
    ]
    lines = [
        f"sweep: {report['candidates']} knob set(s) x "
        f"{len(report['scenarios'])} scenario(s) "
        f"({', '.join(report['scenarios'])})",
        _fmt_table(rows, ["rank", "knobs", "speedup_vs_hold", "switches",
                          "spent_s"]),
    ]
    if report["best"] and report["default"]:
        lines.append(
            f"best {report['best']['score']:.4f} vs default "
            f"{report['default']['score']:.4f} "
            f"(x{report['best_vs_default']})"
        )
    lines.append(
        "invariants: clean across every simulated journal"
        if ok
        else f"invariants: {report['invariant_violations']} VIOLATION(S)"
    )
    if out:
        lines.append(f"full ranked report -> {out}")
    return "\n".join(lines), ok


# ------------------------------------------------------------ conformance


def conformance(dir_or_file: str, as_json: bool = False) -> "tuple[str, bool]":
    """The JAX package replays every recorded ``rdzv_*`` instant against
    its rendezvous protocol automaton (``analysis/flow/proto.py``). This
    port has neither the automaton nor the rendezvous
    (``runtime/rendezvous.py``) yet, so nothing records those instants:
    raises ``NotImplementedError`` naming them (the command exits 2)."""
    raise NotImplementedError(
        f"conformance {dir_or_file}: needs the rendezvous protocol automaton "
        "(analysis/flow/proto.py) and the elastic rendezvous "
        "(runtime/rendezvous.py), which this port does not have yet"
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="graftscope",
        description=(
            "Summarize/diff graftscope traces (Chrome-trace JSON from "
            "--trace on|ring; open the same file in ui.perfetto.dev for "
            "the timeline view)."
        ),
    )
    sub = p.add_subparsers(dest="cmd", required=True)
    s = sub.add_parser("summarize", help="per-phase epoch-attribution table")
    s.add_argument("trace")
    s.add_argument("--epoch", type=int, default=None)
    s.add_argument("--json", action="store_true")
    s.add_argument("--no-workers", action="store_true",
                   help="do not stitch sibling compile_worker_*.trace.json")
    s.add_argument("--by-job", action="store_true",
                   help="attribute wall per tenant (many-stream traces: one "
                   "row per job tag instead of per epoch index)")
    d = sub.add_parser("diff", help="phase-total deltas between two traces")
    d.add_argument("trace_a")
    d.add_argument("trace_b")
    d.add_argument("--json", action="store_true")
    m = sub.add_parser(
        "merge",
        help="write the run trace with sibling compile-worker traces "
        "stitched in (one Perfetto-loadable artifact)",
    )
    m.add_argument("trace")
    m.add_argument("-o", "--out", default=None,
                   help="output path (default: rewrite the run trace)")
    pm = sub.add_parser(
        "postmortem",
        help="flight-recorder stitcher: merge every *.spool (crash-durable "
        "spools, torn tails tolerated) and *.trace.json under a directory "
        "into one pid-tagged Perfetto trace + a textual incident report",
    )
    pm.add_argument("dir", help="directory of spools/traces (or one file)")
    pm.add_argument("-o", "--out", default=None,
                    help="merged trace path (default: "
                    "<dir>/postmortem.trace.json)")
    pm.add_argument("--json", action="store_true",
                    help="structured incident report instead of text")
    dc = sub.add_parser(
        "decisions",
        help="render the online-DBS controller's decision journal (every "
        "switch/hold verdict with its recorded inputs) from a trace, "
        "spool, or spool directory",
    )
    dc.add_argument("path")
    dc.add_argument("--json", action="store_true")
    dc.add_argument("--outcome", choices=("committed", "deferred", "hold"),
                    default=None,
                    help="only rows whose derived outcome matches")
    dc.add_argument("--since", type=int, default=None, metavar="EPOCH",
                    help="only rows at epoch >= EPOCH (rows with no epoch "
                    "tag, e.g. outer pool_decision rows, are dropped)")
    dc.add_argument("--csv", action="store_true",
                    help="CSV export of the decision table")
    rp = sub.add_parser(
        "replay",
        help="controller lab: re-run a recorded decision journal (corpus "
        "JSON, trace, spool, or spool directory) through a fresh "
        "controller — strict parity gate by default, counterfactual with "
        "knob overrides (exit 1 on parity drift or invariant violations)",
    )
    rp.add_argument("path", help="corpus/snapshot JSON, trace file, .spool, "
                    "or spool directory")
    rp.add_argument("--hysteresis", type=float, default=None)
    rp.add_argument("--margin", type=float, default=None)
    rp.add_argument("--budget-frac", type=float, default=None)
    rp.add_argument("--rate-alpha", type=float, default=None)
    rp.add_argument("--json", action="store_true")
    sw = sub.add_parser(
        "sweep",
        help="controller lab: device-free knob sweep over the synthesized "
        "scenario library (spike/brownout/diurnal/kill-storm ...), ranked "
        "by geomean speedup over the hold baseline (exit 1 on invariant "
        "violations in any simulated journal)",
    )
    sw.add_argument("--scenarios", default=None,
                    help="comma-separated subset of builtin scenario names "
                    "(default: all)")
    sw.add_argument("--world-size", type=int, default=4)
    sw.add_argument("--grid", choices=("small", "full"), default="small",
                    help="knob grid density (default small: 18 points)")
    sw.add_argument("--random", type=int, default=0, metavar="N",
                    help="add N seeded log-uniform random knob sets")
    sw.add_argument("--seed", type=int, default=0)
    sw.add_argument("--json", action="store_true")
    sw.add_argument("-o", "--out", default=None,
                    help="also write the full ranked JSON report here")
    cf = sub.add_parser(
        "conformance",
        help="not in this port yet: needs the rendezvous protocol "
        "automaton (analysis/flow/proto.py) and the rendezvous; exits 2",
    )
    cf.add_argument("dir", help="directory of spools/traces (or one file)")
    cf.add_argument("--json", action="store_true")
    return p


def main(argv: Optional[List[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        if args.cmd == "summarize":
            if args.by_job:
                if args.epoch is not None:
                    raise ValueError("--by-job and --epoch are exclusive")
                print(
                    summarize_by_job(
                        args.trace,
                        as_json=args.json,
                        with_workers=not args.no_workers,
                    )
                )
            else:
                print(
                    summarize(
                        args.trace,
                        epoch=args.epoch,
                        as_json=args.json,
                        with_workers=not args.no_workers,
                    )
                )
        elif args.cmd == "merge":
            workers = _worker_traces(args.trace)
            out = merge_trace_files(args.trace, workers, out_path=args.out)
            print(f"merged {len(workers)} worker trace(s) -> {out}")
        elif args.cmd == "postmortem":
            print(postmortem(args.dir, out=args.out, as_json=args.json))
        elif args.cmd == "decisions":
            print(
                decisions(
                    args.path,
                    as_json=args.json,
                    outcome=args.outcome,
                    since=args.since,
                    as_csv=args.csv,
                )
            )
        elif args.cmd == "replay":
            text, ok = replay_cmd(
                args.path,
                {
                    "hysteresis": args.hysteresis,
                    "margin": args.margin,
                    "budget_frac": args.budget_frac,
                    "rate_alpha": args.rate_alpha,
                },
                as_json=args.json,
            )
            print(text)
            if not ok:
                return 1
        elif args.cmd == "sweep":
            text, ok = sweep_cmd(
                args.scenarios,
                args.world_size,
                args.grid,
                args.random,
                args.seed,
                as_json=args.json,
                out=args.out,
            )
            print(text)
            if not ok:
                return 1
        elif args.cmd == "conformance":
            text, ok = conformance(args.dir, as_json=args.json)
            print(text)
            if not ok:
                return 1
        else:
            print(diff(args.trace_a, args.trace_b, as_json=args.json))
    except (OSError, ValueError, KeyError, NotImplementedError) as exc:
        print(f"graftscope: {exc}", file=sys.stderr)
        return 2
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
