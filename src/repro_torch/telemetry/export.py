"""Trace exporters and the trace validator.

Two formats:

  * **Chrome trace_event JSON** (:func:`chrome_trace` / :func:`write_chrome`)
    — the object form (``{"traceEvents": [...]}``), loadable in Perfetto and
    ``chrome://tracing``. Each simulation track (GPU, ``cluster``, ``host``,
    ``link:a<->b``) becomes one process (``pid``) named by a ``process_name``
    metadata event, so the viewer shows one swimlane per GPU plus counter
    tracks per link. Durations use ``B``/``E`` pairs (context switches) and
    ``X`` complete events; probes become ``C`` counter events. Extra
    top-level keys (``stallLedger``, ``probes``, ``summary``) ride along —
    trace viewers ignore unknown keys, and ``scripts/trace_report.py`` reads
    them back.
  * **JSONL** (:func:`write_jsonl`) — one self-describing JSON object per
    line (``{"type": "event" | "counter" | "ledger" | "meta", ...}``), for
    streaming consumers that don't want the whole document in memory.

:func:`validate_trace` is the shared checker behind
``scripts/trace_report.py --validate``: schema validity, globally monotone
timestamps, balanced begin/end pairs per track, and exact stall-ledger
conservation.

Copied from the JAX package's ``telemetry/export.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import json
from typing import Dict, List

SCHEMA = "msched-trace-v1"

_CHROME_PHASES = frozenset({"M", "B", "E", "X", "i", "C"})

# conservation check tolerance when re-validating an exported ledger (µs)
_LEDGER_ATOL_US = 1e-3


def _track_order(tracks) -> List[str]:
    """GPU tracks first (trace viewers show pids in order), then cluster/
    host scope, then per-link counter tracks."""

    def key(tr: str):
        if tr.startswith("link:"):
            group = 2
        elif tr in ("cluster", "host"):
            group = 1
        else:
            group = 0
        return (group, tr)

    return sorted(tracks, key=key)


def chrome_trace(tel) -> dict:
    """Render a :class:`~repro_torch.telemetry.hub.Telemetry` hub as a Chrome
    trace_event document (plain dict, ready for ``json.dump``)."""
    tracks = {ev.track for ev in tel.events}
    tracks.update(tr for tr, _name in tel.series)
    ordered = _track_order(tracks)
    pid_of = {tr: i + 1 for i, tr in enumerate(ordered)}

    trace_events: List[dict] = [
        {
            "name": "process_name",
            "ph": "M",
            "pid": pid_of[tr],
            "tid": 0,
            "ts": 0.0,
            "args": {"name": tr},
        }
        for tr in ordered
    ]

    body: List[dict] = []
    for ev in tel.events:
        rec = {
            "name": ev.name,
            "ph": ev.ph,
            "pid": pid_of[ev.track],
            "tid": 0,
            "ts": ev.ts_us,
            "args": dict(ev.args),
        }
        if ev.task_id is not None:
            rec["args"]["task"] = ev.task_id
        if ev.ph == "X":
            rec["dur"] = ev.dur_us
        if ev.ph == "i":
            rec["s"] = "t"  # thread-scoped instant
        body.append(rec)
    for (tr, name), points in tel.series.items():
        pid = pid_of[tr]
        for t, v in points:
            body.append(
                {
                    "name": name,
                    "ph": "C",
                    "pid": pid,
                    "tid": 0,
                    "ts": t,
                    "args": {name: v},
                }
            )
    # cluster cores run sequentially per DES window, so raw emission order
    # interleaves clocks; a stable sort by timestamp restores the global
    # monotone order the validator (and any streaming viewer) expects,
    # while preserving same-instant emission order per track — which is
    # exactly what keeps B/E pairs properly nested.
    body.sort(key=lambda r: r["ts"])
    trace_events.extend(body)

    ledger = {}
    if tel._breakdown is not None:
        ledger = {str(tid): row for tid, row in tel._breakdown.items()}
    return {
        "traceEvents": trace_events,
        "displayTimeUnit": "ms",
        "otherData": {"schema": SCHEMA},
        "stallLedger": ledger,
        "probes": {
            f"{tr}/{name}": [[t, v] for t, v in points]
            for (tr, name), points in tel.series.items()
        },
        "summary": dict(tel.summary),
        "dropped_events": tel.dropped_events,
    }


def write_chrome(tel, path) -> None:
    with open(path, "w") as f:
        json.dump(chrome_trace(tel), f)
        f.write("\n")


def write_jsonl(tel, path) -> None:
    with open(path, "w") as f:
        f.write(
            json.dumps(
                {
                    "type": "meta",
                    "schema": SCHEMA,
                    "summary": dict(tel.summary),
                    "dropped_events": tel.dropped_events,
                }
            )
            + "\n"
        )
        for ev in sorted(tel.events, key=lambda e: e.ts_us):
            rec = {
                "type": "event",
                "ts": ev.ts_us,
                "name": ev.name,
                "ph": ev.ph,
                "track": ev.track,
            }
            if ev.ph == "X":
                rec["dur"] = ev.dur_us
            if ev.task_id is not None:
                rec["task"] = ev.task_id
            if ev.args:
                rec["args"] = dict(ev.args)
            f.write(json.dumps(rec) + "\n")
        for (tr, name), points in tel.series.items():
            for t, v in points:
                f.write(
                    json.dumps(
                        {
                            "type": "counter",
                            "ts": t,
                            "track": tr,
                            "name": name,
                            "value": v,
                        }
                    )
                    + "\n"
                )
        if tel._breakdown is not None:
            for tid, row in tel._breakdown.items():
                f.write(
                    json.dumps({"type": "ledger", "task": tid, **row}) + "\n"
                )


# --------------------------------------------------------------------------
# Validation
# --------------------------------------------------------------------------


def validate_trace(doc) -> List[str]:
    """Check an exported Chrome-trace document. Returns a list of error
    strings (empty = valid). Checks:

      * schema: required keys and types on every event; known phases;
        ``X`` events carry a non-negative ``dur``;
      * monotone timestamps over the event stream (metadata excluded);
      * balanced ``B``/``E`` pairs per ``(pid, tid)`` with matching names;
      * stall-ledger conservation: per task, the six categories sum to the
        non-compute wall gap (to ``1e-3`` µs) and the queue-wait residual
        is not materially negative.
    """
    errors: List[str] = []
    if not isinstance(doc, dict):
        return ["document is not a JSON object"]
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["missing or non-list traceEvents"]

    prev_ts = None
    stacks: Dict[tuple, List[str]] = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event {i}: not an object")
            continue
        name = ev.get("name")
        ph = ev.get("ph")
        ts = ev.get("ts")
        if not isinstance(name, str) or not name:
            errors.append(f"event {i}: missing name")
        if ph not in _CHROME_PHASES:
            errors.append(f"event {i} ({name}): unknown phase {ph!r}")
            continue
        if not isinstance(ev.get("pid"), int) or not isinstance(
            ev.get("tid"), int
        ):
            errors.append(f"event {i} ({name}): missing pid/tid")
            continue
        if ph == "M":
            # metadata events legally carry no timestamp (Chrome format);
            # checking ts first used to flag them as "bad ts None"
            continue
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event {i} ({name}): bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event {i} ({name}): X without valid dur")
        if prev_ts is not None and ts < prev_ts:
            errors.append(
                f"event {i} ({name}): timestamp {ts} < previous {prev_ts} "
                "(not monotone)"
            )
        prev_ts = ts
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(name)
        elif ph == "E":
            stack = stacks.get(key)
            if not stack:
                errors.append(f"event {i} ({name}): E without matching B")
            elif stack[-1] != name:
                errors.append(
                    f"event {i}: E({name}) closes B({stack[-1]}) "
                    f"on track pid={key[0]}"
                )
                stack.pop()
            else:
                stack.pop()
    for key, stack in stacks.items():
        if stack:
            errors.append(
                f"track pid={key[0]}: {len(stack)} unclosed B event(s): "
                f"{stack[-3:]}"
            )

    ledger = doc.get("stallLedger", {})
    if not isinstance(ledger, dict):
        errors.append("stallLedger is not an object")
        ledger = {}
    for tid, row in ledger.items():
        if not isinstance(row, dict):
            errors.append(f"ledger task {tid}: not an object")
            continue
        try:
            cats = [
                row["fault-service"],
                row["migration-wait"],
                row["queue-wait"],
                row["link-contention"],
                row["recovery"],
                row["scheduler-control"],
            ]
            non_compute = row["non_compute_us"]
        except KeyError as missing:
            errors.append(f"ledger task {tid}: missing {missing}")
            continue
        tol = _LEDGER_ATOL_US + 1e-9 * max(abs(non_compute), 1.0)
        if abs(sum(cats) - non_compute) > tol:
            errors.append(
                f"ledger task {tid}: categories sum to {sum(cats):.4f}us, "
                f"non-compute wall is {non_compute:.4f}us"
            )
        if row["queue-wait"] < -tol:
            errors.append(
                f"ledger task {tid}: negative queue-wait residual "
                f"{row['queue-wait']:.4f}us (double-counted attribution)"
            )
    return errors
