#!/usr/bin/env python3
"""``port_msctl`` — operator CLI for the PyTorch port's crash-safe control
plane, the counterpart of ``scripts/msctl.py``: the same subcommands print
the same lines for the same arguments, and each CLI reads the other's
journal dumps and metrics reports.

Three subcommands:

``demo``
    Run a small fleet under the control plane (optionally with a
    coordinator crash/recover cycle mid-run), exercise ``submit``/
    ``cancel`` through the lifecycle state machine, and dump the decision
    journal to ``--journal-out`` for the offline subcommands below.

``journal <dump.json>``
    Pretty-print a journal dump (the ``DecisionJournal.to_json`` format):
    one line per decision, sequence-ordered, with the primitive payload.

``status <dump.json> [--task ID]``
    Replay a journal dump offline through the lifecycle state machine
    (the same ``apply_event`` the in-sim replay uses) and print where
    every task ended up — or one task's state with ``--task``. This is
    the recovery path as a command: the dump alone reconstructs the
    fleet's task states.

``metrics [report.json] [--prom] [--demo]``
    Pretty-print a ``metrics-report-v1`` artifact (counters, gauges,
    histogram percentiles, prediction-audit block), or re-emit it as
    Prometheus text exposition with ``--prom``. With ``--demo``, run the
    demo fleet with the metrics registry and the online prediction
    auditor attached, tail the per-rebalance-tick rollups, and print
    fleet prediction health next to the deadline counters.

The demo fleet is simulated: its GPUs (``RTX5080`` on NVLink) are modeled
``Platform``s in host Python, and nothing runs on a device.

Usage:
  python scripts/port_msctl.py demo [--crash] [--journal-out journal.json]
  python scripts/port_msctl.py journal journal.json
  python scripts/port_msctl.py status journal.json [--task 3]
  python scripts/port_msctl.py metrics report.json [--prom]
  python scripts/port_msctl.py metrics --demo [--out report.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import Counter
from pathlib import Path

sys.path.insert(
    0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
)
from repro_torch.control import (  # noqa: E402
    ControlPlane,
    TaskLifecycle,
    apply_event,
)

# canonical display order for lifecycle summaries (TASK_STATES is a set)
_ORDER = (
    "SUBMITTED", "ADMITTED", "RUNNING", "MIGRATING", "CHECKPOINTED",
    "FAILED", "FINISHED", "CANCELLED", "SHED",
)

# journal kinds with no lifecycle effect — skipped by offline replay, the
# same set ControlPlane._replay skips (markers and queue bookkeeping)
_NON_LIFECYCLE = {"crash", "recover", "hold", "strand", "requeue", "release"}


def _run_demo_fleet(crash: bool, telemetry=None):
    """The shared demo fleet: 2x RTX5080, journal control plane, one
    operator cancel, optional coordinator crash/recover cycle. Returns
    ``(report, control)`` — the caller picks what to print."""
    from repro_torch.cluster import (
        FaultEvent,
        FaultInjector,
        homogeneous,
        simulate_cluster,
    )
    from repro_torch.core.hardware import NVLINK_A100_GBPS, RTX5080
    from repro_torch.core.scheduler import RoundRobinPolicy
    from repro_torch.serving import MSchedAdmission, poisson_trace

    trace = poisson_trace(
        6.0, 1.2, seed=7, tenants=("qwen3-1.7b",), prompt_mean=64,
        output_mean=120, max_output=240, rt_fraction=0.25,
    )
    faults = [
        FaultEvent(300_000.0, "coordinator_crash"),
        FaultEvent(450_000.0, "gpu_fail", gpu="gpu0"),
        FaultEvent(650_000.0, "gpu_recover", gpu="gpu0"),
        FaultEvent(800_000.0, "coordinator_recover"),
    ] if crash else []
    control = ControlPlane(recovery="journal", replay_check=True)
    # operator ops scheduled through the CLI surface: cancel one task
    # mid-run to show the lifecycle edge in the journal
    control.cancel(1, 150_000.0)
    rep = simulate_cluster(
        trace,
        homogeneous(
            2, RTX5080, capacity_bytes=4 << 30,
            nvlink_gbps=NVLINK_A100_GBPS,
        ),
        backend="msched", placement="leastloaded",
        admission_factory=lambda i: MSchedAdmission(headroom=0.9),
        policy_factory=lambda i: RoundRobinPolicy(350_000.0),
        page_size=1 << 20,
        faults=FaultInjector(faults) if faults else FaultInjector.none(),
        control=control, audit=True, drain_factor=20.0,
        telemetry=telemetry,
    )
    return rep, control


def _print_prediction_health(control) -> None:
    health = control.prediction_health()
    if health is None:
        return
    print(
        "prediction: F-={false_negative_pct:.2f}% "
        "F+={false_positive_pct:.2f}% "
        "drift={template_drift_pp:+.2f}pp over {audited_commands} commands "
        "/ {audited_quanta} quanta, "
        "overfetch={overfetch_bytes}B "
        "underfetch-stall={underfetch_stall_us:.0f}us".format(**health)
    )


def cmd_demo(args) -> int:
    rep, control = _run_demo_fleet(args.crash)
    print(
        f"demo run: {rep.stats.n_requests} requests, "
        f"{rep.stats.n_finished} finished, {rep.lost_requests} lost, "
        f"{rep.coordinator_crashes} coordinator crash(es), "
        f"{rep.journal_replays} journal replay(s)"
    )
    counts = Counter(
        control.status(tid) for tid in control.lifecycle.states()
    )
    print("lifecycle:", ", ".join(
        f"{s}={counts[s]}" for s in _ORDER if counts[s]
    ))
    out = Path(args.journal_out)
    out.write_text(json.dumps(control.journal.to_json(), indent=1))
    print(f"journal: {len(control.journal)} records -> {out}")
    return 0


def _load_dump(path: Path) -> list:
    doc = json.loads(path.read_text())
    if not isinstance(doc, list):
        raise SystemExit(f"{path}: not a journal dump (expected a list)")
    return doc


def cmd_journal(args) -> int:
    dump = _load_dump(args.dump)
    if not dump:
        print(f"{args.dump}: empty journal")
        return 0
    for r in dump:
        extra = {
            k: v for k, v in r.items()
            if k not in ("seq", "time_us", "kind", "task_id")
        }
        tid = "-" if r.get("task_id") is None else r["task_id"]
        detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
        print(
            f"{r['seq']:>5}  {r['time_us'] / 1e3:>10.1f}ms  "
            f"{r['kind']:<10} task={tid:<6} {detail}"
        )
    print(f"{len(dump)} records")
    return 0


def cmd_status(args) -> int:
    dump = _load_dump(args.dump)
    lc = TaskLifecycle()
    for r in dump:
        if r["kind"] in _NON_LIFECYCLE:
            continue
        apply_event(lc, r["kind"], r["task_id"], r["time_us"])
    states = lc.states()
    if args.task is not None:
        if args.task not in states:
            print(f"task {args.task}: unknown (never submitted)")
            return 1
        print(f"task {args.task}: {states[args.task]}")
        return 0
    counts = Counter(states.values())
    print(f"{len(states)} tasks from {len(dump)} journal records")
    for s in _ORDER:
        if counts[s]:
            tids = sorted(t for t, st in states.items() if st == s)
            shown = ", ".join(map(str, tids[:12]))
            more = f" (+{len(tids) - 12} more)" if len(tids) > 12 else ""
            print(f"  {s:<13} {counts[s]:>4}  [{shown}{more}]")
    return 0


def _fmt_value(v) -> str:
    if isinstance(v, float):
        return f"{v:.6g}"
    return str(v)


def cmd_metrics(args) -> int:
    if args.demo:
        from repro_torch.telemetry import Telemetry

        tel = Telemetry(metrics=True, audit=True)
        rep, control = _run_demo_fleet(args.crash, telemetry=tel)
        report = tel.metrics_report()
        tail = report.rollups[-args.tail:] if args.tail else report.rollups
        for row in tail:
            keys = sorted(row["values"])
            shown = ", ".join(
                f"{k}={_fmt_value(row['values'][k])}" for k in keys[:6]
            )
            more = f" (+{len(keys) - 6} keys)" if len(keys) > 6 else ""
            print(f"rollup @ {row['ts_us'] / 1e3:>10.1f}ms  {shown}{more}")
        print(
            f"deadlines: {control.deadline_misses} missed of "
            f"{control.rt_requests} rt requests, "
            f"{control.preemptions} preemption(s)"
        )
        _print_prediction_health(control)
        if args.out is not None:
            report.write(args.out)
            print(f"metrics: wrote {args.out}")
        return 0

    if args.report is None:
        raise SystemExit("metrics: need a report path (or --demo)")
    from repro_torch.telemetry import MetricsReport

    report = MetricsReport.from_json(json.loads(args.report.read_text()))
    if args.prom:
        sys.stdout.write(report.to_prometheus())
        return 0
    doc = report.to_json()
    print(
        f"schema: {doc['schema']}  "
        f"generated @ {report.generated_us / 1e3:.1f}ms"
    )
    by_kind = {"counter": [], "gauge": [], "histogram": []}
    for r in doc["metrics"]:
        by_kind[r["kind"]].append(r)
    for kind in ("counter", "gauge"):
        rows = by_kind[kind]
        if rows:
            print(f"{kind}s ({len(rows)}):")
            for r in sorted(rows, key=lambda r: (r["name"], r["track"])):
                print(
                    f"  {r['name']:<32} track={r['track']:<10} "
                    f"{_fmt_value(r['value'])}"
                )
    hists = by_kind["histogram"]
    if hists:
        print(f"histograms ({len(hists)}):")
        for r in sorted(hists, key=lambda r: (r["name"], r["track"])):
            print(
                f"  {r['name']:<32} track={r['track']:<10} "
                f"n={r['count']} p50={_fmt_value(r['p50'])} "
                f"p99={_fmt_value(r['p99'])} sum={_fmt_value(r['sum'])}"
            )
    if report.rollups:
        print(f"rollups: {len(report.rollups)} banked")
    audit = doc.get("audit")
    if audit:
        fleet = audit["fleet"]
        print(
            "prediction audit: F-={:.2f}% F+={:.2f}% over {} commands "
            "({} templates, {} tasks)".format(
                fleet["false_negative_pct"], fleet["false_positive_pct"],
                fleet["commands"], len(audit["per_template"]),
                len(audit["per_task"]),
            )
        )
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    sub = ap.add_subparsers(dest="cmd", required=True)
    demo = sub.add_parser("demo", help="run a control-plane demo fleet")
    demo.add_argument("--crash", action="store_true",
                      help="inject a coordinator crash/recover cycle")
    demo.add_argument("--journal-out", type=Path,
                      default=Path(tempfile.gettempdir()) / "msctl_journal.json",
                      help="where to dump the decision journal (default: the temp dir)")
    demo.set_defaults(fn=cmd_demo)
    jr = sub.add_parser("journal", help="pretty-print a journal dump")
    jr.add_argument("dump", type=Path)
    jr.set_defaults(fn=cmd_journal)
    st = sub.add_parser("status", help="offline lifecycle replay of a dump")
    st.add_argument("dump", type=Path)
    st.add_argument("--task", type=int, default=None,
                    help="show one task's state instead of the summary")
    st.set_defaults(fn=cmd_status)
    mt = sub.add_parser(
        "metrics", help="pretty-print a metrics report or tail a demo run"
    )
    mt.add_argument("report", type=Path, nargs="?", default=None,
                    help="a metrics-report-v1 JSON artifact")
    mt.add_argument("--prom", action="store_true",
                    help="emit Prometheus text exposition instead")
    mt.add_argument("--demo", action="store_true",
                    help="run the demo fleet traced and tail live rollups")
    mt.add_argument("--crash", action="store_true",
                    help="(with --demo) inject a coordinator crash cycle")
    mt.add_argument("--tail", type=int, default=8,
                    help="(with --demo) show the last N rollup rows")
    mt.add_argument("--out", type=Path, default=None,
                    help="(with --demo) also write the report JSON here")
    mt.set_defaults(fn=cmd_metrics)
    args = ap.parse_args()
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
