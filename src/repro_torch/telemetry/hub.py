"""The telemetry hub: typed structured events, sampled time-series probes,
and the stall-attribution ledger.

One :class:`Telemetry` instance observes a whole run — a single
``simulate()`` core or an N-GPU ``simulate_cluster`` fleet (every core
shares the hub; events carry their originating track). The hub is strictly
an *observer*: emission never mutates simulation state, and every emission
site in the simulator/cluster layers is guarded by ``telemetry is not None``
— a run with ``telemetry=None`` takes exactly today's code paths, which is
the same structural bit-for-bit guarantee the peer-prefetch fabric and the
fault runtime already follow (machinery that is off is never constructed).

Three data planes:

  * **events** — timestamped, typed (:data:`EVENT_TYPES`) records with a
    Chrome ``trace_event`` phase (``B``/``E`` duration pairs for context
    switches, ``X`` complete spans for fault service / migrations /
    checkpoints, ``i`` instants for admissions / sheds / failures);
  * **series** — ``(track, name) -> [(t, value), ...]`` counters sampled at
    quantum boundaries (per-GPU HBM occupancy, queue depths — strided by
    ``sample_stride``) and rebalance ticks (per-link in-flight bytes and
    sharer counts, host staging usage);
  * **ledger** — the :class:`StallLedger`, accumulating per-task stall
    micro-seconds by cause as the simulation attributes them, and resolving
    them into a conservation-checked breakdown at :meth:`Telemetry.finalize`.

Long fault-thrashing runs can emit millions of ``fault_service`` spans;
``max_events`` caps the event list (never silently: drops are counted in
``dropped_events`` and exported). ``E`` events are exempt from the cap so
begin/end pairs stay balanced for the trace validator.

Copied from the JAX package's ``telemetry/hub.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

# Every structured event type the simulator and cluster layers emit. The
# context switch is one logical type emitted as a B/E pair ("switch_begin/
# end" in the docs); everything else is a complete span or an instant.
EVENT_TYPES = frozenset(
    {
        "switch",  # B/E pair around one timeslice (ctrl + commands)
        "fault_service",  # X: demand-paging stall on one command
        "migration_plan",  # X: proactive population / cluster move transit
        "migration_land",  # i: a migrated continuation arrives on dst
        "peer_fetch",  # X: NVLink peer-HBM fetch in flight
        "eviction_batch",  # i: batched eviction at a context switch
        "admission",  # i: a queued request is admitted
        "shed",  # i: admission reject or graceful-degradation shed
        "checkpoint",  # X: periodic D2H working-set snapshot
        "gpu_fail",  # i: device failure boundary
        "gpu_recover",  # i: device back up
        "rebalance_tick",  # i: one rebalancer tick on the cluster track
        "transfer_plan",  # X: one planner window (admission -> makespan)
        "recovery",  # i: one recovery decision for a fault victim
        "finish",  # i: a task retires
        "coordinator_crash",  # i: control plane lost its volatile state
        "coordinator_recover",  # i: control plane back up (journal or cold)
        "journal_replay",  # i: decision-journal replay at recovery
        "deadline_miss",  # i: an RT task projected to miss its deadline
        "preempt",  # i: deadline enforcement preempted a BE task
        "cancel",  # i: operator cancel through the control plane
    }
)

_PHASES = frozenset({"B", "E", "X", "i"})

# Cluster-scope events (rebalance ticks) live on this track; link counters
# live on "link:<a><-><b>" tracks and host staging on "host".
TRACK_CLUSTER = "cluster"


@dataclasses.dataclass
class TelemetryEvent:
    """One structured event. ``ts_us``/``dur_us`` are simulation
    micro-seconds (the Chrome trace_event native unit)."""

    ts_us: float
    name: str
    ph: str  # "B" | "E" | "X" | "i"
    track: str  # GPU name, "cluster", "host", or "link:a<->b"
    dur_us: float = 0.0
    task_id: Optional[int] = None
    args: Dict[str, object] = dataclasses.field(default_factory=dict)


class LedgerConservationError(AssertionError):
    """A task's attributed stall time exceeds its non-compute wall gap —
    some source double-counted. Raised by :meth:`StallLedger.breakdown`."""


# Public attribution taxonomy (docs/observability.md): every µs of a
# finished task's non-compute wall time lands in exactly one bucket.
STALL_CATEGORIES = (
    "fault-service",
    "migration-wait",
    "queue-wait",
    "link-contention",
    "recovery",
    "scheduler-control",
)

# Internal accumulator keys. migration-wait has two components with
# different conservation roles: ready-view delays *inside* a timeslice
# (counted within TaskStats.busy_us, so they must be subtracted to recover
# pure compute) and inter-GPU transit *outside* any timeslice.
_ACC_KEYS = (
    "fault_service",
    "mig_wait_exec",
    "mig_wait_transit",
    "link_contention",
    "recovery",
    "scheduler_control",
)

# float tolerance for the conservation assertion, in µs per µs of wall
_CONSERVATION_RTOL = 1e-6


class StallLedger:
    """Per-task stall accumulator + conservation-checked resolver.

    The simulator attributes stalls as they happen (``add``); at the end of
    a run :meth:`breakdown` resolves each *finished* request's accumulators
    against its merged record and task stats:

    ``wall = finished_us - arrival_us``
    ``compute = busy_us - fault_service - mig_wait_exec``  (busy includes
    in-slice stalls, so pure compute is recovered by subtraction)
    ``queue-wait = wall - compute - (all directly-attributed buckets)``

    queue-wait is the residual by construction, which is what makes the
    conservation *exact*: the six categories sum to ``wall - compute`` to
    float precision. The assertion with teeth is the sign check — a
    materially negative residual means a source double-counted, and
    :class:`LedgerConservationError` is raised.

    One carve-out: the DES simulates timeslices atomically, so a task
    interrupted by a GPU failure mid-slice banks the *whole* slice's
    ``busy_us`` even though the fault boundary cut it short — the victim's
    banked compute can overlap its recovered continuation's timeline and
    exceed the wall gap. For records marked fault-interrupted (``failed_us``
    / ``crashed_us`` / ``recovered_from`` / ``redispatched_from`` in their
    meta) compute is clamped to what the wall can hold and the excess is
    reported as ``overlap_us`` — conservation over the six categories stays
    exact against the clamped compute, and the sign check still fires when
    the directly-attributed buckets alone exceed the wall.
    """

    _INTERRUPTED_META = (
        "failed_us", "crashed_us", "recovered_from", "redispatched_from",
    )

    def __init__(self) -> None:
        self._acc: Dict[int, Dict[str, float]] = {}

    def add(self, task_id: int, key: str, us: float) -> None:
        if key not in _ACC_KEYS:
            raise ValueError(f"unknown stall key {key!r}")
        if us <= 0.0:
            return
        acc = self._acc.get(task_id)
        if acc is None:
            acc = self._acc[task_id] = {}
        acc[key] = acc.get(key, 0.0) + us

    def raw(self, task_id: int) -> Dict[str, float]:
        """The unresolved accumulator (tests / debugging)."""
        return dict(self._acc.get(task_id, {}))

    def breakdown(self, result) -> Dict[int, Dict[str, float]]:
        """Resolve the ledger against a (merged) ``SimResult``. Only
        finished requests resolve — a task with no record (static mode) or
        no completion has no well-defined wall gap. Returns
        ``{task_id: {category: µs, "compute_us": .., "wall_us": ..,
        "non_compute_us": ..}}``."""
        out: Dict[int, Dict[str, float]] = {}
        for rec in result.requests:
            if rec.finished_us is None or rec.rejected:
                continue
            tid = rec.task_id
            st = result.per_task.get(tid)
            if st is None:
                continue
            acc = self._acc.get(tid, {})
            fault = acc.get("fault_service", 0.0)
            mw_exec = acc.get("mig_wait_exec", 0.0)
            mw_transit = acc.get("mig_wait_transit", 0.0)
            link = acc.get("link_contention", 0.0)
            recov = acc.get("recovery", 0.0)
            ctrl = acc.get("scheduler_control", 0.0)
            wall = rec.finished_us - rec.arrival_us
            compute = st.busy_us - fault - mw_exec
            attributed = fault + mw_exec + mw_transit + link + recov + ctrl
            overlap = 0.0
            if any(k in rec.meta for k in self._INTERRUPTED_META):
                # fault-interrupted slice: banked busy may overshoot the
                # failure boundary (see class docstring) — clamp
                ceiling = max(0.0, wall - attributed)
                if compute > ceiling:
                    overlap = compute - ceiling
                    compute = ceiling
            non_compute = wall - compute
            queue = non_compute - attributed
            tol = _CONSERVATION_RTOL * max(1.0, wall)
            if queue < -tol:
                raise LedgerConservationError(
                    f"task {tid}: attributed stall {attributed:.3f}us "
                    f"exceeds non-compute wall {non_compute:.3f}us "
                    f"(residual {queue:.3f}us) — a source double-counted"
                )
            out[tid] = {
                "fault-service": fault,
                "migration-wait": mw_exec + mw_transit,
                "queue-wait": queue,
                "link-contention": link,
                "recovery": recov,
                "scheduler-control": ctrl,
                "compute_us": compute,
                "wall_us": wall,
                "non_compute_us": non_compute,
                "overlap_us": overlap,
            }
        return out


class Telemetry:
    """The hub every instrumented layer emits into.

    ``sample_stride`` thins the per-quantum probes (1 = every context
    switch); rebalance-tick probes are never strided. ``max_events`` bounds
    the event list — see the module docstring.
    """

    def __init__(
        self,
        sample_stride: int = 8,
        max_events: int = 500_000,
        metrics=False,
        audit=False,
    ):
        if sample_stride < 1:
            raise ValueError("sample_stride must be >= 1")
        self.sample_stride = int(sample_stride)
        self.max_events = int(max_events)
        self.events: List[TelemetryEvent] = []
        self.series: Dict[Tuple[str, str], List[Tuple[float, float]]] = {}
        self.ledger = StallLedger()
        self.dropped_events = 0
        self.summary: Dict[str, object] = {}
        self._breakdown: Optional[Dict[int, Dict[str, float]]] = None
        # per-(track, name) count of B events dropped at the cap whose E is
        # still pending — those Es are dropped too, keeping pairs balanced
        self._dropped_open: Dict[Tuple[str, str], int] = {}
        # optional aggregation planes (off by default — the hub alone is the
        # PR-7 surface): a typed MetricsRegistry fed from the same emission
        # stream, and the online prediction auditor. Both are observers; a
        # run with them attached is bit-for-bit identical to one without.
        if metrics is True:
            from repro_torch.telemetry.metrics import MetricsRegistry

            metrics = MetricsRegistry()
        self.metrics = metrics or None
        if audit is True:
            from repro_torch.telemetry.audit import PredictionAuditor

            audit = PredictionAuditor(metrics=self.metrics)
        self.audit = audit or None

    # -- emission -----------------------------------------------------------
    def emit(
        self,
        name: str,
        ph: str,
        track: str,
        ts_us: float,
        dur_us: float = 0.0,
        task_id: Optional[int] = None,
        **args,
    ) -> None:
        if name not in EVENT_TYPES:
            raise ValueError(f"unknown telemetry event {name!r}")
        if ph not in _PHASES:
            raise ValueError(f"unknown trace phase {ph!r}")
        # metrics see every emission *before* the cap: the cap bounds trace
        # memory, not counter arithmetic — capped runs keep true totals
        if self.metrics is not None:
            self.metrics.on_event(name, ph, track, ts_us, dur_us, args)
            if name == "rebalance_tick":
                self._bank_rollup(ts_us)
        # "E" is exempt from the cap so B/E pairs stay balanced — but an E
        # whose own B was dropped must be dropped too, or the validator sees
        # an unmatched E (per-(track, name) bookkeeping below)
        if ph == "E":
            key = (track, name)
            pending = self._dropped_open.get(key, 0)
            if pending:
                self._dropped_open[key] = pending - 1
                self.dropped_events += 1
                return
        elif len(self.events) >= self.max_events:
            self.dropped_events += 1
            if ph == "B":
                key = (track, name)
                self._dropped_open[key] = self._dropped_open.get(key, 0) + 1
            return
        self.events.append(
            TelemetryEvent(ts_us, name, ph, track, dur_us, task_id, args)
        )

    def begin(self, name, track, ts_us, task_id=None, **args) -> None:
        self.emit(name, "B", track, ts_us, task_id=task_id, **args)

    def end(self, name, track, ts_us, task_id=None, **args) -> None:
        self.emit(name, "E", track, ts_us, task_id=task_id, **args)

    def span(self, name, track, ts_us, dur_us, task_id=None, **args) -> None:
        self.emit(
            name, "X", track, ts_us, dur_us=max(0.0, dur_us),
            task_id=task_id, **args,
        )

    def instant(self, name, track, ts_us, task_id=None, **args) -> None:
        self.emit(name, "i", track, ts_us, task_id=task_id, **args)

    def counter(self, track: str, name: str, ts_us: float, value) -> None:
        self.series.setdefault((track, name), []).append(
            (ts_us, float(value))
        )
        if self.metrics is not None:
            self.metrics.on_counter(track, name, value)

    def stall(self, task_id: int, key: str, us: float) -> None:
        self.ledger.add(task_id, key, us)

    # -- finalization -------------------------------------------------------
    def finalize(self, result) -> Dict[int, Dict[str, float]]:
        """Resolve the stall ledger against a finished run's (merged)
        ``SimResult`` and bank the run summary. Called automatically by
        ``simulate()`` / ``simulate_cluster()`` when a hub is attached."""
        self._breakdown = self.ledger.breakdown(result)
        self.summary.update(
            sim_us=result.sim_us,
            faults=result.faults,
            migrated_bytes=result.migrated_bytes,
            switches=result.switches,
            control_us=result.control_us,
            dropped_events=self.dropped_events,
        )
        if self.metrics is not None:
            self._bank_rollup(result.sim_us)
        if self.audit is not None:
            self.summary["prediction_audit"] = self.audit.health()
        return self._breakdown

    def finalize_cluster(self, report) -> Dict[int, Dict[str, float]]:
        """Cluster variant: resolves against the merged fleet result and
        adds fleet-level counters to the summary."""
        bd = self.finalize(report.merged)
        self.summary.update(
            n_gpus=report.n_gpus,
            migrations=len(report.migrations),
            peer_fetch_bytes=report.peer_fetch_bytes,
            recoveries=len(report.recoveries),
            checkpoints=report.checkpoints,
            faults_applied=report.faults_applied,
        )
        return bd

    def stall_breakdown(self) -> Dict[int, Dict[str, float]]:
        if self._breakdown is None:
            raise RuntimeError(
                "stall ledger not resolved; finalize(result) runs "
                "automatically at the end of simulate()/simulate_cluster()"
            )
        return self._breakdown

    def stall_totals(self) -> Dict[str, float]:
        """Fleet-wide µs per category, summed over finished tasks."""
        totals = {cat: 0.0 for cat in STALL_CATEGORIES}
        totals["compute_us"] = 0.0
        totals["non_compute_us"] = 0.0
        for row in self.stall_breakdown().values():
            for cat in STALL_CATEGORIES:
                totals[cat] += row[cat]
            totals["compute_us"] += row["compute_us"]
            totals["non_compute_us"] += row["non_compute_us"]
        return totals

    # -- metrics plane ------------------------------------------------------
    def _bank_rollup(self, ts_us: float) -> None:
        """One metrics snapshot: audit gauges refreshed first, so the rollup
        row carries current prediction health. Called at every rebalance
        tick and once at finalize — the finalize stamp (merged sim_us) can
        precede the last drain-window tick, so clamp to keep the rollup
        time series monotone."""
        if self.audit is not None:
            self.audit.export_gauges(self.metrics)
        if self.metrics.rollups:
            ts_us = max(ts_us, self.metrics.rollups[-1]["ts_us"])
        self.metrics.rollup(ts_us)

    def metrics_report(self, generated_us: Optional[float] = None):
        """Assemble the versioned :class:`~repro_torch.telemetry.metrics.
        MetricsReport` (registry state + rollups + audit summary). Requires
        ``Telemetry(metrics=True)``."""
        if self.metrics is None:
            raise RuntimeError(
                "no metrics registry attached; construct the hub with "
                "Telemetry(metrics=True)"
            )
        if self.audit is not None:
            self.audit.export_gauges(self.metrics)
        if generated_us is None:
            generated_us = float(self.summary.get("sim_us", 0.0))
        return self.metrics.report(
            generated_us=generated_us,
            audit=self.audit.summary() if self.audit is not None else None,
        )

    # -- export (delegates to repro_torch.telemetry.export) -----------------------
    def chrome_trace(self) -> dict:
        from repro_torch.telemetry.export import chrome_trace

        return chrome_trace(self)

    def write_chrome(self, path) -> None:
        from repro_torch.telemetry.export import write_chrome

        write_chrome(self, path)

    def write_jsonl(self, path) -> None:
        from repro_torch.telemetry.export import write_jsonl

        write_jsonl(self, path)
