"""Typed fleet metrics: counters, gauges, and fixed-bucket histograms.

The registry is the aggregated (vLLM/Prometheus-style) view of the same
emission stream the event trace records verbatim: the hub feeds every
``emit()``/``counter()`` through :meth:`MetricsRegistry.on_event` /
:meth:`MetricsRegistry.on_counter`, so metrics see the *true* totals even
when the event list is capped (`max_events` bounds trace memory, not
counter arithmetic). Like :data:`~repro_torch.telemetry.hub.EVENT_TYPES`, the
metric-name taxonomy is closed — :data:`METRIC_TYPES` maps every legal name
to its kind, and the registry rejects unknown names or kind mismatches.

Three metric kinds, all keyed by ``(name, track)``:

  * **counter** — monotone totals (switches, faults, pages moved, audit
    page counts);
  * **gauge** — last-value samples (queue depths, HBM occupancy, the
    prediction-audit F−/F+ rates);
  * **histogram** — fixed-bucket distributions of span durations. Exact
    samples are retained (up to a cap) so percentiles use the repo-wide
    :func:`repro_torch.core.simulator.percentile` nearest-rank convention —
    trace-, report-, and metrics-derived p50/p99 can never disagree.

``rollup()`` snapshots every counter/gauge; the hub banks one rollup per
rebalance tick and one at ``finalize()``, giving a coarse time series of
fleet health next to the fine-grained probes. :class:`MetricsReport` is the
versioned (``metrics-report-v1``) JSON artifact with two exporters:
``to_json`` and ``to_prometheus`` (text exposition format).

Copied from the JAX package's ``telemetry/metrics.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional, Tuple

from repro_torch.core.simulator import percentile

METRICS_SCHEMA = "metrics-report-v1"
_ACCEPTED_SCHEMAS = (METRICS_SCHEMA,)

COUNTER = "counter"
GAUGE = "gauge"
HISTOGRAM = "histogram"

# Closed metric taxonomy (the registry-side mirror of EVENT_TYPES): every
# name the simulator/cluster/audit layers may touch, with its kind. inc/
# gauge/observe reject names outside this table or used with the wrong kind.
METRIC_TYPES: Dict[str, str] = {
    # -- counters: event-stream totals --------------------------------------
    "switches_total": COUNTER,
    "faults_total": COUNTER,
    "fault_stall_us_total": COUNTER,
    "migration_plans_total": COUNTER,
    "migration_pages_total": COUNTER,
    "migration_lands_total": COUNTER,
    "evicted_pages_total": COUNTER,
    "peer_fetches_total": COUNTER,
    "peer_fetch_pages_total": COUNTER,
    "admissions_total": COUNTER,
    "sheds_total": COUNTER,
    "finishes_total": COUNTER,
    "checkpoints_total": COUNTER,
    "recoveries_total": COUNTER,
    "rebalance_ticks_total": COUNTER,
    "gpu_fails_total": COUNTER,
    "gpu_recovers_total": COUNTER,
    "coordinator_crashes_total": COUNTER,
    "coordinator_recovers_total": COUNTER,
    "journal_replays_total": COUNTER,
    "deadline_misses_total": COUNTER,
    "preempts_total": COUNTER,
    "cancels_total": COUNTER,
    # -- counters: prediction-audit totals (repro_torch.telemetry.audit) ----------
    "audit_commands_total": COUNTER,
    "audit_quanta_total": COUNTER,
    "audit_true_pages_total": COUNTER,
    "audit_pred_pages_total": COUNTER,
    "audit_fneg_pages_total": COUNTER,
    "audit_fpos_pages_total": COUNTER,
    "audit_overfetch_bytes_total": COUNTER,
    "audit_underfetch_stall_us_total": COUNTER,
    # -- gauges: sampled state + audit health rates -------------------------
    "hbm_used_pages": GAUGE,
    "run_queue_depth": GAUGE,
    "wait_queue_depth": GAUGE,
    "inflight_bytes": GAUGE,
    "sharers": GAUGE,
    "staged_bytes": GAUGE,
    "bandwidth_factor": GAUGE,
    "audit_fneg_page_pct": GAUGE,
    "audit_fpos_page_pct": GAUGE,
    "audit_fneg_bytes": GAUGE,
    "audit_fpos_bytes": GAUGE,
    "audit_template_drift_pp": GAUGE,
    # -- histograms: span-duration distributions ----------------------------
    "switch_ctrl_us": HISTOGRAM,
    "fault_stall_us": HISTOGRAM,
    "migration_us": HISTOGRAM,
    "peer_fetch_us": HISTOGRAM,
    "checkpoint_bytes": HISTOGRAM,
}

# default log-ish bucket upper bounds (µs for the duration histograms; the
# byte histogram reuses them at byte scale — fixed buckets, not adaptive)
_DEFAULT_BUCKETS = (
    1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 500.0,
    1e3, 2.5e3, 5e3, 1e4, 2.5e4, 5e4, 1e5, 2.5e5, 1e6, 1e7,
)

# exact-sample retention cap per histogram: enough for every CI-scale run;
# beyond it percentiles are computed over the first N samples (flagged in
# the report) while count/sum stay exact
_MAX_SAMPLES = 100_000


class Histogram:
    """Fixed-bucket histogram with exact-sample percentiles.

    ``buckets`` are cumulative-style upper bounds (a terminal +Inf bucket is
    implicit). ``p50()``/``p99()`` delegate to the repo-wide nearest-rank
    :func:`repro_torch.core.simulator.percentile` over the retained raw samples —
    the pinned convention shared with ``SimResult`` and the cluster
    aggregation layer.
    """

    def __init__(self, bounds: Tuple[float, ...] = _DEFAULT_BUCKETS):
        self.bounds = tuple(bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # +1: the +Inf bucket
        self.count = 0
        self.sum = 0.0
        self.samples: List[float] = []
        self.samples_capped = False

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        i = 0
        for i, le in enumerate(self.bounds):
            if v <= le:
                self.counts[i] += 1
                break
        else:
            self.counts[len(self.bounds)] += 1
        if len(self.samples) < _MAX_SAMPLES:
            self.samples.append(v)
        else:
            self.samples_capped = True

    def pct(self, p: float) -> float:
        return percentile(sorted(self.samples), p)

    def p50(self) -> float:
        return self.pct(50.0)

    def p99(self) -> float:
        return self.pct(99.0)


def _check(name: str, kind: str) -> None:
    actual = METRIC_TYPES.get(name)
    if actual is None:
        raise ValueError(f"unknown metric {name!r} (closed taxonomy)")
    if actual != kind:
        raise ValueError(f"metric {name!r} is a {actual}, used as a {kind}")


class MetricsRegistry:
    """Typed metric store keyed by ``(name, track)`` + rollup snapshots."""

    def __init__(self) -> None:
        self.counters: Dict[Tuple[str, str], float] = {}
        self.gauges: Dict[Tuple[str, str], float] = {}
        self.histograms: Dict[Tuple[str, str], Histogram] = {}
        self.rollups: List[dict] = []

    # -- typed writes -------------------------------------------------------
    def inc(self, name: str, track: str, v: float = 1.0) -> None:
        _check(name, COUNTER)
        if v < 0:
            raise ValueError(f"counter {name!r} cannot decrease (v={v})")
        key = (name, track)
        self.counters[key] = self.counters.get(key, 0.0) + v

    def gauge(self, name: str, track: str, v: float) -> None:
        _check(name, GAUGE)
        self.gauges[(name, track)] = float(v)

    def observe(self, name: str, track: str, v: float) -> None:
        _check(name, HISTOGRAM)
        h = self.histograms.get((name, track))
        if h is None:
            h = self.histograms[(name, track)] = Histogram()
        h.observe(v)

    # -- typed reads (tests / report assembly) ------------------------------
    def counter_value(self, name: str, track: str) -> float:
        return self.counters.get((name, track), 0.0)

    def gauge_value(self, name: str, track: str) -> Optional[float]:
        return self.gauges.get((name, track))

    def histogram(self, name: str, track: str) -> Optional[Histogram]:
        return self.histograms.get((name, track))

    def counter_total(self, name: str) -> float:
        """Sum of one counter over every track (the fleet total)."""
        return sum(
            v for (n, _tr), v in self.counters.items() if n == name
        )

    # -- event-stream feed (called by the hub, before the event cap) --------
    def on_event(
        self, name: str, ph: str, track: str,
        ts_us: float, dur_us: float, args: dict,
    ) -> None:
        if name == "switch":
            if ph == "B":
                self.inc("switches_total", track)
                self.observe(
                    "switch_ctrl_us", track, float(args.get("ctrl_us", 0.0))
                )
        elif name == "fault_service":
            self.inc("faults_total", track, float(args.get("faults", 1)))
            self.inc("fault_stall_us_total", track, dur_us)
            self.observe("fault_stall_us", track, dur_us)
        elif name == "migration_plan":
            self.inc("migration_plans_total", track)
            self.inc("migration_pages_total", track, float(args.get("pages", 0)))
            self.observe("migration_us", track, dur_us)
        elif name == "migration_land":
            self.inc("migration_lands_total", track)
        elif name == "eviction_batch":
            self.inc("evicted_pages_total", track, float(args.get("pages", 0)))
        elif name == "peer_fetch":
            self.inc("peer_fetches_total", track)
            self.inc("peer_fetch_pages_total", track, float(args.get("pages", 0)))
            self.observe("peer_fetch_us", track, dur_us)
        elif name == "checkpoint":
            self.inc("checkpoints_total", track)
            self.observe(
                "checkpoint_bytes", track, float(args.get("nbytes", 0))
            )
        elif name == "admission":
            self.inc("admissions_total", track)
        elif name == "shed":
            self.inc("sheds_total", track)
        elif name == "finish":
            self.inc("finishes_total", track)
        elif name == "recovery":
            self.inc("recoveries_total", track)
        elif name == "rebalance_tick":
            self.inc("rebalance_ticks_total", track)
        elif name == "gpu_fail":
            self.inc("gpu_fails_total", track)
        elif name == "gpu_recover":
            self.inc("gpu_recovers_total", track)
        elif name == "coordinator_crash":
            self.inc("coordinator_crashes_total", track)
        elif name == "coordinator_recover":
            self.inc("coordinator_recovers_total", track)
        elif name == "journal_replay":
            self.inc("journal_replays_total", track)
        elif name == "deadline_miss":
            self.inc("deadline_misses_total", track)
        elif name == "preempt":
            self.inc("preempts_total", track)
        elif name == "cancel":
            self.inc("cancels_total", track)

    def on_counter(self, track: str, name: str, value: float) -> None:
        """Probe-series feed: sampled series whose names are also gauges in
        the taxonomy become last-value gauges (others stay trace-only)."""
        if METRIC_TYPES.get(name) == GAUGE:
            self.gauges[(name, track)] = float(value)

    # -- rollups ------------------------------------------------------------
    def rollup(self, ts_us: float) -> dict:
        """Snapshot every counter and gauge at ``ts_us`` (histograms
        contribute their running count). One row per rebalance tick plus a
        terminal row at finalize — the coarse fleet-health time series."""
        values: Dict[str, float] = {}
        for (name, track), v in sorted(self.counters.items()):
            values[f"{track}/{name}"] = v
        for (name, track), v in sorted(self.gauges.items()):
            values[f"{track}/{name}"] = v
        for (name, track), h in sorted(self.histograms.items()):
            values[f"{track}/{name}_count"] = float(h.count)
        row = {"ts_us": float(ts_us), "values": values}
        self.rollups.append(row)
        return row

    # -- report assembly ----------------------------------------------------
    def report(
        self, generated_us: float = 0.0, audit: Optional[dict] = None
    ) -> "MetricsReport":
        rows: List[dict] = []
        for (name, track), v in sorted(self.counters.items()):
            rows.append(
                {"name": name, "track": track, "kind": COUNTER, "value": v}
            )
        for (name, track), v in sorted(self.gauges.items()):
            rows.append(
                {"name": name, "track": track, "kind": GAUGE, "value": v}
            )
        for (name, track), h in sorted(self.histograms.items()):
            rows.append(
                {
                    "name": name,
                    "track": track,
                    "kind": HISTOGRAM,
                    "count": h.count,
                    "sum": h.sum,
                    "p50": h.p50(),
                    "p99": h.p99(),
                    "samples_capped": h.samples_capped,
                    "buckets": [
                        [le, c] for le, c in zip(h.bounds, h.counts)
                    ] + [["+Inf", h.counts[-1]]],
                }
            )
        return MetricsReport(
            generated_us=float(generated_us),
            metrics=rows,
            rollups=list(self.rollups),
            audit=audit,
        )


@dataclasses.dataclass
class MetricsReport:
    """Versioned metrics artifact (``metrics-report-v1``): the registry's
    full state, the rollup time series, and (when the prediction auditor
    ran) its fleet/per-task/per-template accuracy summary."""

    generated_us: float
    metrics: List[dict]
    rollups: List[dict]
    audit: Optional[dict] = None

    def to_json(self) -> dict:
        return {
            "schema": METRICS_SCHEMA,
            "generated_us": self.generated_us,
            "metrics": self.metrics,
            "rollups": self.rollups,
            "audit": self.audit,
        }

    @classmethod
    def from_json(cls, doc: dict) -> "MetricsReport":
        schema = doc.get("schema")
        if schema not in _ACCEPTED_SCHEMAS:
            raise ValueError(
                f"unknown metrics schema {schema!r} "
                f"(accepted: {', '.join(_ACCEPTED_SCHEMAS)})"
            )
        return cls(
            generated_us=float(doc.get("generated_us", 0.0)),
            metrics=list(doc.get("metrics", [])),
            rollups=list(doc.get("rollups", [])),
            audit=doc.get("audit"),
        )

    def write(self, path) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2)
            f.write("\n")

    # -- Prometheus text exposition format ----------------------------------
    def to_prometheus(self, prefix: str = "msched_") -> str:
        """Render as the Prometheus text format (one scrape body). Counters
        keep their ``_total`` suffix; histograms expand to ``_bucket``
        (cumulative ``le`` counts), ``_sum``, and ``_count`` series."""
        by_name: Dict[str, List[dict]] = {}
        for row in self.metrics:
            by_name.setdefault(row["name"], []).append(row)
        out: List[str] = []
        for name in sorted(by_name):
            rows = by_name[name]
            kind = rows[0]["kind"]
            out.append(f"# TYPE {prefix}{name} {kind}")
            for row in rows:
                label = f'{{track="{row["track"]}"}}'
                if kind == HISTOGRAM:
                    cum = 0
                    for le, c in row["buckets"]:
                        cum += c
                        le_s = le if isinstance(le, str) else f"{le:g}"
                        out.append(
                            f'{prefix}{name}_bucket'
                            f'{{track="{row["track"]}",le="{le_s}"}} {cum}'
                        )
                    out.append(f"{prefix}{name}_sum{label} {row['sum']:g}")
                    out.append(f"{prefix}{name}_count{label} {row['count']}")
                else:
                    out.append(f"{prefix}{name}{label} {row['value']:g}")
        return "\n".join(out) + "\n"
