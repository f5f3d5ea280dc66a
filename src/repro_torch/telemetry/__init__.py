"""Fleet-wide observability: structured event tracing, sampled time-series
probes, and causally-attributed stall accounting.

The subsystem is zero-overhead when off: every hook in the simulator and
cluster layers is nullable (``telemetry=None`` — the default — emits
nothing and constructs nothing), so untraced runs are bit-for-bit identical
to a tree without this package. See ``docs/observability.md`` for the event
schema, the attribution taxonomy, and the Perfetto walkthrough.

  * :class:`~repro_torch.telemetry.hub.Telemetry` — the hub cores/cluster emit
    into; owns events, counter series, and the stall ledger;
  * :class:`~repro_torch.telemetry.hub.StallLedger` — classifies every µs of
    per-task non-compute wall time into {fault-service, migration-wait,
    queue-wait, link-contention, recovery, scheduler-control}, with exact
    conservation asserted;
  * :mod:`~repro_torch.telemetry.export` — Chrome trace_event JSON (Perfetto /
    ``chrome://tracing``) and JSONL exporters, plus the validator behind
    ``scripts/trace_report.py --validate``;
  * :mod:`~repro_torch.telemetry.metrics` — the typed metrics registry (counters /
    gauges / fixed-bucket histograms keyed by ``(name, track)``, closed
    taxonomy) and the versioned ``metrics-report-v1`` artifact with
    Prometheus + JSON exporters (``Telemetry(metrics=True)``);
  * :mod:`~repro_torch.telemetry.audit` — the online prediction auditor scoring
    the paper's Table 1 accuracy claim live at every extended context
    switch and fault-service boundary (``Telemetry(audit=True)``).

Copied from the JAX package's ``telemetry/__init__.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from repro_torch.telemetry.audit import PredictionAuditor  # noqa: F401
from repro_torch.telemetry.export import (  # noqa: F401
    SCHEMA,
    chrome_trace,
    validate_trace,
    write_chrome,
    write_jsonl,
)
from repro_torch.telemetry.metrics import (  # noqa: F401
    METRIC_TYPES,
    METRICS_SCHEMA,
    Histogram,
    MetricsRegistry,
    MetricsReport,
)
from repro_torch.telemetry.hub import (  # noqa: F401
    EVENT_TYPES,
    STALL_CATEGORIES,
    TRACK_CLUSTER,
    LedgerConservationError,
    StallLedger,
    Telemetry,
    TelemetryEvent,
)
