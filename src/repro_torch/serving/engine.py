"""Trace-driven serving engine: replay a request trace through the dynamic
simulator and report SLO metrics.

``serve_trace`` is the one-call entry point: it turns each trace request into
a :class:`ServedRequestTask` arrival event, runs the dynamic simulator under
the chosen memory backend and admission controller, and condenses the
per-request lifecycle records into serving metrics:

  * **TTFT** — arrival → end of prefill + first decode step (queueing and
    admission delay included);
  * **TPOT** — decode-phase time per output token;
  * **p99 latency** — arrival → EOS, tail;
  * **goodput** — completed requests/s that met both the TTFT and TPOT SLOs.

Copied from the JAX package's ``serving/engine.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.cluster.aggregate import RequestStats, peak_concurrent_bytes
from repro_torch.core.hardware import Platform
from repro_torch.core.scheduler import Policy, RoundRobinPolicy
from repro_torch.core.simulator import (
    AdmissionController,
    SimResult,
    TaskArrival,
    simulate,
)
from repro_torch.serving.admission import AlwaysAdmit, MSchedAdmission
from repro_torch.serving.lifecycle import ServedRequestTask
from repro_torch.serving.traces import Request, Trace


@dataclasses.dataclass
class SLOSpec:
    """Latency targets a request must meet to count toward goodput."""

    ttft_us: float = 3_000_000.0  # 3 s to first token
    tpot_us: float = 100_000.0  # 100 ms per output token


@dataclasses.dataclass
class ServeReport:
    backend: str
    capacity_bytes: int
    oversubscription: float  # peak admitted-demand bytes / HBM capacity
    slo: SLOSpec
    offered_rps: float
    n_requests: int
    n_finished: int
    n_rejected: int
    ttft_p50_us: float
    ttft_p99_us: float
    tpot_p50_us: float
    tpot_p99_us: float
    latency_p99_us: float
    # goodput/throughput are per second of *offered-load window* (the trace
    # duration), a denominator shared by every backend replaying the trace
    goodput_per_s: float
    throughput_per_s: float  # finished requests/s, SLO-blind
    faults: int
    migrated_bytes: int
    result: SimResult

    def to_row(self) -> Dict[str, object]:
        # shallow field filter: asdict() would deep-copy the whole SimResult
        # (every RequestRecord and latency list) just to be discarded
        row = {
            f.name: getattr(self, f.name)
            for f in dataclasses.fields(self)
            if f.name not in ("result", "slo")
        }
        row["ttft_slo_us"] = self.slo.ttft_us
        row["tpot_slo_us"] = self.slo.tpot_us
        return row


def build_events(
    trace: Trace,
    page_size: int = 1 << 20,
    bytes_per_weight: float = 1.0,
) -> List[TaskArrival]:
    """One finite task per request; task ids are the (unique) request ids."""
    return [
        TaskArrival(
            req.arrival_us,
            ServedRequestTask(
                req.req_id, req, page_size=page_size,
                bytes_per_weight=bytes_per_weight,
            ),
            meta={"tenant": req.tenant, "prompt": req.prompt_tokens,
                  "output": req.output_tokens, "slo_class": req.slo_class},
        )
        for req in trace
    ]


def representative_requests(trace: Trace, page_size: int = 1 << 20) -> List[ServedRequestTask]:
    """One synthetic program per tenant, used only for offline template
    profiling (the real MSched flow profiles each application once)."""
    seen: Dict[str, Request] = {}
    for req in trace:
        seen.setdefault(req.tenant, req)
    return [
        ServedRequestTask(10_000_000 + i, req, page_size=page_size)
        for i, req in enumerate(seen.values())
    ]


def serve_trace(
    trace: Trace,
    platform: Platform,
    backend: str = "msched",
    capacity_bytes: Optional[int] = None,
    admission: Optional[AdmissionController] = None,
    policy: Optional[Policy] = None,
    page_size: int = 1 << 20,
    predictor_kind: str = "template",
    slo: Optional[SLOSpec] = None,
    sim_us: Optional[float] = None,
    drain_factor: float = 8.0,
    pool: str = "run",
    telemetry=None,
) -> ServeReport:
    """Replay ``trace`` and measure serving quality.

    ``sim_us`` defaults to ``drain_factor`` × the trace duration so admitted
    requests get a chance to drain; requests still unfinished at the horizon
    count against goodput (they missed every SLO). ``pool`` selects the HBM
    residency implementation (``"run"`` default; ``"paged"`` is the per-page
    equivalence reference — long traces are intractable on it).
    """
    slo = slo or SLOSpec()
    events = build_events(trace, page_size=page_size)
    # capture before the run: retirement releases the address spaces
    footprints = {
        ev.program.task_id: ev.program.footprint_bytes() for ev in events
    }
    cap = capacity_bytes or platform.hbm_bytes
    horizon = sim_us or max(1.0, trace.duration_us()) * drain_factor
    res = simulate(
        [],
        platform,
        backend,
        capacity_bytes=cap,
        sim_us=horizon,
        policy=policy or RoundRobinPolicy(),
        predictor_kind=predictor_kind,
        task_events=events,
        admission=admission,
        profile_set=representative_requests(trace, page_size=page_size),
        page_size=page_size,
        prepopulate=False,
        pool=pool,
        telemetry=telemetry,
    )
    # peak concurrent admitted footprint = the oversubscription actually hit
    peak_bytes = peak_concurrent_bytes(footprints, res.requests)
    # metrics are normalized by the *offered-load window* (identical across
    # backends replaying the same trace), not each run's own makespan —
    # otherwise a slow-draining baseline deflates its own denominator; the
    # scoreboard itself comes from the shared cluster aggregation helpers
    window_us = max(trace.duration_us(), 1.0)
    stats = RequestStats.from_records(
        res.requests, slo.ttft_us, slo.tpot_us, window_us
    )
    return ServeReport(
        backend=backend,
        capacity_bytes=cap,
        oversubscription=peak_bytes / cap if cap else 0.0,
        slo=slo,
        offered_rps=trace.offered_rate_rps(),
        n_requests=stats.n_requests,
        n_finished=stats.n_finished,
        n_rejected=stats.n_rejected,
        ttft_p50_us=stats.ttft_p50_us,
        ttft_p99_us=stats.ttft_p99_us,
        tpot_p50_us=stats.tpot_p50_us,
        tpot_p99_us=stats.tpot_p99_us,
        latency_p99_us=stats.latency_p99_us,
        goodput_per_s=stats.goodput_per_s,
        throughput_per_s=stats.throughput_per_s,
        faults=res.faults,
        migrated_bytes=res.migrated_bytes,
        result=res,
    )
