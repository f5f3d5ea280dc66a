"""Cluster-wide result aggregation: merge per-GPU ``SimResult``s and request
records into one fleet view with cluster p50/p99 metrics.

A migrated request leaves *fragments* on every GPU it touched — an
unfinished record on the source (arrival, maybe admission and first
iteration) and a continuation record on the target (its own arrival =
checkpoint landing, and the completion). :func:`merge_request_records`
stitches fragments back into one request-lifetime record keyed by task id,
so TTFT is measured from the *original* arrival and completion from wherever
the request actually finished. :class:`RequestStats` then condenses any
record list into the serving scoreboard (single sort per metric) — the same
percentile convention as ``SimResult.request_percentile_us`` — and is shared
by ``serving.engine.serve_trace`` (replacing its ad-hoc per-field
aggregation) and the cluster engine.

Copied from the JAX package's ``cluster/aggregate.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence

from repro_torch.core.simulator import (  # noqa: F401  (percentile re-exported)
    RequestRecord,
    SimResult,
    TaskStats,
    percentile,
)


def _merge_fragments(frags: List[RequestRecord]) -> RequestRecord:
    frags = sorted(frags, key=lambda r: r.arrival_us)
    first = frags[0]
    merged = RequestRecord(
        task_id=first.task_id,
        arrival_us=first.arrival_us,
        admitted_us=min(
            (r.admitted_us for r in frags if r.admitted_us is not None),
            default=None,
        ),
        first_iter_us=min(
            (r.first_iter_us for r in frags if r.first_iter_us is not None),
            default=None,
        ),
        finished_us=max(
            (r.finished_us for r in frags if r.finished_us is not None),
            default=None,
        ),
        iterations_done=sum(r.iterations_done for r in frags),
        # the source fragment carries the request's full iteration count;
        # continuations only the remainder
        total_iterations=max(
            (r.total_iterations for r in frags if r.total_iterations is not None),
            default=None,
        ),
        rejected=frags[-1].rejected,
    )
    for r in frags:
        merged.meta.update(r.meta)
    merged.meta["fragments"] = len(frags)
    return merged


def merge_request_records(
    per_gpu: Iterable[Sequence[RequestRecord]],
) -> List[RequestRecord]:
    """Merge per-GPU record lists into per-request records (first-seen
    order). Requests that stayed on one GPU pass through untouched."""
    by_tid: Dict[int, List[RequestRecord]] = {}
    order: List[int] = []
    for records in per_gpu:
        for rec in records:
            if rec.task_id not in by_tid:
                by_tid[rec.task_id] = []
                order.append(rec.task_id)
            by_tid[rec.task_id].append(rec)
    out: List[RequestRecord] = []
    for tid in order:
        frags = by_tid[tid]
        out.append(frags[0] if len(frags) == 1 else _merge_fragments(frags))
    return out


def merge_task_stats(per_gpu: Iterable[Dict[int, TaskStats]]) -> Dict[int, TaskStats]:
    """Sum per-task stats across GPUs (a migrated task contributes partial
    work on every GPU it ran on)."""
    out: Dict[int, TaskStats] = {}
    for stats_map in per_gpu:
        for tid, st in stats_map.items():
            cur = out.get(tid)
            if cur is None:
                out[tid] = TaskStats(
                    st.completions, st.commands, st.busy_us,
                    list(st.latencies_us),
                )
            else:
                cur.completions += st.completions
                cur.commands += st.commands
                cur.busy_us += st.busy_us
                cur.latencies_us.extend(st.latencies_us)
    return out


def merge_sim_results(
    results: Sequence[SimResult],
    records: Optional[List[RequestRecord]] = None,
) -> SimResult:
    """One fleet-level ``SimResult``: wall clock is the slowest GPU, counters
    are summed, and requests are the merged (de-fragmented) records."""
    if records is None:
        records = merge_request_records([r.requests for r in results])
    return SimResult(
        sim_us=max((r.sim_us for r in results), default=0.0),
        per_task=merge_task_stats([r.per_task for r in results]),
        faults=sum(r.faults for r in results),
        migrated_bytes=sum(r.migrated_bytes for r in results),
        switches=sum(r.switches for r in results),
        control_us=sum(r.control_us for r in results),
        requests=records,
        hbm_used_pages=sum(r.hbm_used_pages for r in results),
        hbm_freed_pages=sum(r.hbm_freed_pages for r in results),
    )


def peak_concurrent_bytes(
    footprints: Dict[int, int], records: Sequence[RequestRecord]
) -> float:
    """Peak concurrently-admitted footprint: sweep admit/finish edges.
    The oversubscription a run *actually* hit, for reporting."""
    edges: List[tuple] = []
    for rec in records:
        if rec.admitted_us is None:
            continue
        nbytes = footprints.get(rec.task_id, 0)
        edges.append((rec.admitted_us, 1, nbytes))
        if rec.finished_us is not None:
            edges.append((rec.finished_us, -1, nbytes))
    cur = peak = 0.0
    for _, sign, nbytes in sorted(edges):
        cur += sign * nbytes
        peak = max(peak, cur)
    return peak


@dataclasses.dataclass
class RequestStats:
    """Serving scoreboard over a record list (cluster-wide when the records
    are merged per-GPU fragments)."""

    n_requests: int
    n_finished: int
    n_rejected: int
    ttft_p50_us: float
    ttft_p99_us: float
    tpot_p50_us: float
    tpot_p99_us: float
    latency_p50_us: float
    latency_p99_us: float
    goodput_per_s: float
    throughput_per_s: float

    @classmethod
    def from_records(
        cls,
        records: Sequence[RequestRecord],
        ttft_slo_us: Optional[float],
        tpot_slo_us: Optional[float],
        window_us: float,
    ) -> "RequestStats":
        """``window_us`` is the offered-load window shared by every run
        replaying the same trace (see ``serve_trace``); goodput and
        throughput are normalized by it."""
        ttft = sorted(v for r in records if (v := r.ttft_us()) is not None)
        tpot = sorted(v for r in records if (v := r.tpot_us()) is not None)
        lat = sorted(v for r in records if (v := r.latency_us()) is not None)
        finished = sum(1 for r in records if r.finished_us is not None)
        good = sum(1 for r in records if r.meets_slo(ttft_slo_us, tpot_slo_us))
        window_s = max(window_us, 1.0) * 1e-6
        return cls(
            n_requests=len(records),
            n_finished=finished,
            n_rejected=sum(1 for r in records if r.rejected),
            ttft_p50_us=percentile(ttft, 50.0),
            ttft_p99_us=percentile(ttft, 99.0),
            tpot_p50_us=percentile(tpot, 50.0),
            tpot_p99_us=percentile(tpot, 99.0),
            latency_p50_us=percentile(lat, 50.0),
            latency_p99_us=percentile(lat, 99.0),
            goodput_per_s=good / window_s,
            throughput_per_s=finished / window_s,
        )
