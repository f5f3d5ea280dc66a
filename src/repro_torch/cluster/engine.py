"""Cluster serving engine: N per-GPU simulation cores under one event loop.

``simulate_cluster`` replays a request trace against a
:class:`~repro_torch.cluster.topology.ClusterTopology`: every GPU is one
re-entrant :class:`~repro_torch.core.simulator.SimCore` (its own HBM pool, memory
backend, scheduler, and admission controller), and the cluster loop owns the
global event stream — trace arrivals, dispatched to a GPU by the placement
policy the moment they arrive, and periodic rebalance ticks that migrate
work off pressured devices through the link graph.

The loop is a conservative discrete-event composition: between two global
events no interaction between GPUs is possible (tasks only meet at
placement/rebalance decisions), so each core safely advances to the next
event time on its own (``run(T, final=False)``), and the per-GPU results are
exact. With a single GPU the composition degenerates to exactly
``simulate()`` — bit-for-bit, for all four memory backends (pinned in
tests/cluster/test_cluster_engine.py).

``repro_torch.serving`` is imported lazily: serving builds its per-run scoreboard
on :mod:`repro_torch.cluster.aggregate`, and the module-level import edge must
point only that way.

Copied from the JAX package's ``cluster/engine.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Dict, List, Optional, Sequence

from repro_torch.core.invariants import InvariantAuditor
from repro_torch.core.scheduler import Policy, RoundRobinPolicy
from repro_torch.core.simulator import AdmissionController, SimCore, SimResult
from repro_torch.cluster.aggregate import (
    RequestStats,
    merge_request_records,
    merge_sim_results,
    peak_concurrent_bytes,
)
from repro_torch.cluster.faults import (
    CheckpointVault,
    FaultInjector,
    FaultRuntime,
    RecoveryEvent,
)
from repro_torch.cluster.migration import MigrationEvent, Rebalancer
from repro_torch.cluster.placement import MSchedPlacement, PlacementPolicy, make_placement
from repro_torch.cluster.prefetch import PeerFetchEvent, PeerPrefetchFabric
from repro_torch.cluster.topology import HOST, ClusterTopology
from repro_torch.cluster.transfer_plan import TransferPlanner
from repro_torch.telemetry.hub import TRACK_CLUSTER

# version tag for ClusterReport.to_json artifacts (benchmarks/common.py).
# v2 added the control-plane fields (journal length, replays, coordinator
# crashes, deadline misses, preemptions, deadline sheds); v1 artifacts are
# still readable — the new fields default to zero.
REPORT_SCHEMA = "cluster-report-v2"
_ACCEPTED_SCHEMAS = ("cluster-report-v1", REPORT_SCHEMA)


def _result_to_json(res: SimResult) -> Dict[str, object]:
    return {
        "sim_us": res.sim_us,
        "per_task": {
            str(tid): dataclasses.asdict(st)
            for tid, st in res.per_task.items()
        },
        "faults": res.faults,
        "migrated_bytes": res.migrated_bytes,
        "switches": res.switches,
        "control_us": res.control_us,
        "requests": [dataclasses.asdict(r) for r in res.requests],
        "hbm_used_pages": res.hbm_used_pages,
        "hbm_freed_pages": res.hbm_freed_pages,
    }


def _result_from_json(doc: Dict[str, object]) -> SimResult:
    from repro_torch.core.simulator import RequestRecord, TaskStats

    return SimResult(
        sim_us=doc["sim_us"],
        per_task={
            int(tid): TaskStats(**st) for tid, st in doc["per_task"].items()
        },
        faults=doc["faults"],
        migrated_bytes=doc["migrated_bytes"],
        switches=doc["switches"],
        control_us=doc["control_us"],
        requests=[RequestRecord(**r) for r in doc["requests"]],
        hbm_used_pages=doc["hbm_used_pages"],
        hbm_freed_pages=doc["hbm_freed_pages"],
    )


@dataclasses.dataclass
class GPUReport:
    """Per-device slice of a cluster run: how many arrivals placement
    dispatched here and the GPU's own ``SimResult`` (a migrated request
    contributes partial work to every GPU it visited)."""

    name: str
    platform: str
    capacity_bytes: int
    placed: int  # arrivals dispatched here (migrations land on top)
    result: SimResult

    def to_row(self) -> Dict[str, object]:
        return {
            "name": self.name,
            "platform": self.platform,
            "capacity_bytes": self.capacity_bytes,
            "placed": self.placed,
            "finished": len(self.result.finished_requests()),
            "faults": self.result.faults,
            "migrated_bytes": self.result.migrated_bytes,
            "switches": self.result.switches,
        }


@dataclasses.dataclass
class ClusterReport:
    """Fleet-level result of one ``simulate_cluster`` run: the cluster-wide
    serving scoreboard (``stats``, over de-fragmented request records), the
    merged ``SimResult``, per-GPU reports, the migration log, and — on
    NVLink fleets — the peer-prefetch accounting (fetch events, bytes moved
    GPU-to-GPU, and host-fallback pages lost to source-side eviction)."""

    backend: str
    placement: str
    n_gpus: int
    total_capacity_bytes: int
    oversubscription: float  # peak admitted demand / total capacity
    offered_rps: float
    slo: object  # SLOSpec
    stats: RequestStats  # cluster-wide, over merged records
    merged: SimResult
    per_gpu: List[GPUReport]
    migrations: List[MigrationEvent]
    deferred_migrations: int
    # NVLink peer-prefetch accounting (zero/empty on peer-less fleets)
    peer_fetches: List[PeerFetchEvent] = dataclasses.field(default_factory=list)
    peer_fetch_bytes: int = 0
    peer_fallback_pages: int = 0  # lingered pages lost to source eviction
    linger_reclaimed_pages: int = 0
    # of which: reclaimed by the finish hook at task retirement (instead of
    # leaking until the next rebalance tick)
    linger_finish_reaped: int = 0
    # fault-injection accounting (zero/empty on fault-free runs)
    faults_applied: int = 0
    recoveries: List[RecoveryEvent] = dataclasses.field(default_factory=list)
    shed_requests: int = 0  # graceful-degradation sheds
    lost_requests: int = 0  # no alive GPU ever came back for these
    retry_exhausted: int = 0  # continuations whose retry budget ran out
    checkpoints: int = 0
    checkpoint_bytes: int = 0
    # control-plane accounting (zero on runs without a ControlPlane; the
    # fields are unconditional so zero-fault rows compare equal with and
    # without one attached)
    journal_len: int = 0  # decision-journal records appended
    journal_replays: int = 0  # journal replays at coordinator recovery
    coordinator_crashes: int = 0
    deadline_misses: int = 0  # RT requests that missed TTFT/completion SLO
    preemptions: int = 0  # BE tasks preempted by deadline enforcement
    deadline_sheds: int = 0  # BE tasks shed after the escalation ladder
    # transfer-planner accounting (zero in transfer_plan="greedy" mode; the
    # fields stay in schema v2 — from_json defaults them for old artifacts)
    planned_transfers: int = 0  # flights admitted by the TransferPlanner
    planner_replans: int = 0  # committed plans rebooked by later admissions
    planner_deferred: int = 0  # speculative moves deferred by urgency

    def to_row(self) -> Dict[str, object]:
        """Flatten for JSON artifacts (benchmarks)."""
        row: Dict[str, object] = {
            "backend": self.backend,
            "placement": self.placement,
            "n_gpus": self.n_gpus,
            "total_capacity_bytes": self.total_capacity_bytes,
            "oversubscription": self.oversubscription,
            "offered_rps": self.offered_rps,
            "ttft_slo_us": self.slo.ttft_us,
            "tpot_slo_us": self.slo.tpot_us,
            "migrations": len(self.migrations),
            "migrated_requests": len(
                {m.task_id for m in self.migrations}
            ),
            "deferred_migrations": self.deferred_migrations,
            "peer_fetches": len(self.peer_fetches),
            "peer_fetch_bytes": self.peer_fetch_bytes,
            "peer_fallback_pages": self.peer_fallback_pages,
            "linger_finish_reaped": self.linger_finish_reaped,
            "faults_applied": self.faults_applied,
            "recoveries": len(self.recoveries),
            "recoveries_by_kind": {
                k: sum(1 for r in self.recoveries if r.kind == k)
                for k in ("checkpoint", "linger", "cold", "requeue")
            },
            "replayed_iters": sum(r.replayed_iters for r in self.recoveries),
            "shed_requests": self.shed_requests,
            "lost_requests": self.lost_requests,
            "retry_exhausted": self.retry_exhausted,
            "checkpoints": self.checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "journal_len": self.journal_len,
            "journal_replays": self.journal_replays,
            "coordinator_crashes": self.coordinator_crashes,
            "deadline_misses": self.deadline_misses,
            "preemptions": self.preemptions,
            "deadline_sheds": self.deadline_sheds,
            "planned_transfers": self.planned_transfers,
            "planner_replans": self.planner_replans,
            "planner_deferred": self.planner_deferred,
            "per_gpu": [g.to_row() for g in self.per_gpu],
        }
        row.update(dataclasses.asdict(self.stats))
        return row

    # -- JSON artifact round-trip -------------------------------------------
    def to_json(self) -> Dict[str, object]:
        """Full-fidelity JSON-serializable form (benchmark artifacts).
        Everything :meth:`from_json` needs to reconstruct an equivalent
        report — nested results, request records, and event logs included —
        so artifact writers stop hand-rolling field extraction."""
        return {
            "schema": REPORT_SCHEMA,
            "backend": self.backend,
            "placement": self.placement,
            "n_gpus": self.n_gpus,
            "total_capacity_bytes": self.total_capacity_bytes,
            "oversubscription": self.oversubscription,
            "offered_rps": self.offered_rps,
            "slo": {"ttft_us": self.slo.ttft_us, "tpot_us": self.slo.tpot_us},
            "stats": dataclasses.asdict(self.stats),
            "merged": _result_to_json(self.merged),
            "per_gpu": [
                {
                    "name": g.name,
                    "platform": g.platform,
                    "capacity_bytes": g.capacity_bytes,
                    "placed": g.placed,
                    "result": _result_to_json(g.result),
                }
                for g in self.per_gpu
            ],
            "migrations": [dataclasses.asdict(m) for m in self.migrations],
            "deferred_migrations": self.deferred_migrations,
            "peer_fetches": [
                dataclasses.asdict(f) for f in self.peer_fetches
            ],
            "peer_fetch_bytes": self.peer_fetch_bytes,
            "peer_fallback_pages": self.peer_fallback_pages,
            "linger_reclaimed_pages": self.linger_reclaimed_pages,
            "linger_finish_reaped": self.linger_finish_reaped,
            "faults_applied": self.faults_applied,
            "recoveries": [dataclasses.asdict(r) for r in self.recoveries],
            "shed_requests": self.shed_requests,
            "lost_requests": self.lost_requests,
            "retry_exhausted": self.retry_exhausted,
            "checkpoints": self.checkpoints,
            "checkpoint_bytes": self.checkpoint_bytes,
            "journal_len": self.journal_len,
            "journal_replays": self.journal_replays,
            "coordinator_crashes": self.coordinator_crashes,
            "deadline_misses": self.deadline_misses,
            "preemptions": self.preemptions,
            "deadline_sheds": self.deadline_sheds,
            "planned_transfers": self.planned_transfers,
            "planner_replans": self.planner_replans,
            "planner_deferred": self.planner_deferred,
        }

    @classmethod
    def from_json(cls, doc: Dict[str, object]) -> "ClusterReport":
        from repro_torch.serving.engine import SLOSpec  # lazy: import edge

        schema = doc.get("schema")
        if schema not in _ACCEPTED_SCHEMAS:
            raise ValueError(
                f"unknown cluster-report schema {schema!r} "
                f"(expected one of {_ACCEPTED_SCHEMAS})"
            )
        return cls(
            backend=doc["backend"],
            placement=doc["placement"],
            n_gpus=doc["n_gpus"],
            total_capacity_bytes=doc["total_capacity_bytes"],
            oversubscription=doc["oversubscription"],
            offered_rps=doc["offered_rps"],
            slo=SLOSpec(**doc["slo"]),
            stats=RequestStats(**doc["stats"]),
            merged=_result_from_json(doc["merged"]),
            per_gpu=[
                GPUReport(
                    name=g["name"],
                    platform=g["platform"],
                    capacity_bytes=g["capacity_bytes"],
                    placed=g["placed"],
                    result=_result_from_json(g["result"]),
                )
                for g in doc["per_gpu"]
            ],
            migrations=[MigrationEvent(**m) for m in doc["migrations"]],
            deferred_migrations=doc["deferred_migrations"],
            peer_fetches=[PeerFetchEvent(**f) for f in doc["peer_fetches"]],
            peer_fetch_bytes=doc["peer_fetch_bytes"],
            peer_fallback_pages=doc["peer_fallback_pages"],
            linger_reclaimed_pages=doc["linger_reclaimed_pages"],
            linger_finish_reaped=doc["linger_finish_reaped"],
            faults_applied=doc["faults_applied"],
            recoveries=[
                RecoveryEvent(**r) for r in doc["recoveries"]
            ],
            shed_requests=doc["shed_requests"],
            lost_requests=doc["lost_requests"],
            retry_exhausted=doc["retry_exhausted"],
            checkpoints=doc["checkpoints"],
            checkpoint_bytes=doc["checkpoint_bytes"],
            # v2 fields: absent from v1 artifacts, default 0
            journal_len=doc.get("journal_len", 0),
            journal_replays=doc.get("journal_replays", 0),
            coordinator_crashes=doc.get("coordinator_crashes", 0),
            deadline_misses=doc.get("deadline_misses", 0),
            preemptions=doc.get("preemptions", 0),
            deadline_sheds=doc.get("deadline_sheds", 0),
            planned_transfers=doc.get("planned_transfers", 0),
            planner_replans=doc.get("planner_replans", 0),
            planner_deferred=doc.get("planner_deferred", 0),
        )


def simulate_cluster(
    trace,
    topology: ClusterTopology,
    backend: str = "msched",
    placement: "PlacementPolicy | str" = "msched",
    admission_factory: Optional[Callable[[int], AdmissionController]] = None,
    policy_factory: Optional[Callable[[int], Policy]] = None,
    page_size: int = 1 << 20,
    predictor_kind: str = "template",
    slo=None,
    sim_us: Optional[float] = None,
    drain_factor: float = 8.0,
    rebalance_period_us: Optional[float] = None,
    rebalance_threshold: float = 0.5,
    max_moves_per_tick: int = 1,
    stage_dir: Optional[str] = None,
    pool: str = "run",
    peer_prefetch: str = "auto",
    faults: Optional[FaultInjector] = None,
    recovery: str = "auto",
    checkpoint_period_us: Optional[float] = None,
    audit: bool = False,
    shed_threshold: Optional[float] = 1.25,
    shed_rt_threshold: Optional[float] = None,
    retry_backoff_us: float = 0.0,
    control=None,
    telemetry=None,
    transfer_plan: str = "greedy",
) -> ClusterReport:
    """Replay ``trace`` across the cluster and report fleet-level serving
    quality.

    ``admission_factory`` / ``policy_factory`` build one controller/policy
    *per GPU* (they are stateful); index ``i`` is the GPU's position in the
    topology. ``rebalance_period_us`` enables inter-GPU migration at that
    cadence; ``stage_dir`` routes each checkpointed move through the sharded
    checkpoint format on disk. Other knobs mirror ``serve_trace``.

    ``peer_prefetch`` controls the NVLink peer-to-peer working-set machinery
    (page-location directory, lazy p2p migration, peer-sourced extended
    context switches, cluster-wide OPT eviction): ``"auto"`` enables it
    exactly when the topology has NVLink edges and the backend is
    ``msched``; ``"off"`` forces the plain composition (bulk transfers even
    over NVLink edges). Peer-less topologies and 1-GPU clusters behave
    identically under both settings — the machinery is never constructed.

    ``faults`` injects a :class:`~repro_torch.cluster.faults.FaultInjector`
    schedule (GPU failures, link flaps, task crashes) as first-class
    events; ``recovery`` picks the re-placement policy (``"auto"`` prefers
    landed checkpoints, then linger copies, then cold restart; ``"cold"``
    / ``"linger"`` / ``"checkpoint"`` pin a single source for ablations)
    and ``checkpoint_period_us`` enables the periodic
    :class:`~repro_torch.cluster.faults.CheckpointVault` D2H snapshots that feed
    it. ``shed_threshold`` / ``shed_rt_threshold`` bound graceful
    degradation when failures shrink capacity. An empty or absent
    ``faults`` constructs none of this machinery — fault-free runs are
    bit-for-bit identical to the plain composition. ``audit=True`` runs
    the read-only :class:`~repro_torch.core.invariants.InvariantAuditor` at
    every failure boundary and rebalance tick (raises on violation).
    ``retry_backoff_us`` layers capped exponential delay onto the
    migration retry protocol (0 keeps retries instant).

    ``control`` attaches a :class:`repro_torch.control.ControlPlane` (fresh per
    run): it journals every scheduler decision write-ahead, tracks task
    lifecycle, serves the ``submit``/``cancel``/``status`` API, survives
    ``coordinator_crash``/``coordinator_recover`` fault events (journal
    replay or cold restart, per its ``recovery`` mode), and — when built
    with deadlines — enforces RT SLOs by preempting best-effort work.
    Schedules containing coordinator events *require* it. On a zero-fault
    run with no deadline enforcement the control plane is a pure observer:
    results are bit-for-bit identical to ``control=None``.

    ``telemetry`` attaches one :class:`repro_torch.telemetry.Telemetry` hub to
    the whole fleet: every core, the rebalancer, the prefetch fabric, and
    the fault runtime emit into it, rebalance ticks sample the cluster
    probes (per-GPU occupancy, per-link in-flight bytes and sharers, host
    staging), and the stall ledger is resolved against the merged result
    before returning. ``None`` (the default) emits nothing and takes
    exactly the untraced code paths.

    ``transfer_plan`` selects the bulk-transfer pricing model.
    ``"greedy"`` (the default) prices every movement independently at
    request time with the fluid-at-start share — the historical
    behaviour, preserved bit-for-bit (the planner object is never
    constructed). ``"auto"`` attaches a
    :class:`~repro_torch.cluster.transfer_plan.TransferPlanner` to multi-GPU
    topologies: rebalance windows batch their checkpoint/p2p movements
    into one routed, urgency-ordered schedule, landing estimates are
    re-solved as sharers drain (pending arrivals are retimed in place),
    saturated host links detour over idle NVLink paths, and speculative
    moves whose projected landing exceeds ``defer_stretch`` x their solo
    time are deferred to the next tick.
    """
    # lazy: serving depends on cluster.aggregate at module level; the
    # reverse edge must not exist at import time
    from repro_torch.serving.engine import SLOSpec, build_events, representative_requests

    slo = slo or SLOSpec()
    if (
        control is None
        and faults is not None
        and any(
            ev.kind in ("coordinator_crash", "coordinator_recover")
            for ev in faults.events
        )
    ):
        raise ValueError(
            "coordinator_crash/coordinator_recover fault events require a "
            "control plane: pass control=ControlPlane(...)"
        )
    events = build_events(trace, page_size=page_size)
    footprints = {
        ev.program.task_id: ev.program.footprint_bytes() for ev in events
    }
    reps = representative_requests(trace, page_size=page_size)
    placement = make_placement(placement)
    cores = [
        SimCore(
            [],
            node.platform,
            backend,
            capacity_bytes=node.hbm_bytes,
            policy=policy_factory(i) if policy_factory else RoundRobinPolicy(),
            predictor_kind=predictor_kind,
            admission=admission_factory(i) if admission_factory else None,
            profile_set=reps,
            page_size=page_size,
            prepopulate=False,
            pool=pool,
            dynamic=True,
            name=node.name,
            telemetry=telemetry,
        )
        for i, node in enumerate(topology.gpus)
    ]
    horizon = sim_us or max(1.0, trace.duration_us()) * drain_factor
    # contention state is per-run: a reused topology must not price this
    # run's transfers against a previous run's in-flight migrations
    topology.reset_transfers()
    # NVLink fleets get the peer-prefetch fabric: page-location directory,
    # peer-sourced extended context switches, cluster-wide OPT eviction.
    # Peer-less fleets never construct it — their composition is untouched.
    if peer_prefetch not in ("auto", "off"):
        raise ValueError(
            f"peer_prefetch must be 'auto' or 'off', got {peer_prefetch!r}"
        )
    if transfer_plan not in ("auto", "greedy"):
        raise ValueError(
            f"transfer_plan must be 'auto' or 'greedy', got {transfer_plan!r}"
        )
    fabric = None
    wired_placement = False
    prev_placement_topo = None
    if (
        peer_prefetch != "off"
        and backend == "msched"
        and topology.has_nvlink()
    ):
        fabric = PeerPrefetchFabric(topology, cores)
        fabric.wire()
        if isinstance(placement, MSchedPlacement):
            # fluid-share-aware landing ties for *this* run's topology;
            # restored afterwards so a reused instance never consults a
            # previous run's contention state
            prev_placement_topo = placement.topology
            placement.topology = topology
            wired_placement = True
    rebalancer = (
        Rebalancer(
            topology,
            threshold=rebalance_threshold,
            max_moves=max_moves_per_tick,
            stage_dir=stage_dir,
            prefetch=fabric,
            retry_backoff_us=retry_backoff_us,
        )
        if rebalance_period_us
        else None
    )
    if rebalancer is not None:
        # the retry protocol needs the fleet even before the first tick
        rebalancer.attach(cores)
    placed = [0] * len(cores)

    # fault machinery: constructed only for a non-empty schedule, so
    # fault-free runs (faults=None or FaultInjector.none()) take exactly
    # the plain code path — the structural bit-for-bit guarantee
    fault_rt = None
    vault = None
    if faults is not None and not faults.empty:
        if checkpoint_period_us:
            vault = CheckpointVault(topology, page_size, stage_dir=stage_dir)
        fault_rt = FaultRuntime(
            faults,
            topology,
            cores,
            placement,
            fabric=fabric,
            vault=vault,
            recovery=recovery,
            shed_threshold=shed_threshold,
            shed_rt_threshold=shed_rt_threshold,
        )
    auditor = (
        InvariantAuditor(
            cores,
            topology=topology,
            fabric=fabric,
            vault=vault,
            control=control,
        )
        if audit
        else None
    )
    if telemetry is not None:
        # pure observers: components check `telemetry is not None` at each
        # emission site, so the None path is structurally unchanged
        for component in (fabric, rebalancer, fault_rt, vault):
            if component is not None:
                component.telemetry = telemetry
    if control is not None:
        control.attach(
            cores,
            topology=topology,
            placement=placement,
            fabric=fabric,
            rebalancer=rebalancer,
            vault=vault,
            fault_rt=fault_rt,
            telemetry=telemetry,
        )

    # scheduled transfer planning: "greedy" (the default) never constructs
    # the planner — every movement keeps the historical per-request fluid
    # pricing bit-for-bit. "auto" attaches the window planner to multi-GPU
    # fleets; 1-GPU topologies have no inter-GPU movement to schedule.
    planner = None
    if transfer_plan == "auto" and len(topology) > 1:
        planner = TransferPlanner(topology, telemetry=telemetry)
        topology.planner = planner
        if fabric is not None:
            fabric.planner = planner
        core_by_name = {c.name: c for c in cores}

        def _retime_arrival(plan, old_arrival):
            # a sharer drained (or a cancel freed a leg): the planner moved
            # this flight's landing, so the pending arrival injected at the
            # stale estimate must move with it. Only bulk moves that inject
            # a TaskArrival exactly at plan.arrival_us are retimed —
            # snapshots land on HOST and redispatches offset the arrival,
            # so both fail the match and are safely skipped.
            if plan.kind not in ("checkpoint", "p2p", "restore"):
                return
            if plan.dst == HOST or plan.task_id is None:
                return
            core = core_by_name.get(plan.dst)
            if core is None:
                return
            moved = False
            for ev in core.pending:
                if (
                    ev.program.task_id == plan.task_id
                    and abs(ev.time_us - old_arrival) < 1e-6
                ):
                    ev.time_us = plan.arrival_us
                    moved = True
            if moved:
                core.pending = deque(
                    sorted(core.pending, key=lambda e: e.time_us)
                )
            if fabric is not None and plan.kind == "p2p":
                entry = fabric.directory.get(plan.task_id)
                if (
                    entry is not None
                    and abs(entry.arrival_us - old_arrival) < 1e-6
                ):
                    entry.arrival_us = plan.arrival_us

        topology.replan_hook = _retime_arrival

    # -- the cluster event loop --------------------------------------------
    try:
        ev_i = 0
        next_tick = rebalance_period_us if rebalancer else float("inf")
        next_ck = (
            checkpoint_period_us
            if fault_rt is not None and checkpoint_period_us
            else float("inf")
        )
        while True:
            t_ev = events[ev_i].time_us if ev_i < len(events) else float("inf")
            t_tick = next_tick if next_tick <= horizon else float("inf")
            t_fault = fault_rt.next_time() if fault_rt else float("inf")
            t_ck = next_ck if next_ck <= horizon else float("inf")
            t_ctl = control.next_time() if control is not None else float("inf")
            t_ctl = t_ctl if t_ctl <= horizon else float("inf")
            T = min(t_ev, t_tick, t_fault, t_ck, t_ctl)
            if T == float("inf"):
                break
            for core in cores:
                core.run(T, final=False)
            if t_fault <= T:
                # failures first: a fault and an arrival at the same
                # instant must not dispatch the arrival to the dying GPU
                fault_rt.apply_due(T)
                if auditor is not None:
                    auditor.check(T, "fault")
            elif t_ck <= T:
                # snapshotting is a coordinator decision: skipped while the
                # control plane is down (the cadence keeps advancing)
                if control is None or not control.down:
                    vault.snapshot(cores, T)
                    vault.prune(cores, fault_rt.live_extra())
                next_ck += checkpoint_period_us
            elif t_ctl <= T:
                # scheduled submit/cancel ops and deadline enforcement;
                # next_time() is inf while the coordinator is down and when
                # nothing is scheduled, so runs without ops or deadline
                # monitoring never reach this branch
                control.tick(T)
            elif t_ev <= t_tick:
                ev = events[ev_i]
                ev_i += 1
                if control is not None:
                    control.on_arrival(ev)
                elif fault_rt is not None:
                    fault_rt.dispatch(ev)
                else:
                    gi = placement.place(ev.program, ev.time_us, cores)
                    cores[gi].inject(ev)
                    placed[gi] += 1
            else:
                if control is None or not control.down:
                    # rebalancing (and the directory reap it implies) is
                    # coordinator work — suspended during an outage
                    moves = rebalancer.tick(cores, T)
                    if fabric is not None:
                        # lingering copies of finished tasks are garbage
                        fabric.reap()
                    if telemetry is not None:
                        telemetry.instant(
                            "rebalance_tick", TRACK_CLUSTER, T, moves=len(moves)
                        )
                        _sample_cluster_probes(telemetry, topology, cores, T)
                next_tick += rebalance_period_us
                if auditor is not None:
                    auditor.check(T, "tick")
        while True:
            for core in cores:
                core.run(horizon, final=True)
            # a reject hook firing during the terminal drain may bounce a
            # continuation into a core that already drained — re-drain until
            # quiescent (the retry budget bounds the bounces, so this
            # terminates; without retries pending is empty after one pass
            # and the composition is exactly the single terminal drain)
            leftover = [c for c in cores if c.pending]
            if not leftover:
                break
            # the next pass must actually re-enter the drained cores: push
            # the drain horizon past both the bounced arrivals and the
            # cores' (possibly overrun) clocks
            horizon = max(
                [horizon]
                + [c.pending[0].time_us + 1.0 for c in leftover]
                + [c.t + 1.0 for c in leftover]
            )
    finally:
        if wired_placement:
            placement.topology = prev_placement_topo
        # a reused topology must not carry this run's planner (or retime
        # hook, which closes over this run's cores) into the next run
        topology.planner = None
        topology.replan_hook = None
    if fabric is not None:
        # reclaim every remaining linger copy so end-of-run HBM accounting
        # balances (leak checks read pool.used)
        fabric.reap(final=True)
    lost_records: List = []
    if control is not None:
        # must run before fault_rt.drain_lost(): the control plane accounts
        # journal-known work that is NOT live in the runtime queues (plus
        # any backlog arrivals swallowed by a terminal outage), leaving the
        # live queue items for the runtime drain — no double counting
        lost_records.extend(control.drain_lost())
    if fault_rt is not None:
        if vault is not None:
            vault.prune(cores, fault_rt.live_extra())
        # work the fleet could never re-place is accounted, not dropped
        lost_records.extend(fault_rt.drain_lost())
        for i in range(len(placed)):
            placed[i] += fault_rt.placed[i]
    if control is not None:
        for i in range(len(placed)):
            placed[i] += control.placed[i]
    if auditor is not None:
        auditor.check(horizon, "final")

    results = [core.result() for core in cores]
    records = merge_request_records(
        [r.requests for r in results]
        + ([lost_records] if lost_records else [])
    )
    merged = merge_sim_results(results, records)
    window_us = max(trace.duration_us(), 1.0)
    stats = RequestStats.from_records(
        records, slo.ttft_us, slo.tpot_us, window_us
    )
    total_cap = sum(node.hbm_bytes for node in topology.gpus)
    peak = peak_concurrent_bytes(footprints, records)
    if control is not None:
        # stamp RT deadline outcomes from the merged records (post-hoc
        # bookkeeping only — no simulation effect)
        control.finalize(records)
    report = ClusterReport(
        backend=backend,
        placement=placement.name,
        n_gpus=len(cores),
        total_capacity_bytes=total_cap,
        oversubscription=peak / total_cap if total_cap else 0.0,
        offered_rps=trace.offered_rate_rps(),
        slo=slo,
        stats=stats,
        merged=merged,
        per_gpu=[
            GPUReport(
                name=node.name,
                platform=node.platform.name,
                capacity_bytes=node.hbm_bytes,
                placed=placed[i],
                result=results[i],
            )
            for i, node in enumerate(topology.gpus)
        ],
        migrations=list(rebalancer.events) if rebalancer else [],
        deferred_migrations=topology.deferred,
        peer_fetches=list(fabric.fetches) if fabric else [],
        peer_fetch_bytes=fabric.peer_bytes() if fabric else 0,
        peer_fallback_pages=fabric.fallback_pages if fabric else 0,
        linger_reclaimed_pages=fabric.reclaimed_pages if fabric else 0,
        linger_finish_reaped=fabric.finish_reaped if fabric else 0,
        faults_applied=len(fault_rt.applied) if fault_rt else 0,
        recoveries=list(fault_rt.recoveries) if fault_rt else [],
        shed_requests=len(fault_rt.shed_events) if fault_rt else 0,
        lost_requests=(fault_rt.lost if fault_rt else 0)
        + (control.lost if control else 0),
        retry_exhausted=rebalancer.exhausted if rebalancer else 0,
        checkpoints=vault.taken if vault else 0,
        checkpoint_bytes=vault.bytes if vault else 0,
        journal_len=len(control.journal) if control else 0,
        journal_replays=control.replays if control else 0,
        coordinator_crashes=control.crashes if control else 0,
        deadline_misses=control.deadline_misses if control else 0,
        preemptions=control.preemptions if control else 0,
        deadline_sheds=control.deadline_sheds if control else 0,
        planned_transfers=len(planner.log) if planner else 0,
        planner_replans=topology.replans,
        planner_deferred=planner.urgency_deferred if planner else 0,
    )
    if telemetry is not None:
        telemetry.finalize_cluster(report)
    return report


def _sample_cluster_probes(
    telemetry, topology: ClusterTopology, cores: Sequence[SimCore], now: float
) -> None:
    """Fleet-level time-series probes, sampled at every rebalance tick
    (never strided — ticks are already sparse): per-GPU HBM occupancy and
    queue depths, host staging-budget usage, and per-link in-flight bytes
    and sharer counts."""
    for core in cores:
        telemetry.counter(core.name, "hbm_used_pages", now, core.pool.used)
        telemetry.counter(core.name, "run_queue_depth", now, len(core.tasks))
        telemetry.counter(
            core.name, "wait_queue_depth", now, len(core.waiting)
        )
    telemetry.counter(
        "host", "staged_bytes", now, topology.host_staged_bytes(now)
    )
    # planned runs also expose the scheduler's own per-link queue (flights
    # with a remaining leg on the link); greedy runs have no planner and
    # emit exactly the historical probe set
    depths = (
        topology.planner.link_queue_depths(now)
        if topology.planner is not None
        else None
    )
    for link in topology.links():
        track = f"link:{link.a}<->{link.b}"
        telemetry.counter(
            track, "sharers", now, topology.active_on(link.a, link.b, now)
        )
        telemetry.counter(
            track,
            "inflight_bytes",
            now,
            topology.inflight_bytes(link.a, link.b, now),
        )
        if depths is not None:
            telemetry.counter(
                track,
                "queue_depth",
                now,
                depths.get(frozenset((link.a, link.b)), 0),
            )
