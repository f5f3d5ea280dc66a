"""Inter-GPU task migration: checkpoint the working set, price the transfer
on the link graph, re-admit a continuation on the target GPU.

Migration is iteration-granular: the source core ejects the task between
scheduler steps (``SimCore.eject``), which snapshots the resident working
set; work of a partially-completed iteration is replayed on the target. The
working set travels either peer-to-peer (NVLink edge) or host-staged
(src → host DRAM → dst), with link contention and the host staging budget
enforced by :class:`~repro_torch.cluster.topology.ClusterTopology`. On the target,
the continuation (:class:`ResumedTask`, same task id and address space,
iteration counter offset past the completed prefix) arrives as a normal
``TaskArrival`` at the transfer's landing time, with the checkpointed runs
populated into HBM at admission — the restore half of the move.

When a ``stage_dir`` is given, the working-set manifest actually round-trips
through ``repro_torch.checkpointing.checkpoint`` (the sharded .npy + msgpack
format) — the host-staged path writes real files, and the restored manifest
is what re-admission uses, so checkpoint integrity is on the migration
path, not asserted on the side.

The cheap rebalance move is *stealing*: a queued-but-unadmitted candidate on
the pressured GPU has nothing resident, so rerouting it costs nothing but
the decision. :class:`Rebalancer` always prefers steals and only checkpoints
running tasks when the wait queue is empty.

Between NVLink-connected GPUs the bulk copy is skipped entirely (the *lazy*
``p2p`` move): only the working-set manifest ships over the peer edge, the
pages linger on the source — demoted to its eviction-list head, free to
scavenge — and the target's extended context switches prefetch them over
NVLink on demand of the planner (see :mod:`repro_torch.cluster.prefetch`). The
host-staged checkpoint path remains for PCIe-only pairs.

Migration retry protocol: a migrated continuation queues behind the *target*
GPU's admission controller like any arrival, so a controller with a wait
deadline (``MSchedAdmission(max_wait_us=...)``) can reject a
partially-executed request. Instead of dropping the completed prefix, the
rebalancer's rejection handler (installed on every core via
:meth:`Rebalancer.attach`) returns the continuation to the GPU that still
holds its lingering working set, else to the original source, else to the
least-pressured GPU — up to ``max_retries`` bounces before the rejection is
allowed to stand. Fresh (never-executed) arrivals are still shed normally:
load shedding semantics only change for work the cluster already invested
in.

Copied from the JAX package's ``cluster/migration.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.hbm import resident_runs_in
from repro_torch.core.pages import PageRun, run_page_count
from repro_torch.core.simulator import (
    EjectedTask,
    SimCore,
    TaskArrival,
    active_demand_pages,
)
from repro_torch.core.workloads import TaskProgram
from repro_torch.cluster.topology import ClusterTopology


@dataclasses.dataclass
class MigrationEvent:
    """One completed rebalance move, for reporting.

    ``kind`` is ``"steal"`` (queued candidate re-routed, nothing resident),
    ``"checkpoint"`` (running task's working set bulk-transferred through
    the link graph), ``"p2p"`` (lazy NVLink move: only the manifest ships,
    ``nbytes`` is manifest bytes and ``pages`` the working set left
    lingering on the source as a prefetch source), ``"retry"`` (a
    deadline-rejected continuation returned to a GPU with headroom), or
    ``"exhausted"`` (the retry budget ran out: the continuation's rejection
    stands, its linger copy and staging reservation are released, and the
    request is accounted as failed)."""

    time_us: float
    task_id: int
    src: str
    dst: str
    kind: str  # "steal" | "checkpoint" | "p2p" | "retry" | "exhausted"
    pages: int
    nbytes: int
    arrival_us: float  # when the task lands on dst
    completed_iters: int = 0


# lazy p2p migration ships only the working-set manifest (run intervals +
# header), not the pages; sized after the checkpoint manifest encoding
MANIFEST_BASE_BYTES = 96
MANIFEST_RUN_BYTES = 16


class ResumedTask(TaskProgram):
    """Continuation of a migrated task: same task id and address space, with
    the iteration counter offset past the prefix completed on the source
    GPU. The inner program is *not* released on the source — its space (and
    the page-key identity the pools share) travels with it."""

    def __init__(self, inner: TaskProgram, completed: int):
        # no super().__init__: the continuation adopts the inner program's
        # address space instead of allocating a fresh one
        self.inner = inner
        self.task_id = inner.task_id
        self.space = inner.space
        self.name = f"{getattr(inner, 'name', 'task')}+mig{completed}"
        self.offset = completed
        klass = getattr(inner, "slo_class", None)
        if klass is not None:
            # graceful degradation classifies continuations like originals
            self.slo_class = klass
        total = getattr(inner, "total_iterations", None)
        self.total_iterations = (
            None if total is None else max(0, total - completed)
        )

    def iteration(self, it: int):
        return self.inner.iteration(it + self.offset)

    def footprint_bytes(self) -> int:
        return self.inner.footprint_bytes()

    def release(self):
        return self.inner.release()


# --------------------------------------------------------------------------
# Working-set checkpointing (through repro_torch.checkpointing)
# --------------------------------------------------------------------------


def pack_working_set(ej: EjectedTask, page_size: int) -> Dict[str, np.ndarray]:
    """The migration manifest as a flat pytree of host arrays — what the
    host-staged path serializes."""
    starts = np.asarray([s for s, _ in ej.resident_runs], dtype=np.int64)
    stops = np.asarray([e for _, e in ej.resident_runs], dtype=np.int64)
    return {
        "task_id": np.int64(ej.program.task_id),
        "completed": np.int64(ej.completed),
        "page_size": np.int64(page_size),
        "resident_starts": starts,
        "resident_stops": stops,
    }


def unpack_working_set(tree: Dict[str, np.ndarray]) -> List[PageRun]:
    return [
        (int(s), int(e))
        for s, e in zip(tree["resident_starts"], tree["resident_stops"])
    ]


def checkpoint_roundtrip(
    stage_dir: str, seq: int, ej: EjectedTask, page_size: int
) -> List[PageRun]:
    """Stage the working-set manifest through the sharded checkpoint format
    and return the *restored* resident runs (what re-admission warms HBM
    with). Imported lazily: the simulation path stays jax-free unless a
    stage dir is configured."""
    from repro_torch.checkpointing import checkpoint

    tree = pack_working_set(ej, page_size)
    checkpoint.save(stage_dir, seq, tree, keep=4)
    n = len(ej.resident_runs)
    target = {
        "task_id": np.zeros((), np.int64),
        "completed": np.zeros((), np.int64),
        "page_size": np.zeros((), np.int64),
        "resident_starts": np.zeros((n,), np.int64),
        "resident_stops": np.zeros((n,), np.int64),
    }
    restored = checkpoint.restore(stage_dir, seq, target)
    if int(restored["task_id"]) != ej.program.task_id:
        raise RuntimeError(
            f"checkpoint round-trip mismatch: staged task "
            f"{int(restored['task_id'])}, expected {ej.program.task_id}"
        )
    return unpack_working_set(restored)


# --------------------------------------------------------------------------
# Rebalancer
# --------------------------------------------------------------------------


class Rebalancer:
    """Periodic load rebalancing across cores.

    Pressure is memory demand relative to capacity — the same per-cycle
    demand admission and placement price (predicted per-quantum working sets
    plus the queued backlog). Each tick moves at most ``max_moves`` tasks
    from the most- to the least-pressured GPU while the gap exceeds
    ``threshold``; steals (queued candidates) are free, checkpointed moves
    of running tasks pay the link-graph transfer time and host staging, and
    NVLink pairs with a :class:`~repro_torch.cluster.prefetch.PeerPrefetchFabric`
    (``prefetch``) migrate *lazily* — manifest only, working set lingers on
    the source for peer prefetch.

    :meth:`attach` additionally installs the migration **retry protocol** on
    every core (see module docstring).
    """

    def __init__(
        self,
        topology: ClusterTopology,
        threshold: float = 0.5,
        max_moves: int = 1,
        quantum_us: Optional[float] = None,
        stage_dir: Optional[str] = None,
        prefetch=None,
        max_retries: int = 3,
        retry_backoff_us: float = 0.0,
        retry_backoff_cap_us: float = 400_000.0,
    ):
        assert threshold > 0
        self.topology = topology
        self.threshold = threshold
        self.max_moves = max_moves
        self.quantum_us = quantum_us
        self.stage_dir = stage_dir
        self.prefetch = prefetch  # PeerPrefetchFabric | None
        self.max_retries = max_retries
        # retry bounce N lands at now + min(backoff * 2**N, cap); the 0.0
        # default keeps retries instant (the PR 5 protocol)
        self.retry_backoff_us = retry_backoff_us
        self.retry_backoff_cap_us = retry_backoff_cap_us
        self.exhausted = 0
        self.events: List[MigrationEvent] = []
        # telemetry hub or None; assigned by simulate_cluster when tracing
        self.telemetry = None
        # ControlPlane or None; assigned by ControlPlane.attach. Move and
        # reroute decisions are journaled write-ahead (before the eject or
        # inject they commit) so a coordinator crash can replay them.
        self.control = None
        self._seq = 0
        self._cores: Sequence[SimCore] = ()
        # host-staged checkpoint transfers still parked in host DRAM, by
        # task id — released if the continuation's retry chain exhausts
        self._staged_plans: Dict[int, object] = {}

    def attach(self, cores: Sequence[SimCore]) -> None:
        """Register the fleet and install the per-core rejection handler
        that turns admission-deadline rejections of migrated continuations
        into retries instead of drops."""
        self._cores = list(cores)
        for core in self._cores:
            core.reject_hook = (
                lambda c: lambda ev, rec, warm: self._handle_reject(
                    c, ev, rec, warm
                )
            )(core)

    def _journal(self, kind: str, now: float, task_id: int, **payload) -> None:
        if self.control is not None:
            self.control.record(kind, now, task_id, **payload)

    # -- migration retry protocol -------------------------------------------
    def _handle_reject(self, core, ev, rec, warm) -> bool:
        """Re-route a rejected *continuation* (never a fresh arrival — load
        shedding semantics are unchanged for work the cluster has not yet
        executed) to the GPU holding its lingering working set, else its
        original source, else the least-pressured GPU. Returns True when the
        rejection was absorbed."""
        meta = ev.meta
        # only continuations carry "migrated_from" (steals preserve it); a
        # stolen-but-never-executed fresh arrival must still shed normally
        if "migrated_from" not in meta:
            return False
        tid = ev.program.task_id
        retries = int(meta.get("mig_retries", 0))
        candidates = [c for c in self._cores if c is not core and not c.failed]
        if retries >= self.max_retries or not candidates:
            if self.prefetch is not None:
                self.prefetch.release(tid)  # drop the stranded linger copy
            plan = self._staged_plans.pop(tid, None)
            if plan is not None:
                # the checkpointed working set parked in host DRAM will
                # never be consumed — release the staging reservation and
                # mark the plan canceled so the in-flight probes stop
                # counting it (a same-tick replan must count once)
                self.topology.cancel_staging(plan, core.t)
            self.exhausted += 1
            rec.meta["retry_exhausted"] = True
            self.events.append(
                MigrationEvent(
                    core.t, tid, core.name, core.name, "exhausted", 0, 0,
                    core.t,
                )
            )
            return False
        entry = (
            self.prefetch.directory.get(tid)
            if self.prefetch is not None
            else None
        )
        target = None
        if entry is not None:
            target = next(
                (c for c in candidates if c.name == entry.src), None
            )
        if target is None:
            src_name = meta.get("migrated_from")
            target = next(
                (c for c in candidates if c.name == src_name), None
            )
        if target is None:
            target = min(candidates, key=self.pressure)
        now = core.t
        arrival = now
        if self.retry_backoff_us > 0.0:
            arrival = now + min(
                self.retry_backoff_us * (2.0 ** retries),
                self.retry_backoff_cap_us,
            )
        warm = self._retarget_linger(tid, target.name, warm)
        self._journal(
            "reroute", now, tid, src=core.name, dst=target.name, via="retry"
        )
        target.inject(
            TaskArrival(
                arrival,
                ev.program,
                meta=dict(
                    meta, mig_retries=retries + 1, retried_from=core.name
                ),
            ),
            warm_runs=warm,
        )
        rec.meta["retried_to"] = target.name
        mv = MigrationEvent(
            now, tid, core.name, target.name, "retry", 0, 0, arrival
        )
        self.events.append(mv)
        self._emit_move(mv)
        return True

    def _retarget_linger(self, tid: int, dst_name: str, warm):
        """Point a re-routed continuation's lingering peer copy at its new
        target. The entry only stays in the directory when the new target
        can actually peer-fetch it (a *different* GPU with a direct NVLink
        edge to the source). Otherwise the copy is harvested into the warm
        runs that travel with the task — back to the holder itself (the
        task re-owns its pages at admission; a kept entry would keep
        feeding them to cluster_view as foreign runs), or beyond NVLink
        reach (host-staged with the re-route, the same convention as stolen
        checkpoint warm runs — the simulation must not later re-materialize
        data from a host DRAM that never held it). Returns the (possibly
        augmented) warm runs."""
        if self.prefetch is None:
            return warm
        entry = self.prefetch.directory.get(tid)
        if entry is None:
            return warm
        if (
            entry.src != dst_name
            and self.topology.nvlink_peer(entry.src, dst_name) is not None
        ):
            self.prefetch.directory.retarget(tid, dst_name)
            return warm
        harvested = self.prefetch.harvest(tid)
        if harvested:
            warm = list(warm or []) + harvested
        return warm

    def _emit_move(self, mv: MigrationEvent) -> None:
        """Trace one rebalance move and attribute its transit time. The
        transit splits against the uncontended floor: the solo portion is
        migration-wait, the excess (fluid sharing with concurrent transfers)
        is link-contention. Steals and retries move no bytes — instants
        only, their wait resolves into the queue-wait residual."""
        tel = self.telemetry
        if tel is None:
            return
        transit = max(0.0, mv.arrival_us - mv.time_us)
        if mv.kind in ("checkpoint", "p2p"):
            tel.span(
                "migration_plan",
                mv.src,
                mv.time_us,
                transit,
                task_id=mv.task_id,
                dst=mv.dst,
                kind=mv.kind,
                pages=mv.pages,
                nbytes=mv.nbytes,
            )
            solo = self.topology.solo_transfer_us(mv.src, mv.dst, mv.nbytes)
            tel.stall(mv.task_id, "mig_wait_transit", min(transit, solo))
            if transit > solo:
                tel.stall(mv.task_id, "link_contention", transit - solo)
        tel.instant(
            "migration_land",
            mv.dst,
            mv.arrival_us,
            task_id=mv.task_id,
            kind=mv.kind,
            src=mv.src,
        )

    def pressure(self, core: SimCore) -> float:
        st = core.state_view()
        quantum = self.quantum_us or getattr(st.policy, "quantum_us", 5_000.0)
        return (active_demand_pages(st, quantum) + st.waiting_pages) / max(
            1, st.pool.capacity
        )

    def tick(self, cores: Sequence[SimCore], now: float) -> List[MigrationEvent]:
        if self.topology.planner is not None:
            return self._tick_planned(cores, now)
        moves: List[MigrationEvent] = []
        alive = [c for c in cores if not c.failed]
        if len(alive) < 2:
            return moves
        for _ in range(self.max_moves):
            loads = [self.pressure(c) for c in alive]
            si = max(range(len(alive)), key=lambda i: loads[i])
            di = min(range(len(alive)), key=lambda i: loads[i])
            if si == di or loads[si] - loads[di] < self.threshold:
                break
            mv = self._move_one(alive[si], alive[di], now)
            if mv is None:
                break
            moves.append(mv)
            self._emit_move(mv)
        self.events.extend(moves)
        return moves

    def _tick_planned(
        self, cores: Sequence[SimCore], now: float
    ) -> List[MigrationEvent]:
        """Window collection for the attached
        :class:`~repro_torch.cluster.transfer_plan.TransferPlanner`: select up to
        ``max_moves`` candidates first (steals commit immediately — they
        move no bytes), then submit the bulk movements as *one* planner
        window so they are urgency-ordered, routed, and priced against the
        shared fluid schedule together. A deferred candidate (budget or
        marginal-makespan) simply stays put and is reconsidered at a later
        tick — identical caller semantics to a greedy budget deferral."""
        from repro_torch.cluster.transfer_plan import TransferRequest

        moves: List[MigrationEvent] = []
        alive = [c for c in cores if not c.failed]
        if len(alive) < 2:
            return moves
        candidates: List[tuple] = []
        picked: Dict[str, set] = {}
        # selected-but-uncommitted candidates shift pressure so one window
        # doesn't drain the same pressured pair max_moves times over
        shift: Dict[str, float] = {}
        for _ in range(self.max_moves):
            loads = [
                self.pressure(c) + shift.get(c.name, 0.0) for c in alive
            ]
            si = max(range(len(alive)), key=lambda i: loads[i])
            di = min(range(len(alive)), key=lambda i: loads[i])
            if si == di or loads[si] - loads[di] < self.threshold:
                break
            src, dst = alive[si], alive[di]
            mv = self._try_steal(src, dst, now)
            if mv is not None:
                moves.append(mv)
                self._emit_move(mv)
                continue
            tid = self._pick_victim(src, exclude=picked.get(src.name))
            if tid is None:
                break
            span = src.tasks[tid].prog.space.page_span()
            resident = resident_runs_in(src.pool, span)
            pages = run_page_count(resident)
            nbytes = pages * src.page_size
            lazy = (
                self.prefetch is not None
                and self.topology.nvlink_peer(src.name, dst.name) is not None
            )
            manifest = MANIFEST_BASE_BYTES + MANIFEST_RUN_BYTES * len(resident)
            candidates.append(
                (src, dst, tid, resident, nbytes, lazy, manifest)
            )
            picked.setdefault(src.name, set()).add(tid)
            shift[src.name] = shift.get(src.name, 0.0) - pages / max(
                1, src.pool.capacity
            )
            shift[dst.name] = shift.get(dst.name, 0.0) + pages / max(
                1, dst.pool.capacity
            )
        if candidates:
            reqs = [
                TransferRequest(
                    src.name,
                    dst.name,
                    manifest if lazy else nbytes,
                    "p2p" if lazy else "checkpoint",
                    None,
                    tid,
                )
                for (src, dst, tid, _r, nbytes, lazy, manifest) in candidates
            ]
            plans = self.topology.planner.submit(reqs, now)
            for cand, plan in zip(candidates, plans):
                if plan is None:
                    continue  # deferred — reconsidered at a later tick
                src, dst, tid, resident, nbytes, lazy, manifest = cand
                if lazy:
                    mv = self._commit_lazy(
                        src, dst, tid, resident, manifest, plan, now
                    )
                else:
                    mv = self._commit_checkpoint(
                        src, dst, tid, resident, nbytes, plan, now
                    )
                moves.append(mv)
                self._emit_move(mv)
        self.events.extend(moves)
        return moves

    def _try_steal(
        self, src: SimCore, dst: SimCore, now: float
    ) -> Optional[MigrationEvent]:
        stolen = src.steal_waiting()
        if stolen is None:
            return None
        ev, rec, warm = stolen
        # a stolen candidate may itself be a migrated continuation whose
        # checkpointed working set was still waiting for admission: the
        # warm runs travel with it (staged in host DRAM either way), and
        # a lingering peer copy either follows the retarget (NVLink
        # reachable) or is harvested into the warm runs
        warm = self._retarget_linger(ev.program.task_id, dst.name, warm)
        self._journal(
            "reroute",
            now,
            ev.program.task_id,
            src=src.name,
            dst=dst.name,
            via="steal",
        )
        dst.inject(
            TaskArrival(
                max(now, ev.time_us),
                ev.program,
                meta=dict(ev.meta, rerouted_from=src.name),
            ),
            warm_runs=warm,
        )
        return MigrationEvent(
            now, ev.program.task_id, src.name, dst.name, "steal",
            0, 0, max(now, ev.time_us),
        )

    def _move_one(
        self, src: SimCore, dst: SimCore, now: float
    ) -> Optional[MigrationEvent]:
        mv = self._try_steal(src, dst, now)
        if mv is not None:
            return mv
        tid = self._pick_victim(src)
        if tid is None:
            return None
        # price the transfer before ejecting: a host-DRAM-budget denial must
        # leave the source untouched (retry next tick)
        span = src.tasks[tid].prog.space.page_span()
        resident = resident_runs_in(src.pool, span)
        nbytes = run_page_count(resident) * src.page_size
        if (
            self.prefetch is not None
            and self.topology.nvlink_peer(src.name, dst.name) is not None
        ):
            return self._move_lazy(src, dst, tid, resident, now)
        plan = self.topology.plan_transfer(
            src.name, dst.name, nbytes, now, kind="checkpoint", task_id=tid
        )
        if plan is None:
            return None
        return self._commit_checkpoint(
            src, dst, tid, resident, nbytes, plan, now
        )

    def _commit_checkpoint(
        self,
        src: SimCore,
        dst: SimCore,
        tid: int,
        resident,
        nbytes: int,
        plan,
        now: float,
    ) -> MigrationEvent:
        self._journal(
            "migrate",
            now,
            tid,
            src=src.name,
            dst=dst.name,
            linger=False,
            nbytes=nbytes,
            arrival_us=plan.arrival_us,
        )
        if self.prefetch is not None:
            # a stale linger copy from an earlier visit elsewhere is dead
            # the moment the task's live working set moves through host
            self.prefetch.release(tid)
        ej = src.eject(tid, resident_runs=resident)
        warm = ej.resident_runs
        if self.stage_dir is not None:
            warm = checkpoint_roundtrip(
                self.stage_dir, self._seq, ej, src.page_size
            )
            self._seq += 1
        if ej.record is not None:
            ej.record.meta["migrated_to"] = dst.name
        cont = ResumedTask(ej.program, ej.completed)
        self._staged_plans[tid] = plan
        dst.inject(
            TaskArrival(
                plan.arrival_us, cont, meta={"migrated_from": src.name}
            ),
            warm_runs=warm,
        )
        return MigrationEvent(
            now, tid, src.name, dst.name, "checkpoint",
            run_page_count(ej.resident_runs), nbytes, plan.arrival_us,
            completed_iters=ej.completed,
        )

    def _move_lazy(
        self, src: SimCore, dst: SimCore, tid: int, resident, now: float
    ) -> Optional[MigrationEvent]:
        """Lazy NVLink migration: ship only the working-set manifest over
        the peer edge; the pages linger on the source (eviction-list head —
        free to scavenge) and the target's extended context switches
        prefetch them peer-to-peer as the planner demands them."""
        manifest = MANIFEST_BASE_BYTES + MANIFEST_RUN_BYTES * len(resident)
        plan = self.topology.plan_transfer(
            src.name, dst.name, manifest, now, kind="p2p", task_id=tid
        )
        if plan is None:
            return None
        return self._commit_lazy(src, dst, tid, resident, manifest, plan, now)

    def _commit_lazy(
        self,
        src: SimCore,
        dst: SimCore,
        tid: int,
        resident,
        manifest: int,
        plan,
        now: float,
    ) -> MigrationEvent:
        # journaled with src/dst/arrival: a journal replay rebuilds the
        # wiped directory entry for the still-lingering copy from this
        # record (validated against live pool residency)
        self._journal(
            "migrate",
            now,
            tid,
            src=src.name,
            dst=dst.name,
            linger=True,
            nbytes=manifest,
            arrival_us=plan.arrival_us,
        )
        self.prefetch.release(tid)  # stale copy from an earlier visit
        ej = src.eject(tid, resident_runs=resident, linger=True)
        if ej.record is not None:
            ej.record.meta["migrated_to"] = dst.name
        self.prefetch.directory.record(
            tid, src.name, dst.name, resident, plan.arrival_us
        )
        cont = ResumedTask(ej.program, ej.completed)
        dst.inject(
            TaskArrival(
                plan.arrival_us,
                cont,
                meta={"migrated_from": src.name, "transport": "nvlink-lazy"},
            )
        )
        return MigrationEvent(
            now, tid, src.name, dst.name, "p2p",
            run_page_count(resident), manifest, plan.arrival_us,
            completed_iters=ej.completed,
        )

    def _pick_victim(
        self, src: SimCore, exclude: Optional[set] = None
    ) -> Optional[int]:
        """Most recently admitted running task (least sunk prefix — the
        work-stealing heuristic); deterministic tie-break on task id.
        ``exclude`` skips tasks already selected in the current planner
        window (they are not ejected until their plan is admitted)."""
        best = None
        for tid in src.tasks:
            if exclude and tid in exclude:
                continue
            rec = src.rec_by_tid.get(tid)
            admitted = rec.admitted_us if rec is not None else 0.0
            key = (admitted if admitted is not None else 0.0, tid)
            if best is None or key > best[0]:
                best = (key, tid)
        return None if best is None else best[1]
