"""The crash-safe control plane: lifecycle tracking, the write-ahead
decision journal, coordinator crash/recovery, and SLO deadline enforcement.

One :class:`ControlPlane` observes (and, when deadlines or coordinator
faults are configured, steers) a whole ``simulate_cluster`` run. Its state
splits in two, and the split is the whole design:

  * **durable** — the :class:`~repro_torch.control.journal.DecisionJournal`
    (per-node agents keep appending even while the coordinator is down) and
    the client-side backlog of arrivals buffered during an outage (clients
    retry on reconnect, identically under every recovery mode);
  * **coordinator-volatile** — the lifecycle map, the deadline monitor's
    escalation counters, the peer-prefetch page directory, and the fault
    runtime's held/stranded/retry queues. A ``coordinator_crash`` fault
    wipes all of it mid-run.

``recovery="journal"`` rebuilds the volatile state by replaying the journal
against the surviving cores: lifecycle from the record stream, linger-hint
directory entries from unconsumed lazy-migration records validated against
live pool residency, and the fault runtime's queues from unreleased
``hold``/``strand``/``requeue`` records. The replay is idempotent —
replaying twice changes nothing (``replay_check=True`` asserts it at every
recovery, the CI chaos smoke's divergence check). ``recovery="cold"`` is
the ablation baseline: the restarted coordinator rediscovers only what the
cores still hold — parked victims and linger hints are simply lost.

Attached to a zero-fault run with no deadline monitoring, the control plane
is a pure observer: it adds no events to the DES loop and mutates nothing,
so such runs stay bit-for-bit identical to runs without it (pinned in
tests/control/test_control_plane.py).

Copied from the JAX package's ``control/plane.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Sequence

from repro_torch.core.hbm import resident_runs_in
from repro_torch.core.invariants import InvariantViolation
from repro_torch.core.simulator import RequestRecord, TaskArrival
from repro_torch.cluster.migration import ResumedTask
from repro_torch.telemetry.hub import TRACK_CLUSTER
from repro_torch.control.deadline import DeadlineMonitor, DeadlineSpec, slo_class_of
from repro_torch.control.journal import DecisionJournal
from repro_torch.control.lifecycle import (
    ADMITTED,
    RUNNING,
    TERMINAL_STATES,
    TaskLifecycle,
    apply_event,
)


class ControlPlane:
    """Submit/cancel/status API, decision journaling, crash recovery, and
    deadline enforcement over one cluster run.

    ``recovery`` picks how a ``coordinator_recover`` fault rebuilds the
    volatile state (``"journal"`` replay vs ``"cold"`` rediscovery);
    ``deadlines`` (+ ``deadline_period_us``) enables the RT deadline
    monitor. One instance serves exactly one run — :meth:`attach` refuses
    reuse, because the journal is the run's durable history.
    """

    def __init__(
        self,
        deadlines: Optional[DeadlineSpec] = None,
        deadline_period_us: Optional[float] = None,
        recovery: str = "journal",
        preempt_backoff_us: float = 50_000.0,
        preempt_backoff_cap_us: float = 400_000.0,
        max_preemptions: int = 3,
        replay_check: bool = False,
    ):
        if recovery not in ("journal", "cold"):
            raise ValueError(
                f"unknown control-plane recovery mode {recovery!r} "
                "(expected 'journal' or 'cold')"
            )
        self.recovery = recovery
        self.deadlines = deadlines
        self.deadline_period_us = deadline_period_us
        self.monitor = (
            DeadlineMonitor(
                deadlines,
                backoff_us=preempt_backoff_us,
                backoff_cap_us=preempt_backoff_cap_us,
                max_preemptions=max_preemptions,
            )
            if deadlines is not None and deadline_period_us
            else None
        )
        self.replay_check = replay_check

        self.journal = DecisionJournal()  # durable
        self.lifecycle = TaskLifecycle()  # coordinator-volatile
        self.down = False
        self.crashes = 0
        self.replays = 0
        self.preemptions = 0
        self.deadline_sheds = 0
        self.deadline_misses = 0  # filled by finalize()
        self.rt_requests = 0
        self.lost = 0

        # client-retry buffer for arrivals during an outage (external state:
        # identical under both recovery modes, by design)
        self._backlog: List[TaskArrival] = []
        self._lost_records: List[RequestRecord] = []
        # scheduled operator ops: (time_us, seq, ("submit", ev) | ("cancel", tid))
        self._ops: List[tuple] = []
        self._opseq = 0
        self._next_deadline = (
            deadline_period_us if self.monitor is not None else float("inf")
        )
        self._miss_emitted: set = set()

        # wired by attach()
        self._attached = False
        self.cores: Sequence = ()
        self.topology = None
        self.placement = None
        self.fabric = None
        self.rebalancer = None
        self.vault = None
        self.fault_rt = None
        self.telemetry = None
        self.placed: List[int] = []

    # -- wiring ---------------------------------------------------------------
    def attach(
        self,
        cores: Sequence,
        topology=None,
        placement=None,
        fabric=None,
        rebalancer=None,
        vault=None,
        fault_rt=None,
        telemetry=None,
    ) -> None:
        if self._attached:
            raise ValueError(
                "ControlPlane instances serve exactly one run; construct a "
                "fresh one per simulate_cluster call"
            )
        self._attached = True
        self.cores = list(cores)
        self.topology = topology
        self.placement = placement
        self.fabric = fabric
        self.rebalancer = rebalancer
        self.vault = vault
        self.fault_rt = fault_rt
        self.telemetry = telemetry
        self.placed = [0] * len(self.cores)
        for core in self.cores:
            core.lifecycle_hook = (
                lambda tid, event, now, _c=core: self._core_event(
                    _c, tid, event, now
                )
            )
        for component in (fault_rt, rebalancer, vault):
            if component is not None:
                component.control = self

    # -- the write-ahead journal ----------------------------------------------
    def record(
        self, kind: str, now: float, task_id: Optional[int] = None, **payload
    ):
        """Append the decision to the journal *before* it takes effect, then
        apply its lifecycle transition. While the coordinator is down the
        per-node agents still journal (the log is durable) but the lifecycle
        map is dead — replay reconstructs it at recovery."""
        rec = self.journal.append(kind, now, task_id, **payload)
        if not self.down:
            apply_event(self.lifecycle, kind, task_id, now)
        return rec

    def _core_event(self, core, tid: int, event: str, now: float) -> None:
        kind = {"admitted": "admit", "finished": "finish", "rejected": "reject"}[
            event
        ]
        self.record(kind, now, tid, gpu=core.name)

    # -- submit/cancel/status -------------------------------------------------
    def submit(self, program, time_us: float, meta: Optional[dict] = None):
        """Schedule a client submission at ``time_us`` (processed by the
        engine's control tick)."""
        ev = TaskArrival(time_us, program, dict(meta or {}))
        heapq.heappush(self._ops, (time_us, self._opseq, ("submit", ev)))
        self._opseq += 1
        return ev

    def cancel(self, task_id: int, time_us: float) -> None:
        """Schedule an operator cancel at ``time_us``."""
        heapq.heappush(self._ops, (time_us, self._opseq, ("cancel", task_id)))
        self._opseq += 1

    def status(self, task_id: int) -> Optional[str]:
        """Current lifecycle state, or None for an unknown task (including
        every task while the coordinator is down — the map is volatile)."""
        return self.lifecycle.state(task_id)

    def prediction_health(self) -> Optional[dict]:
        """Fleet prediction-accuracy gauges from the online auditor, so
        operators see template health next to the deadline counters.  None
        when the run is untraced or the hub has no auditor attached."""
        tel = self.telemetry
        aud = getattr(tel, "audit", None) if tel is not None else None
        if aud is None or not aud.fleet.commands:
            return None
        return aud.health()

    # -- engine interface -----------------------------------------------------
    def next_time(self) -> float:
        if self.down:
            return float("inf")
        t = self._ops[0][0] if self._ops else float("inf")
        return min(t, self._next_deadline)

    def tick(self, now: float) -> None:
        while self._ops and self._ops[0][0] <= now:
            _t, _s, (op, arg) = heapq.heappop(self._ops)
            if op == "submit":
                self._submit_and_place(arg, now)
            else:
                self._do_cancel(arg, now)
        if self.monitor is not None and now >= self._next_deadline:
            self._deadline_tick(now)
            while self._next_deadline <= now:
                self._next_deadline += self.deadline_period_us

    def on_arrival(self, ev: TaskArrival) -> Optional[int]:
        """Route one trace arrival. During an outage the arrival is
        buffered client-side and retried at ``coordinator_recover``."""
        if self.down:
            self._backlog.append(ev)
            return None
        return self._submit_and_place(ev, ev.time_us)

    def _submit_and_place(self, ev: TaskArrival, now: float) -> Optional[int]:
        tid = ev.program.task_id
        self.record(
            "submit",
            now,
            tid,
            tenant=ev.meta.get("tenant"),
            slo_class=slo_class_of(ev.meta, ev.program),
            arrival_us=ev.time_us,
            ev=ev,
        )
        if self.fault_rt is not None:
            # the fault runtime journals the place (or hold) itself
            return self.fault_rt.dispatch(ev)
        gi = self.placement.place(ev.program, ev.time_us, self.cores)
        self.record("place", now, tid, gpu=self.cores[gi].name)
        self.cores[gi].inject(ev)
        self.placed[gi] += 1
        return gi

    def _do_cancel(self, tid: int, now: float) -> bool:
        st = self.lifecycle.state(tid)
        if st is None or st in TERMINAL_STATES:
            return False
        self.record("cancel", now, tid, prior=st)
        found = False
        for core in self.cores:
            if not core.failed and core.cancel_task(tid, now):
                found = True
                break
        if not found and self.fault_rt is not None:
            found = self._cancel_parked(tid, now)
        if self.fabric is not None:
            self.fabric.release(tid)
        if self.vault is not None:
            self.vault.drop(tid)
        if self.telemetry is not None:
            self.telemetry.instant(
                "cancel", TRACK_CLUSTER, now, task_id=tid, found=found
            )
        return True

    def _cancel_parked(self, tid: int, now: float) -> bool:
        """Cancel a task parked in a coordinator queue (held/stranded/
        backing off)."""
        frt = self.fault_rt
        for i, (ev, _w, rec) in enumerate(frt._held):
            if ev.program.task_id == tid:
                del frt._held[i]
                self.record("release", now, tid, of="hold", why="cancel")
                self._mark_cancelled(rec, tid, ev.time_us, now)
                return True
        for i, (prog, completed, rec, _o) in enumerate(frt._stranded):
            if prog.task_id == tid:
                del frt._stranded[i]
                self.record("release", now, tid, of="strand", why="cancel")
                self._mark_cancelled(rec, tid, 0.0, now, completed)
                return True
        for i, (_d, _s, victim) in enumerate(frt._retryq):
            if victim[0].task_id == tid:
                del frt._retryq[i]
                heapq.heapify(frt._retryq)
                self.record("release", now, tid, of="requeue", why="cancel")
                self._mark_cancelled(victim[2], tid, 0.0, now, victim[1])
                return True
        return False

    def _mark_cancelled(
        self, rec, tid: int, arrival_us: float, now: float, completed: int = 0
    ) -> None:
        if rec is not None:
            rec.rejected = True
            rec.meta["cancelled_us"] = now
        else:
            self._lost_records.append(
                RequestRecord(
                    tid,
                    arrival_us,
                    rejected=True,
                    iterations_done=completed,
                    meta={"cancelled_us": now},
                )
            )

    # -- deadline enforcement -------------------------------------------------
    def _deadline_tick(self, now: float) -> None:
        for core in self.cores:
            if core.failed:
                continue
            risky = self.monitor.at_risk(core, now)
            if not risky:
                continue
            if self.telemetry is not None:
                for tid in risky:
                    if tid not in self._miss_emitted:
                        self._miss_emitted.add(tid)
                        self.telemetry.instant(
                            "deadline_miss",
                            core.name,
                            now,
                            task_id=tid,
                            projected=True,
                        )
            victim = self.monitor.pick_victim(core, now)
            if victim is None:
                continue  # nothing best-effort to preempt here
            if self.monitor.preempt_count(victim) >= self.monitor.max_preemptions:
                self._deadline_shed(core, victim, now, rt_task=risky[0])
            else:
                self._preempt(core, victim, now, rt_task=risky[0])

    def _preempt(self, core, victim: int, now: float, rt_task: int) -> None:
        backoff = self.monitor.backoff_for(victim)
        self.record(
            "preempt",
            now,
            victim,
            gpu=core.name,
            rt_task=rt_task,
            backoff_us=backoff,
            count=self.monitor.preempt_count(victim),
        )
        ej = core.eject(victim)
        if ej.record is not None:
            ej.record.meta["preempted_us"] = now
        cont = (
            ResumedTask(ej.program, ej.completed) if ej.completed else ej.program
        )
        core.inject(
            TaskArrival(
                now + backoff,
                cont,
                meta={
                    "migrated_from": core.name,
                    "preempted": True,
                    "slo_class": slo_class_of(
                        ej.record.meta if ej.record else None, ej.program
                    ),
                },
            )
        )
        self.preemptions += 1
        if self.telemetry is not None:
            self.telemetry.instant(
                "preempt",
                core.name,
                now,
                task_id=victim,
                rt_task=rt_task,
                backoff_us=backoff,
            )

    def _deadline_shed(self, core, victim: int, now: float, rt_task: int) -> None:
        # the escalation ladder's last rung: through MIGRATING (the eject)
        # to SHED, mirroring the lifecycle graph's RUNNING -> MIGRATING ->
        # SHED path
        self.record("preempt", now, victim, gpu=core.name, escalated=True)
        self.record("shed", now, victim, gpu=core.name, rt_task=rt_task)
        ej = core.eject(victim)
        if ej.record is not None:
            ej.record.rejected = True
            ej.record.meta["deadline_shed_us"] = now
        if self.fabric is not None:
            self.fabric.release(victim)
        if self.vault is not None:
            self.vault.drop(victim)
        self.deadline_sheds += 1
        if self.telemetry is not None:
            self.telemetry.instant(
                "shed", core.name, now, task_id=victim, reason="deadline_shed"
            )

    # -- coordinator crash/recovery -------------------------------------------
    def crash(self, now: float) -> None:
        """``coordinator_crash``: every piece of coordinator-volatile state
        dies. The journal (durable, node-local) survives."""
        if self.down:
            return
        self.down = True
        self.crashes += 1
        self.journal.append("crash", now)
        if self.telemetry is not None:
            self.telemetry.instant("coordinator_crash", TRACK_CLUSTER, now)
        self.lifecycle = TaskLifecycle()
        if self.monitor is not None:
            self.monitor.reset()
        self._miss_emitted.clear()
        if self.fabric is not None:
            for e in list(self.fabric.directory.entries()):
                self.fabric.directory.forget(e.task_id)
        if self.fault_rt is not None:
            if self.recovery == "journal":
                # the in-memory queues die; the journal holds the only copy
                self.fault_rt.wipe_queues()
            else:
                self._lost_records.extend(
                    self.fault_rt.drop_queues(now, "coordinator_crash")
                )

    def recover(self, now: float) -> None:
        if not self.down:
            return
        self.down = False
        self.journal.append("recover", now, mode=self.recovery)
        if self.telemetry is not None:
            self.telemetry.instant("coordinator_recover", TRACK_CLUSTER, now)
        if self.recovery == "journal":
            self._replay(now)
            if self.replay_check:
                fp1 = self._state_fingerprint()
                self._replay(now)
                if self._state_fingerprint() != fp1:
                    raise InvariantViolation(
                        "journal replay diverged: replaying twice at "
                        f"t={now:.0f}us is not a no-op"
                    )
            self.replays += 1
            if self.telemetry is not None:
                self.telemetry.instant(
                    "journal_replay",
                    TRACK_CLUSTER,
                    now,
                    records=len(self.journal),
                )
        else:
            self._cold_restart(now)
        # clients retry everything buffered during the outage — identical
        # under both modes, so the recovery comparison isolates queue and
        # hint loss
        backlog, self._backlog = self._backlog, []
        for ev in backlog:
            self._submit_and_place(ev, now)
        if self.fault_rt is not None:
            self.fault_rt._flush(now)
            self.fault_rt.drain_due_retries(now)
        if self.monitor is not None:
            self._next_deadline = max(
                self._next_deadline, now + self.deadline_period_us
            )

    # -- journal replay -------------------------------------------------------
    def _replay(self, now: float) -> None:
        lc = TaskLifecycle()
        for r in self.journal.records:
            apply_event(lc, r.kind, r.task_id, r.time_us)
        self.lifecycle = lc
        if self.fabric is not None:
            self._rebuild_directory(now)
        if self.fault_rt is not None:
            self._rebuild_queues()

    def _rebuild_directory(self, now: float) -> None:
        """Reconstruct linger hints: for every surviving linger flag, the
        journal's last lazy-migration record supplies src/dst/arrival, the
        live pool supplies the (possibly shrunken) resident runs, and
        anything unverifiable is reclaimed — recovery must close the
        orphaned-copy window the crash opened."""
        last_linger: Dict[int, object] = {}
        terminal: set = set()
        for r in self.journal.records:
            if r.kind == "migrate" and r.payload.get("linger"):
                last_linger[r.task_id] = r
            elif r.kind in ("finish", "reject", "shed", "cancel"):
                terminal.add(r.task_id)
        locate: Dict[int, str] = {}
        for core in self.cores:
            if core.failed:
                continue
            for tid in core.tasks:
                locate[tid] = core.name
            for ev, _r, _p in core.waiting:
                locate[ev.program.task_id] = core.name
            for ev in core.pending:
                locate[ev.program.task_id] = core.name
        directory = self.fabric.directory
        for core in self.cores:
            if core.failed:
                continue
            for tid in sorted(core.lingering):
                if directory.get(tid) is not None:
                    continue  # idempotent re-entry: already rebuilt
                rec = last_linger.get(tid)
                runs = []
                dst = None
                ok = (
                    rec is not None
                    and rec.payload.get("src") == core.name
                    and tid not in terminal
                )
                if ok:
                    dst = locate.get(tid, rec.payload.get("dst"))
                    ok = (
                        dst is not None
                        and dst != core.name
                        and self.topology.nvlink_peer(core.name, dst)
                        is not None
                    )
                if ok:
                    span = core.pool._task_spans.get(tid)
                    runs = (
                        resident_runs_in(core.pool, span)
                        if span is not None
                        else []
                    )
                    ok = bool(runs)
                if not ok:
                    self.fabric.reclaimed_pages += core.reclaim_linger(tid)
                    continue
                directory.record(
                    tid,
                    core.name,
                    dst,
                    runs,
                    rec.payload.get("arrival_us", now),
                )

    def _rebuild_queues(self) -> None:
        """Re-park unreleased hold/strand/requeue records into the fault
        runtime's queues (the payload references are the durable copy).
        Items already present — parked while the coordinator was down —
        are recognized by identity, keeping the rebuild idempotent."""
        frt = self.fault_rt
        held_ids = {id(t[0]) for t in frt._held}
        stranded_ids = {id(t[0]) for t in frt._stranded}
        retry_ids = {id(v[0]) for _d, _s, v in frt._retryq}
        for r in self.journal.unreleased():
            p = r.payload
            if r.kind == "hold":
                ev = p["ev"]
                if id(ev) not in held_ids:
                    frt._held.append((ev, p.get("warm"), p.get("rec")))
                    held_ids.add(id(ev))
            elif r.kind == "strand":
                prog = p["prog"]
                if id(prog) not in stranded_ids:
                    frt._stranded.append(
                        (prog, p["completed"], p.get("rec"), p["origin"])
                    )
                    stranded_ids.add(id(prog))
            elif r.kind == "requeue":
                prog = p["prog"]
                if id(prog) not in retry_ids:
                    heapq.heappush(
                        frt._retryq,
                        (
                            p["due_us"],
                            frt._seq,
                            (
                                prog,
                                p["completed"],
                                p.get("rec"),
                                p["origin"],
                                p["attempt"],
                            ),
                        ),
                    )
                    frt._seq += 1
                    retry_ids.add(id(prog))

    def _state_fingerprint(self):
        """Everything replay reconstructs, hashable — equal fingerprints
        before/after a second replay certify idempotence."""
        dir_entries = ()
        if self.fabric is not None:
            dir_entries = tuple(
                sorted(
                    (e.task_id, e.src, e.dst, tuple(e.runs), e.arrival_us)
                    for e in self.fabric.directory.entries()
                )
            )
        linger = tuple(tuple(sorted(c.lingering)) for c in self.cores)
        queues = ()
        if self.fault_rt is not None:
            frt = self.fault_rt
            queues = (
                tuple(id(t[0]) for t in frt._held),
                tuple(id(t[0]) for t in frt._stranded),
                tuple(
                    (d, id(v[0])) for d, _s, v in sorted(frt._retryq)
                ),
            )
        return (
            tuple(sorted(self.lifecycle.states().items())),
            dir_entries,
            linger,
            queues,
        )

    # -- cold restart ---------------------------------------------------------
    def _cold_restart(self, now: float) -> None:
        """The ablation baseline: an amnesiac coordinator rediscovers only
        what the data plane still holds. Work parked in coordinator queues
        (including victims stranded during the outage) and every linger
        hint are lost — exactly the cost the journal exists to avoid."""
        if self.fault_rt is not None:
            self._lost_records.extend(
                self.fault_rt.drop_queues(now, "coordinator_outage")
            )
        lc = TaskLifecycle()
        for core in self.cores:
            if core.failed:
                continue
            for tid in core.tasks:
                lc.assume(tid, RUNNING, now)
            for ev, _r, _p in core.waiting:
                lc.assume(ev.program.task_id, ADMITTED, now)
            for ev in core.pending:
                lc.assume(ev.program.task_id, ADMITTED, now)
            for tid in list(core.lingering):
                # hints unknowable without the journal: reclaim the copies
                self._reclaim(core, tid)
        self.lifecycle = lc

    def _reclaim(self, core, tid: int) -> None:
        freed = core.reclaim_linger(tid)
        if self.fabric is not None:
            self.fabric.reclaimed_pages += freed

    # -- end-of-run accounting ------------------------------------------------
    def drain_lost(self) -> List[RequestRecord]:
        """Account work the control plane lost (cold-dropped queues,
        cancels of parked items, and — if the run ends mid-outage — the
        client backlog plus journal-parked work the replay never ran)."""
        out, self._lost_records = self._lost_records, []
        if not self.down:
            return out
        if self.recovery == "journal" and self.fault_rt is not None:
            frt = self.fault_rt
            live = (
                {id(t[0]) for t in frt._held}
                | {id(t[0]) for t in frt._stranded}
                | {id(v[0]) for _d, _s, v in frt._retryq}
            )
            for r in self.journal.unreleased():
                obj = r.payload.get("ev") or r.payload.get("prog")
                if obj is None or id(obj) in live:
                    continue  # still parked: fault_rt drain accounts it
                self.lost += 1
                rec = r.payload.get("rec")
                if rec is not None:
                    rec.rejected = True
                    rec.meta["lost"] = "coordinator_down"
                else:
                    out.append(
                        RequestRecord(
                            r.task_id,
                            getattr(obj, "time_us", 0.0),
                            rejected=True,
                            iterations_done=r.payload.get("completed", 0),
                            meta={"lost": "coordinator_down"},
                        )
                    )
        for ev in self._backlog:
            self.lost += 1
            out.append(
                RequestRecord(
                    ev.program.task_id,
                    ev.time_us,
                    rejected=True,
                    meta=dict(ev.meta, lost="coordinator_down"),
                )
            )
        self._backlog.clear()
        if self.fabric is not None:
            # the wiped directory can never reap surviving linger flags
            for core in self.cores:
                if core.failed:
                    continue
                for tid in list(core.lingering):
                    if self.fabric.directory.get(tid) is None:
                        self._reclaim(core, tid)
        return out

    def finalize(self, records: Sequence[RequestRecord]) -> None:
        """Deadline-miss accounting over the merged request records: an RT
        request misses when it never finished, blew its TTFT budget, or
        blew its completion budget."""
        if self.deadlines is None:
            return
        spec = self.deadlines
        misses = 0
        rt = 0
        for rec in records:
            if slo_class_of(rec.meta, None) != "rt":
                continue
            rt += 1
            ttft = rec.ttft_us()
            lat = rec.latency_us()
            if rec.finished_us is None:
                misses += 1
            elif ttft is not None and ttft > spec.rt_ttft_us:
                misses += 1
            elif lat is not None and lat > spec.rt_latency_us:
                misses += 1
        self.deadline_misses = misses
        self.rt_requests = rt
