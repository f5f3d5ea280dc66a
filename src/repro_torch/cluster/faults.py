"""Fault injection and recovery: GPU loss, link degradation, task crashes —
and the machinery that keeps the fleet serving through them.

The paper's thesis is that memory movement is predictable enough to schedule
*proactively*; a production fleet must also survive the unpredictable. This
module supplies both halves:

  * :class:`FaultInjector` — a seeded, trace-schedulable source of
    :class:`FaultEvent`\\ s (``gpu_fail``/``gpu_recover``, per-edge
    ``link_degrade``/``link_restore`` flaps, ``task_crash`` ECC-style fatal
    faults) that ``simulate_cluster`` consumes as first-class events in its
    conservative DES loop. Schedules are either explicit (tests pin exact
    timelines) or sampled (:meth:`FaultInjector.random` — exponential
    fail/repair cycles, deterministic per seed).
  * :class:`CheckpointVault` — periodic working-set snapshots to host DRAM,
    priced as real D2H transfers on the link graph (checkpointing *contends*
    with migrations and prefetches for the PCIe root port — the overhead the
    goodput benchmark charges against recovery quality).
  * :class:`FaultRuntime` — the recovery policy. A failing GPU surrenders
    everything (``SimCore.fail``); queued candidates are re-dispatched to
    surviving devices (their host-DRAM warm sets re-priced through
    ``plan_restore``), and each running victim is re-placed from its best
    durable source:

      1. a *landed* checkpoint with progress (``completed > 0``) — restores
         the iteration prefix, pays one H2D restore leg;
      2. a surviving linger copy (harvested through the existing
         ``PageDirectory`` path) — loses this visit's iterations but lands
         instantly on the GPU that still holds the working set;
      3. a progress-free checkpoint (warm pages only);
      4. cold restart — nothing durable survived; pages fault back in from
         the host backing store.

    A restore denied by the saturated host staging budget backs off with
    capped exponential delay (layered on the PR 5 retry protocol) before
    degrading to a colder source. When capacity shrinks, graceful
    degradation sheds best-effort queued work *before* touching RT SLO
    classes.

The UM backing-store model is what makes recovery semantics crisp: host DRAM
holds every page's backing copy, so a GPU failure loses only the HBM *cache*
and execution state. Durable progress therefore lives in exactly two places
— checkpointed iteration counts, and the iteration offset already baked into
a migrated continuation — and recovery is always "re-place the program
somewhere, warm or cold".

Copied from the JAX package's ``cluster/faults.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
import heapq
import random
from typing import Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.core.hbm import resident_runs_in
from repro_torch.core.pages import PageRun, run_page_count
from repro_torch.core.simulator import (
    EjectedTask,
    RequestRecord,
    SimCore,
    TaskArrival,
    active_demand_pages,
)
from repro_torch.cluster.migration import ResumedTask, checkpoint_roundtrip
from repro_torch.cluster.topology import HOST, ClusterTopology
from repro_torch.cluster.transfer_plan import URGENCY_RESTORE, URGENCY_RT
from repro_torch.control.deadline import slo_class_of

FAULT_KINDS = (
    "gpu_fail",
    "gpu_recover",
    "link_degrade",
    "link_restore",
    "task_crash",
    "coordinator_crash",
    "coordinator_recover",
)


@dataclasses.dataclass(frozen=True)
class FaultEvent:
    """One scheduled fault. ``gpu`` names the device for GPU events;
    ``link`` is the ``(a, b)`` endpoint pair for link events (``factor``
    scales its bandwidth, 0.0 = NVLink edge down); ``task_id`` optionally
    pins which task a ``task_crash`` kills (``None`` = seeded pick among
    the tasks running at crash time). ``coordinator_crash``/
    ``coordinator_recover`` tear down and restart the control plane —
    schedules containing them require ``simulate_cluster(control=...)``."""

    time_us: float
    kind: str
    gpu: Optional[str] = None
    link: Optional[Tuple[str, str]] = None
    factor: float = 1.0
    task_id: Optional[int] = None

    def __post_init__(self):
        if self.kind not in FAULT_KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}")
        if self.kind in ("gpu_fail", "gpu_recover") and not self.gpu:
            raise ValueError(f"{self.kind} needs a gpu name")
        if self.kind in ("link_degrade", "link_restore") and not self.link:
            raise ValueError(f"{self.kind} needs link endpoints")
        if self.kind == "link_degrade" and not 0.0 <= self.factor <= 1.0:
            raise ValueError(f"degrade factor must be in [0, 1]")


class FaultInjector:
    """A fault schedule: an ordered stream of :class:`FaultEvent`.

    Built either from an explicit event list (tests pin timelines) or
    sampled via :meth:`random` (exponential MTBF/MTTR cycles, deterministic
    per seed). ``FaultInjector.none()`` is the explicit empty schedule —
    pinned bit-for-bit identical to running without an injector, because
    the engine constructs no fault machinery for it."""

    def __init__(self, events: Sequence[FaultEvent] = ()):
        evs = list(events)
        for ev in evs:
            if not isinstance(ev, FaultEvent):
                raise TypeError(f"expected FaultEvent, got {type(ev)!r}")
        # stable sort: simultaneous events keep schedule order
        self.events: List[FaultEvent] = sorted(evs, key=lambda e: e.time_us)

    @classmethod
    def none(cls) -> "FaultInjector":
        return cls(())

    @property
    def empty(self) -> bool:
        return not self.events

    @classmethod
    def random(
        cls,
        topology: ClusterTopology,
        duration_us: float,
        seed: int = 0,
        gpu_mtbf_us: Optional[float] = None,
        gpu_mttr_us: float = 400_000.0,
        link_mtbf_us: Optional[float] = None,
        link_mttr_us: float = 150_000.0,
        link_factor: float = 0.25,
        crash_mtbf_us: Optional[float] = None,
        coord_mtbf_us: Optional[float] = None,
        coord_mttr_us: float = 300_000.0,
    ) -> "FaultInjector":
        """Sample a schedule over ``[0, duration_us)``: per-GPU exponential
        fail→repair cycles (``gpu_mtbf_us``/``gpu_mttr_us``), per-link
        degrade→restore flaps (NVLink edges may use any ``link_factor``
        including 0; host PCIe links are clamped to ≥ 0.05 — a GPU with no
        host path is a failed GPU, not a slow link), a fleet-wide Poisson
        crash process (``crash_mtbf_us``), and coordinator outage cycles
        (``coord_mtbf_us``/``coord_mttr_us``). ``None`` disables a fault
        class. Deterministic for a given seed."""
        rnd = random.Random(seed)
        events: List[FaultEvent] = []
        if gpu_mtbf_us:
            for g in sorted(n.name for n in topology.gpus):
                t = rnd.expovariate(1.0 / gpu_mtbf_us)
                while t < duration_us:
                    repair = rnd.expovariate(1.0 / gpu_mttr_us)
                    events.append(FaultEvent(t, "gpu_fail", gpu=g))
                    events.append(FaultEvent(t + repair, "gpu_recover", gpu=g))
                    t += repair + rnd.expovariate(1.0 / gpu_mtbf_us)
        if link_mtbf_us:
            for link in sorted(
                topology.links(), key=lambda l: (l.a, l.b)
            ):
                ends = (link.a, link.b)
                factor = (
                    link_factor
                    if link.kind == "nvlink"
                    else max(link_factor, 0.05)
                )
                t = rnd.expovariate(1.0 / link_mtbf_us)
                while t < duration_us:
                    repair = rnd.expovariate(1.0 / link_mttr_us)
                    events.append(
                        FaultEvent(
                            t, "link_degrade", link=ends, factor=factor
                        )
                    )
                    events.append(
                        FaultEvent(t + repair, "link_restore", link=ends)
                    )
                    t += repair + rnd.expovariate(1.0 / link_mtbf_us)
        if crash_mtbf_us:
            t = rnd.expovariate(1.0 / crash_mtbf_us)
            while t < duration_us:
                events.append(FaultEvent(t, "task_crash"))
                t += rnd.expovariate(1.0 / crash_mtbf_us)
        if coord_mtbf_us:
            t = rnd.expovariate(1.0 / coord_mtbf_us)
            while t < duration_us:
                repair = rnd.expovariate(1.0 / coord_mttr_us)
                events.append(FaultEvent(t, "coordinator_crash"))
                events.append(FaultEvent(t + repair, "coordinator_recover"))
                t += repair + rnd.expovariate(1.0 / coord_mtbf_us)
        return cls(events)


# --------------------------------------------------------------------------
# Checkpoint vault
# --------------------------------------------------------------------------


@dataclasses.dataclass
class Checkpoint:
    """One durable working-set snapshot in host DRAM. ``ready_us`` is when
    the D2H copy lands (a checkpoint is restorable only once *landed* — a
    failure mid-copy loses it). ``program`` pins the snapshot to the exact
    continuation it was taken from: ``completed`` is relative to that
    program's iteration base, so a checkpoint must never restore against a
    different visit's continuation."""

    task_id: int
    taken_us: float
    ready_us: float
    completed: int
    runs: List[PageRun]
    nbytes: int
    program: object


class CheckpointVault:
    """Periodic per-task working-set snapshots, priced on the link graph.

    ``snapshot`` walks every running task on every alive core and copies
    its resident working set D2H over the core's host link — sharing
    (and contending for) the same fluid-share bandwidth migrations use.
    Checkpoint *residency* in host DRAM is durable storage (not charged to
    the transient staging budget); the *restore* leg is priced by
    ``ClusterTopology.plan_restore`` at recovery time. Snapshots of a task
    that made no progress since its last checkpoint are skipped (no new
    information, no D2H traffic). With a ``stage_dir`` each manifest
    round-trips through the sharded on-disk checkpoint format."""

    def __init__(
        self,
        topology: ClusterTopology,
        page_size: int,
        stage_dir: Optional[str] = None,
        keep: int = 2,
    ):
        assert keep >= 1
        self.topology = topology
        self.page_size = page_size
        self.stage_dir = stage_dir
        self.keep = keep
        self._by_task: Dict[int, List[Checkpoint]] = {}
        self._seq = 0
        self.taken = 0
        self.bytes = 0
        self.skipped = 0  # no-progress snapshots avoided
        self.deferred = 0  # D2H legs denied by link-graph planning
        # telemetry hub or None; assigned by simulate_cluster when tracing
        self.telemetry = None
        # ControlPlane or None; assigned by ControlPlane.attach
        self.control = None

    def snapshot(self, cores: Sequence[SimCore], now: float) -> int:
        """Checkpoint every running task on every alive core; returns the
        number of snapshots taken."""
        n = 0
        for core in cores:
            if core.failed:
                continue
            for tid in sorted(core.tasks):
                rt = core.tasks[tid]
                cks = self._by_task.get(tid)
                if (
                    cks
                    and cks[-1].program is rt.prog
                    and cks[-1].completed == rt.stats.completions
                ):
                    self.skipped += 1
                    continue
                span = rt.prog.space.page_span()
                runs = resident_runs_in(core.pool, span)
                nbytes = run_page_count(runs) * self.page_size
                if nbytes:
                    # snapshots are speculative traffic: an attached planner
                    # may defer them behind urgent restores under a storm
                    plan = self.topology.plan_transfer(
                        core.name, HOST, nbytes, now,
                        kind="snapshot", task_id=rt.prog.task_id,
                    )
                    if plan is None:
                        self.deferred += 1
                        continue
                    ready = plan.arrival_us
                else:
                    ready = now
                if self.control is not None:
                    self.control.record(
                        "checkpoint",
                        now,
                        tid,
                        gpu=core.name,
                        nbytes=nbytes,
                        completed=rt.stats.completions,
                    )
                if self.stage_dir is not None:
                    runs = checkpoint_roundtrip(
                        self.stage_dir,
                        self._seq,
                        EjectedTask(rt.prog, rt.stats.completions, runs, None),
                        self.page_size,
                    )
                    self._seq += 1
                lst = self._by_task.setdefault(tid, [])
                lst.append(
                    Checkpoint(
                        tid, now, ready, rt.stats.completions,
                        list(runs), nbytes, rt.prog,
                    )
                )
                del lst[:-self.keep]
                self.taken += 1
                self.bytes += nbytes
                n += 1
                if self.telemetry is not None:
                    self.telemetry.span(
                        "checkpoint",
                        core.name,
                        now,
                        ready - now,
                        task_id=tid,
                        nbytes=nbytes,
                        completed=rt.stats.completions,
                    )
        return n

    def get(
        self, task_id: int, now: float, program: object
    ) -> Optional[Checkpoint]:
        """Best restorable checkpoint: landed (``ready_us <= now``), taken
        from exactly this continuation (stale cross-visit snapshots would
        restore a ``completed`` count against the wrong iteration base),
        most progress wins, newest breaks ties."""
        best = None
        for ck in self._by_task.get(task_id, ()):
            if ck.ready_us > now or ck.program is not program:
                continue
            if (
                best is None
                or ck.completed > best.completed
                or (ck.completed == best.completed and ck.taken_us > best.taken_us)
            ):
                best = ck
        return best

    def drop(self, task_id: int) -> None:
        self._by_task.pop(task_id, None)

    def prune(
        self, cores: Sequence[SimCore], extra_live: Sequence[int] = ()
    ) -> int:
        """Drop checkpoints of tasks no longer live anywhere (finished,
        shed, or lost) — the no-orphaned-artifacts half of the vault's
        contract. ``extra_live`` protects victims the fault runtime still
        holds (stranded, held, or backing off)."""
        live: Set[int] = set(extra_live)
        for core in cores:
            live.update(core.tasks)
            live.update(ev.program.task_id for ev, _r, _p in core.waiting)
            live.update(ev.program.task_id for ev in core.pending)
            live.update(core.lingering)
        dead = [tid for tid in self._by_task if tid not in live]
        for tid in dead:
            del self._by_task[tid]
        return len(dead)


# --------------------------------------------------------------------------
# Fault runtime (recovery policy)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class RecoveryEvent:
    """One recovery decision, for reporting. ``kind`` is ``"checkpoint"``
    (restored a landed snapshot: ``completed`` iterations preserved),
    ``"linger"`` (re-placed on the GPU still holding the working set —
    instant, but this visit's iterations replay), ``"cold"`` (nothing
    durable survived), or ``"requeue"`` (restore denied by the staging
    budget; backing off). ``replayed_iters`` is the progress lost."""

    time_us: float
    task_id: int
    kind: str  # "checkpoint" | "linger" | "cold" | "requeue"
    src: str  # the failed/crashed origin
    dst: str
    completed: int  # iterations the recovery source preserves
    replayed_iters: int
    arrival_us: float


class FaultRuntime:
    """Consumes a :class:`FaultInjector` schedule inside the cluster loop
    and drives recovery. Owns the retry heap (capped exponential backoff on
    budget-denied restores), the held/stranded sets (work with *no* alive
    GPU to run on), and graceful degradation (shedding best-effort queued
    candidates before RT classes when fleet capacity shrinks past
    ``shed_threshold``; RT classes are only shed past ``shed_rt_threshold``,
    default never)."""

    def __init__(
        self,
        injector: FaultInjector,
        topology: ClusterTopology,
        cores: Sequence[SimCore],
        placement,
        fabric=None,
        vault: Optional[CheckpointVault] = None,
        recovery: str = "auto",
        shed_threshold: Optional[float] = 1.25,
        shed_rt_threshold: Optional[float] = None,
        backoff_us: float = 25_000.0,
        backoff_cap_us: float = 400_000.0,
        max_recovery_retries: int = 8,
        seed: int = 0,
    ):
        if recovery not in ("auto", "checkpoint", "linger", "cold"):
            raise ValueError(f"unknown recovery mode {recovery!r}")
        if (
            shed_threshold is not None
            and shed_rt_threshold is not None
            and shed_rt_threshold < shed_threshold
        ):
            raise ValueError(
                "shed_rt_threshold must be >= shed_threshold (RT work "
                "sheds only after best-effort)"
            )
        self.events = list(injector.events)
        self.topology = topology
        self.cores = list(cores)
        self._by_name = {c.name: c for c in self.cores}
        self.placement = placement
        self.fabric = fabric
        self.vault = vault
        self.recovery = recovery
        self.shed_threshold = shed_threshold
        self.shed_rt_threshold = shed_rt_threshold
        self.backoff_us = backoff_us
        self.backoff_cap_us = backoff_cap_us
        self.max_recovery_retries = max_recovery_retries
        self.rnd = random.Random(seed)

        self._ei = 0
        # (due_us, seq, (prog, completed, rec, origin, attempt))
        self._retryq: List[Tuple[float, int, tuple]] = []
        self._seq = 0
        # arrivals with no alive GPU: (TaskArrival, warm_runs, record|None)
        self._held: List[tuple] = []
        # running victims with no alive GPU: (prog, completed, rec, origin)
        self._stranded: List[tuple] = []

        # telemetry hub or None; assigned by simulate_cluster when tracing
        self.telemetry = None
        # ControlPlane or None; assigned by ControlPlane.attach. When set,
        # every queue decision is journaled write-ahead, and the runtime's
        # coordinator-side work (placement, flush, shedding, retries) is
        # gated while the coordinator is down.
        self.control = None
        self.applied: List[FaultEvent] = []
        self.recoveries: List[RecoveryEvent] = []
        self.shed_events: List[Tuple[float, int, str, str]] = []
        self.crashes = 0
        self.lost = 0  # set by drain_lost()
        self.placed = [0] * len(self.cores)

    # -- control-plane coupling ----------------------------------------------
    def _ctl_down(self) -> bool:
        return self.control is not None and self.control.down

    def _journal(self, kind: str, now: float, task_id: int, **payload) -> None:
        if self.control is not None:
            self.control.record(kind, now, task_id, **payload)

    # -- event-stream interface (the engine's DES loop) ----------------------
    def next_time(self) -> float:
        t = (
            self.events[self._ei].time_us
            if self._ei < len(self.events)
            else float("inf")
        )
        if self._retryq and not self._ctl_down():
            t = min(t, self._retryq[0][0])
        return t

    def drain_due_retries(self, now: float) -> None:
        """Pop and re-attempt every backoff-denied restore due by ``now``.
        Also called at ``coordinator_recover``: rebuilt retry entries may
        carry due times from before the outage."""
        while (
            self._retryq
            and self._retryq[0][0] <= now
            and not self._ctl_down()
        ):
            _due, _seq, victim = heapq.heappop(self._retryq)
            prog, completed, rec, origin, attempt = victim
            self._journal("release", now, prog.task_id, of="requeue")
            self._recover(prog, completed, rec, origin, now, attempt)

    def apply_due(self, now: float) -> None:
        """Process every retry and fault event due at or before ``now``."""
        self.drain_due_retries(now)
        while (
            self._ei < len(self.events)
            and self.events[self._ei].time_us <= now
        ):
            ev = self.events[self._ei]
            self._ei += 1
            self._apply(ev, now)
            self.applied.append(ev)

    def dispatch(self, ev: TaskArrival) -> Optional[int]:
        """Place a trace arrival on an alive GPU (the placement policy sees
        only the alive subset). Returns the fleet index, or ``None`` when
        no GPU is alive — the arrival is held and flushed at the next
        ``gpu_recover`` (or accounted lost at drain)."""
        alive = [(i, c) for i, c in enumerate(self.cores) if not c.failed]
        if not alive:
            self._journal(
                "hold", ev.time_us, ev.program.task_id, ev=ev, rec=None
            )
            self._held.append((ev, None, None))
            return None
        idx = self.placement.place(
            ev.program, ev.time_us, [c for _i, c in alive]
        )
        i, core = alive[idx]
        self._journal("place", ev.time_us, ev.program.task_id, gpu=core.name)
        core.inject(ev)
        self.placed[i] += 1
        return i

    # -- fault application ----------------------------------------------------
    def _apply(self, ev: FaultEvent, now: float) -> None:
        tel = self.telemetry
        if ev.kind == "gpu_fail":
            if tel is not None:
                tel.instant("gpu_fail", ev.gpu, now)
            self._gpu_fail(ev.gpu, now)
        elif ev.kind == "gpu_recover":
            core = self._require_core(ev.gpu)
            if tel is not None and core.failed:
                tel.instant("gpu_recover", ev.gpu, now)
            core.recover(now)
            self._flush(now)
        elif ev.kind == "link_degrade":
            self.topology.degrade(ev.link[0], ev.link[1], ev.factor)
            if tel is not None:
                tel.counter(
                    f"link:{ev.link[0]}<->{ev.link[1]}",
                    "bandwidth_factor",
                    now,
                    ev.factor,
                )
        elif ev.kind == "link_restore":
            self.topology.restore(ev.link[0], ev.link[1])
            if tel is not None:
                tel.counter(
                    f"link:{ev.link[0]}<->{ev.link[1]}",
                    "bandwidth_factor",
                    now,
                    1.0,
                )
        elif ev.kind == "task_crash":
            self._crash(ev, now)
        elif ev.kind == "coordinator_crash":
            # validated at engine construction: these events require a
            # ControlPlane, so self.control is never None here
            self.control.crash(now)
        elif ev.kind == "coordinator_recover":
            self.control.recover(now)

    def _require_core(self, name: str) -> SimCore:
        core = self._by_name.get(name)
        if core is None:
            raise ValueError(f"fault event names unknown GPU {name!r}")
        return core

    def _gpu_fail(self, name: str, now: float) -> None:
        core = self._require_core(name)
        if core.failed:
            return  # double-fail in a sampled schedule: already down
        if self.fabric is not None:
            # linger copies *on* the device evaporate with its HBM
            self.fabric.drop_gpu(name)
        report = core.fail(now)
        if self.control is not None:
            # the failure tears every resident task down — journal before
            # any re-placement decision references them
            for victim in report.running:
                self._journal("fail", now, victim.program.task_id, gpu=name)
            for ev, _rec, _warm in report.waiting:
                self._journal("fail", now, ev.program.task_id, gpu=name)
            for ev, _warm in report.pending:
                self._journal("fail", now, ev.program.task_id, gpu=name)
        # queued/pending candidates survive (their state is host-side):
        # re-dispatch each, re-pricing any host-DRAM warm set
        for ev, rec, warm in report.waiting:
            self._redispatch(ev, rec, warm, now, name)
        for ev, warm in report.pending:
            self._redispatch(ev, None, warm, now, name)
        # running victims lost their execution state: recover from the best
        # durable source
        for victim in report.running:
            self._recover(
                victim.program, victim.completed, victim.record, name, now
            )
        self._shed_pressure(now)

    def _crash(self, ev: FaultEvent, now: float) -> None:
        tid = ev.task_id
        core = None
        if tid is not None:
            core = next(
                (
                    c
                    for c in self.cores
                    if not c.failed and tid in c.tasks
                ),
                None,
            )
        else:
            running = [
                (c.name, t, c)
                for c in self.cores
                if not c.failed
                for t in sorted(c.tasks)
            ]
            if running:
                _n, tid, core = running[self.rnd.randrange(len(running))]
        if core is None:
            return  # nothing to kill (pinned task not running anywhere)
        self._journal("fail", now, tid, gpu=core.name, crash=True)
        ej = core.eject(tid)
        if ej.record is not None:
            ej.record.meta["crashed_us"] = now
        self.crashes += 1
        self._recover(ej.program, ej.completed, ej.record, core.name, now)

    # -- recovery ------------------------------------------------------------
    def _log_recovery(self, rev: RecoveryEvent) -> None:
        self.recoveries.append(rev)
        tel = self.telemetry
        if tel is None:
            return
        tel.instant(
            "recovery",
            rev.dst or rev.src,
            rev.time_us,
            task_id=rev.task_id,
            kind=rev.kind,
            src=rev.src,
            replayed_iters=rev.replayed_iters,
        )
        # the gap between the recovery decision and the continuation's
        # re-arrival (restore transit, or backoff on a denied restore) is
        # recovery-induced: the task runs nowhere during it
        tel.stall(rev.task_id, "recovery", rev.arrival_us - rev.time_us)

    def _recover(
        self,
        prog,
        completed: int,
        rec: Optional[RequestRecord],
        origin: str,
        now: float,
        attempt: int = 0,
    ) -> None:
        tid = prog.task_id
        alive = [c for c in self.cores if not c.failed]
        if not alive or self._ctl_down():
            # no placement without an alive GPU — or without a coordinator
            # to decide one. The node agent journals the parked victim: in
            # journal mode the record is what replay re-parks after a
            # coordinator crash wipes this queue.
            self._journal(
                "strand",
                now,
                tid,
                prog=prog,
                completed=completed,
                rec=rec,
                origin=origin,
            )
            self._stranded.append((prog, completed, rec, origin))
            return
        ck = None
        if self.vault is not None and self.recovery in ("auto", "checkpoint"):
            ck = self.vault.get(tid, now, prog)
        linger_src = None
        if self.fabric is not None and self.recovery in ("auto", "linger"):
            entry = self.fabric.directory.get(tid)
            if entry is not None:
                src = self._by_name.get(entry.src)
                if src is not None and not src.failed:
                    linger_src = src
        # preference: progress-bearing landed checkpoint > linger copy >
        # progress-free checkpoint > cold
        if ck is not None and (ck.completed > 0 or linger_src is None):
            target = self._pick(prog, now)
            # RT-class restores outrank everything the planner schedules
            urgency = (
                URGENCY_RT
                if slo_class_of(getattr(rec, "meta", None), prog) == "rt"
                else URGENCY_RESTORE
            )
            plan = self.topology.plan_restore(
                target.name, ck.nbytes, now, urgency=urgency, task_id=tid
            )
            if plan is not None:
                self._journal(
                    "recovery",
                    now,
                    tid,
                    tier="checkpoint",
                    src=origin,
                    dst=target.name,
                    completed=ck.completed,
                    arrival_us=plan.arrival_us,
                )
                if self.fabric is not None:
                    # any surviving linger copy predates the checkpoint's
                    # host-side state — dead once we restore from host
                    self.fabric.release(tid)
                cont = (
                    ResumedTask(prog, ck.completed)
                    if ck.completed > 0
                    else prog
                )
                target.inject(
                    TaskArrival(
                        plan.arrival_us,
                        cont,
                        meta={
                            "migrated_from": origin,
                            "recovered_from": origin,
                            "recovery": "checkpoint",
                        },
                    ),
                    warm_runs=ck.runs,
                )
                self._log_recovery(
                    RecoveryEvent(
                        now, tid, "checkpoint", origin, target.name,
                        ck.completed, completed - ck.completed,
                        plan.arrival_us,
                    )
                )
                return
            if linger_src is None and attempt < self.max_recovery_retries:
                # staging saturated and no warmer fallback: back off
                # (capped exponential) and retry the restore
                due = now + min(
                    self.backoff_us * (2.0 ** attempt), self.backoff_cap_us
                )
                self._journal(
                    "requeue",
                    now,
                    tid,
                    prog=prog,
                    completed=completed,
                    rec=rec,
                    origin=origin,
                    attempt=attempt + 1,
                    due_us=due,
                )
                heapq.heappush(
                    self._retryq,
                    (due, self._seq, (prog, completed, rec, origin, attempt + 1)),
                )
                self._seq += 1
                self._log_recovery(
                    RecoveryEvent(
                        now, tid, "requeue", origin, "", 0, 0, due
                    )
                )
                return
            # else fall through to linger/cold
        if linger_src is not None:
            # the linger copy is exactly the continuation's iteration-0
            # working set: re-place prog on its holder, warm and instant
            # (the harvest path drops the pages from the pool and clears
            # the linger bookkeeping; admission re-owns them)
            warm = self.fabric.harvest(tid)
            if warm is not None:
                self._journal(
                    "recovery",
                    now,
                    tid,
                    tier="linger",
                    src=origin,
                    dst=linger_src.name,
                    completed=0,
                    arrival_us=now,
                )
                linger_src.inject(
                    TaskArrival(
                        now,
                        prog,
                        meta={
                            "migrated_from": origin,
                            "recovered_from": origin,
                            "recovery": "linger",
                        },
                    ),
                    warm_runs=warm,
                )
                self._log_recovery(
                    RecoveryEvent(
                        now, tid, "linger", origin, linger_src.name,
                        0, completed, now,
                    )
                )
                return
        # cold restart: the backing store serves everything on demand
        if self.fabric is not None:
            self.fabric.release(tid)
        target = self._pick(prog, now)
        self._journal(
            "recovery",
            now,
            tid,
            tier="cold",
            src=origin,
            dst=target.name,
            completed=0,
            arrival_us=now,
        )
        target.inject(
            TaskArrival(
                now,
                prog,
                meta={
                    "migrated_from": origin,
                    "recovered_from": origin,
                    "recovery": "cold",
                },
            )
        )
        self._log_recovery(
            RecoveryEvent(
                now, tid, "cold", origin, target.name, 0, completed, now
            )
        )

    def _pick(self, prog, now: float) -> SimCore:
        alive = [c for c in self.cores if not c.failed]
        idx = self.placement.place(prog, now, alive)
        return alive[idx]

    def _redispatch(
        self,
        ev: TaskArrival,
        rec: Optional[RequestRecord],
        warm: Optional[List[PageRun]],
        now: float,
        origin: str,
    ) -> None:
        """Re-place a queued/pending candidate surrendered by a failing
        core. Its warm working set (if any) sits in host DRAM and survives;
        landing it on the new target is a real H2D restore, priced (and
        budget-gated) by ``plan_restore`` — a denied restore drops the warm
        copy (the pages fault back in on demand instead).

        The recovery mode governs which surviving copies re-land warm:
        ``"cold"`` is a true cold-restart baseline (peer linger copies are
        reclaimed and the surrendered warm runs dropped — every page faults
        back in from the backing store); ``"checkpoint"`` restores from
        host-side sources only (warm runs survive, peer copies are
        released); ``"auto"``/``"linger"`` retarget or harvest the linger
        copy like the rebalancer would."""
        alive = [c for c in self.cores if not c.failed]
        if not alive or self._ctl_down():
            self._journal(
                "hold", now, ev.program.task_id, ev=ev, warm=warm, rec=rec
            )
            self._held.append((ev, warm, rec))
            return
        idx = self.placement.place(ev.program, now, alive)
        target = alive[idx]
        tid = ev.program.task_id
        self._journal("place", now, tid, gpu=target.name, origin=origin)
        if self.recovery == "cold":
            if self.fabric is not None:
                self.fabric.release(tid)
            warm = None
        elif self.recovery == "checkpoint":
            if self.fabric is not None:
                self.fabric.release(tid)
        else:
            warm = self._retarget_linger(tid, target.name, warm)
        arrival = max(now, ev.time_us)
        if warm:
            nbytes = run_page_count(warm) * target.page_size
            urgency = (
                URGENCY_RT
                if slo_class_of(ev.meta, ev.program) == "rt"
                else URGENCY_RESTORE
            )
            plan = self.topology.plan_restore(
                target.name, nbytes, now,
                urgency=urgency, task_id=ev.program.task_id,
            )
            if plan is None:
                warm = None
            else:
                arrival = max(arrival, plan.arrival_us)
        target.inject(
            TaskArrival(
                arrival, ev.program, meta=dict(ev.meta, redispatched_from=origin)
            ),
            warm_runs=warm,
        )

    def _retarget_linger(self, tid: int, dst_name: str, warm):
        """Mirror of the rebalancer's linger retargeting for the recovery
        path: keep the directory entry only when the new target can still
        peer-fetch it; otherwise harvest the copy into the warm runs that
        travel with the task."""
        if self.fabric is None:
            return warm
        entry = self.fabric.directory.get(tid)
        if entry is None:
            return warm
        src = self._by_name.get(entry.src)
        if src is None or src.failed:
            self.fabric.directory.forget(tid)
            return warm
        if (
            entry.src != dst_name
            and self.topology.nvlink_peer(entry.src, dst_name) is not None
        ):
            self.fabric.directory.retarget(tid, dst_name)
            return warm
        harvested = self.fabric.harvest(tid)
        if harvested:
            warm = list(warm or []) + harvested
        return warm

    def _flush(self, now: float) -> None:
        """A device came back: held arrivals and stranded victims get
        another shot at placement. Flushing is coordinator work — while the
        coordinator is down the queues keep accumulating, and the control
        plane flushes them itself at ``coordinator_recover``."""
        if self._ctl_down():
            return
        held, self._held = self._held, []
        for ev, warm, rec in held:
            self._journal("release", now, ev.program.task_id, of="hold")
            self._redispatch(ev, rec, warm, now, "held")
        stranded, self._stranded = self._stranded, []
        for prog, completed, rec, origin in stranded:
            self._journal("release", now, prog.task_id, of="strand")
            self._recover(prog, completed, rec, origin, now)

    # -- coordinator-crash queue semantics ------------------------------------
    def wipe_queues(self) -> None:
        """Coordinator crash under journal recovery: the in-memory queues
        die with the coordinator, but their unreleased journal records are
        the durable copy — replay re-parks every item at recovery."""
        self._held.clear()
        self._stranded.clear()
        self._retryq.clear()

    def drop_queues(self, now: float, reason: str) -> List[RequestRecord]:
        """Coordinator crash under cold recovery: parked work is lost
        outright (the restarted coordinator has no record of victims not
        resident on any core). Marks/synthesizes rejected records exactly
        like end-of-run drain and returns the synthesized ones."""
        if self.control is not None:
            for ev, _warm, _rec in self._held:
                self._journal(
                    "release", now, ev.program.task_id, of="hold", why=reason
                )
            for prog, _c, _rec, _o in self._stranded:
                self._journal(
                    "release", now, prog.task_id, of="strand", why=reason
                )
            for _due, _seq, (prog, _c, _rec, _o, _a) in self._retryq:
                self._journal(
                    "release", now, prog.task_id, of="requeue", why=reason
                )
        return self._drop_parked(reason)

    # -- graceful degradation -------------------------------------------------
    def _klass(self, ev: TaskArrival) -> str:
        return slo_class_of(ev.meta, ev.program)

    def _core_demand(self, core: SimCore) -> Tuple[int, int]:
        st = core.state_view()
        return (
            active_demand_pages(st, core.quantum) + st.waiting_pages,
            st.pool.capacity,
        )

    def fleet_pressure(self) -> float:
        demand = 0
        cap = 0
        for core in self.cores:
            if core.failed:
                continue
            d, c = self._core_demand(core)
            demand += d
            cap += c
        return demand / max(1, cap)

    def _shed_pressure(self, now: float) -> None:
        if self._ctl_down():
            return  # shedding is a coordinator decision
        self._shed_class(now, frozenset(("be",)), self.shed_threshold)
        self._shed_class(now, None, self.shed_rt_threshold)

    def _shed_class(
        self, now: float, classes: Optional[frozenset], threshold: Optional[float]
    ) -> None:
        if threshold is None:
            return
        while self.fleet_pressure() > threshold:
            by_pressure = sorted(
                (c for c in self.cores if not c.failed),
                key=lambda c: -(
                    self._core_demand(c)[0] / max(1, c.pool.capacity)
                ),
            )
            shed = None
            for core in by_pressure:
                out = core.shed_one_waiting(
                    lambda ev: classes is None or self._klass(ev) in classes
                )
                if out is not None:
                    shed = (core, out)
                    break
            if shed is None:
                return
            core, (ev, _rec) = shed
            tid = ev.program.task_id
            if self.fabric is not None:
                self.fabric.release(tid)
            self.shed_events.append((now, tid, self._klass(ev), core.name))

    # -- end-of-run accounting -------------------------------------------------
    def live_extra(self) -> Set[int]:
        """Task ids the runtime still holds outside any core (protects
        their checkpoints from pruning)."""
        tids: Set[int] = set()
        tids.update(ev.program.task_id for ev, _w, _r in self._held)
        tids.update(p.task_id for p, _c, _r, _o in self._stranded)
        tids.update(v[0].task_id for _d, _s, v in self._retryq)
        return tids

    def drain_lost(self) -> List[RequestRecord]:
        """End of run: anything still held/stranded (the fleet never came
        back) is accounted as rejected — never silently dropped. Returns
        records synthesized for work that has no fragment anywhere."""
        return self._drop_parked(
            "no_alive_gpu", retry_reason="restore_backoff_unresolved"
        )

    def _drop_parked(
        self, reason: str, retry_reason: Optional[str] = None
    ) -> List[RequestRecord]:
        self.lost += (
            len(self._held) + len(self._stranded) + len(self._retryq)
        )
        synthesized: List[RequestRecord] = []
        for ev, _warm, rec in self._held:
            if rec is not None:
                rec.rejected = True
                rec.meta["lost"] = reason
            else:
                synthesized.append(
                    RequestRecord(
                        ev.program.task_id,
                        ev.time_us,
                        rejected=True,
                        meta=dict(ev.meta, lost=reason),
                    )
                )
        for prog, completed, rec, origin in self._stranded:
            if rec is not None:
                rec.rejected = True
                rec.meta["lost"] = reason
            else:
                synthesized.append(
                    RequestRecord(
                        prog.task_id,
                        0.0,
                        rejected=True,
                        iterations_done=completed,
                        meta={"lost": reason, "origin": origin},
                    )
                )
        # a retry heap drained past the horizon behaves like stranded work
        rr = retry_reason or reason
        for _due, _seq, (prog, completed, rec, _origin, _a) in self._retryq:
            if rec is not None:
                rec.rejected = True
                rec.meta["lost"] = rr
            else:
                synthesized.append(
                    RequestRecord(
                        prog.task_id,
                        0.0,
                        rejected=True,
                        iterations_done=completed,
                        meta={"lost": rr},
                    )
                )
        self._held.clear()
        self._stranded.clear()
        self._retryq.clear()
        return synthesized
