"""Discrete-event execution engine for multitasking under oversubscription.

Runs a set of ``TaskProgram``s under a scheduling policy with one of four
memory backends:

  um      — native demand paging (CUDA UM model; §2.3)
  msched  — proactive memory scheduling: extended context switch with
            timeline-driven OPT placement + pipelined migration (§4–§6)
  ideal   — theoretical optimum: ground-truth working sets, zero control
            plane, full-duplex-cap migration, strict Belady (paper's *Ideal*)
  suv     — single-task static-prefetch baseline (SUV, §7.5): prefetches the
            whole task footprint on switch, oblivious to other tasks

The engine models *early execution* (§6.3): a kernel starts as soon as its own
pages are ready, not when the whole working-set migration finishes.

Execution is *run-native* end to end: commands carry cached page-run tuples,
residency/ready queries are interval operations, and once a timeslice's
migration has landed the engine *macro-steps* — it verifies the upcoming
command window's merged run group is fully resident once, then advances the
whole window in a tight loop with no per-command backend calls (bit-for-bit
identical results; see EXPERIMENTS.md "The macro-stepping invariant").
``pool="paged"`` swaps in the per-page reference pool for equivalence runs.

The task population is *dynamic*: besides the static ``programs`` set, callers
may supply ``task_events`` — timed :class:`TaskArrival`s whose programs are
admitted (optionally gated by an admission controller), run to completion
(``TaskProgram.total_iterations``), and then retire, tearing down their
address space and returning their HBM pages. With no events configured the
engine is bit-for-bit identical to the static simulator.

The engine itself is the *re-entrant* :class:`SimCore`: ``simulate()`` builds
one core and drives it to the horizon in a single call, while the cluster
scheduler (``repro_torch.cluster``) composes N cores — one per GPU — under one
event loop, advancing each with ``run(until_us, final=False)`` between
cluster events and steering work through the external hooks (``inject`` /
``eject`` / ``steal_waiting``). A 1-GPU cluster therefore reproduces
``simulate()`` bit-for-bit (pinned in tests/cluster/test_cluster_engine.py).

Copied from the JAX package's ``core/simulator.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from itertools import islice
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.commands import Command
from repro_torch.core.demand_paging import DemandPager
from repro_torch.core.hardware import Platform
from repro_torch.core.hbm import HBMPool, make_pool, resident_runs_in
from repro_torch.core.memory_manager import (
    Coordinator,
    TaskHelper,
    predicted_working_set_pages,
)
from repro_torch.core.migration import IndexReadyView, plan_population_runs
from repro_torch.core.pages import AddressSpace, PageRun, clip_runs, pages_to_runs, run_page_count
from repro_torch.core.planner import merged_command_runs
from repro_torch.core.predictor import (
    AllocationPredictor,
    OraclePredictor,
    Predictor,
    TemplatePredictor,
)
from repro_torch.core.profiler import profile_programs
from repro_torch.core.scheduler import Policy, RoundRobinPolicy, SchedTask
from repro_torch.core.templates import analyze_traces
from repro_torch.core.timeline import TaskTimeline
from repro_torch.core.workloads import TaskProgram, footprint_pages

MIN_LOOKAHEAD_ITERS = 2  # async launch window (queued-but-not-executed)


# --------------------------------------------------------------------------
# Backends
# --------------------------------------------------------------------------


class Backend:
    name = "base"
    # True when executing a fully-resident command still mutates LRU state
    # (demand paging touches pages); the macro-stepper must replicate that
    resident_touch = False
    # True when on_switch reads the scheduling timeline (msched/ideal); the
    # engine skips building the multi-entry timeline otherwise — at serving
    # scale (2 ms TSG quanta, hundreds of tasks) that build dominates UM runs
    uses_timeline = False

    def on_switch(self, task_id: int, timeline: TaskTimeline, now: float):
        """Returns (control_us, ready_view | None). The view answers
        ``max_ready(runs)`` — the time the last-arriving page of ``runs``
        lands — in O(runs) instead of a per-page dict probe."""
        return 0.0, None

    def on_command(
        self, cmd: Command, runs: Sequence[PageRun], now: float
    ) -> float:
        return 0.0

    def admit_task(self, prog: TaskProgram) -> Optional[TaskHelper]:
        """Dynamic task arrival: set up per-task backend state. Returns the
        task's helper when the backend uses one (msched/ideal)."""
        return None

    def retire_task(self, task_id: int) -> None:
        """Dynamic task departure: tear down per-task backend state."""

    def faults(self) -> int:
        return 0

    def migrated_pages(self) -> int:
        return 0

    def switch_info(self) -> Optional[Dict[str, float]]:
        """Telemetry probe: what the last ``on_switch`` moved (populated /
        evicted pages, control time, migration duration). ``None`` for
        backends that do no proactive work at a switch (um). Read only when
        a telemetry hub is attached — never on the untraced hot path."""
        return None


class UMBackend(Backend):
    name = "um"
    resident_touch = True

    def __init__(self, platform: Platform, pool: HBMPool, page_size: int = 0):
        self.pager = DemandPager(platform, pool, page_size)

    def on_command(self, cmd, runs, now):
        return self.pager.access_runs(runs)

    def faults(self):
        return self.pager.stats.faults

    def migrated_pages(self):
        return self.pager.stats.migrated_pages


class MSchedBackend(Backend):
    name = "msched"
    uses_timeline = True

    def __init__(
        self,
        platform: Platform,
        pool: HBMPool,
        helpers: Dict[int, TaskHelper],
        pipelined: bool = True,
        control_free: bool = False,
        page_size: int = 0,
        legacy_planning: bool = False,
        predictor_factory: Optional[Callable[[TaskProgram], Predictor]] = None,
    ):
        self.platform = platform
        self.pool = pool
        self.page_size = page_size or platform.page_size
        self.coordinator = Coordinator(
            platform, pool, pipelined=pipelined, page_size=page_size,
            legacy=legacy_planning,
        )
        for h in helpers.values():
            self.coordinator.register(h)
        self.fallback = DemandPager(platform, pool, page_size)  # false negatives
        self.control_free = control_free
        self.predictor_factory = predictor_factory
        self._migrated = 0
        self.last_report = None  # latest SwitchReport, for switch_info()

    def admit_task(self, prog):
        if self.predictor_factory is None:
            raise RuntimeError("backend built without a predictor factory")
        helper = TaskHelper(prog.task_id, prog.space, self.predictor_factory(prog))
        self.coordinator.register(helper)
        return helper

    def retire_task(self, task_id):
        self.coordinator.unregister(task_id)

    def on_switch(self, task_id, timeline, now):
        report = self.coordinator.on_context_switch(task_id, timeline, now)
        self.last_report = report
        self._migrated += report.populated_pages
        ctrl = 0.0 if self.control_free else report.madvise_us
        return ctrl, report.migration.ready_view(now + ctrl)

    def switch_info(self):
        rep = self.last_report
        if rep is None:
            return None
        return {
            "populated_pages": rep.populated_pages,
            "evicted_pages": rep.evicted_pages,
            "madvise_us": rep.madvise_us,
            "migration_us": rep.migration.total_us,
        }

    def on_command(self, cmd, runs, now):
        # mispredictions fall back to standard demand paging (§5.2)
        missing = self.pool.missing_runs(runs)
        if not missing:
            return 0.0
        return self.fallback.access_runs(missing)

    def faults(self):
        return self.fallback.stats.faults

    def migrated_pages(self):
        return self._migrated + self.fallback.stats.migrated_pages


class IdealBackend(MSchedBackend):
    """Strict-OPT upper bound: oracle prediction, no control plane, and
    migration at the duplex bandwidth ceiling."""

    name = "ideal"

    def on_switch(self, task_id, timeline, now):
        report = self.coordinator.on_context_switch(task_id, timeline, now)
        self.last_report = report
        self._migrated += report.populated_pages
        # population at the physically best per-direction rate: the duplex
        # ceiling is shared by concurrent eviction (swap = cap/2 each way,
        # matching the paper's 63.5 GB/s pipelined swap figure)
        rate = min(
            self.platform.h2d_gbps * 1e3, self.platform.duplex_cap_gbps * 1e3 / 2
        )
        ps = self.page_size
        runs = report.migration.populated_runs
        n = run_page_count(runs)
        if n == 0:
            return 0.0, None
        return 0.0, IndexReadyView(
            runs, lambda i: now + ((i + 1) * ps) / rate, n
        )


def _task_footprint_runs(prog: "TaskProgram") -> List[PageRun]:
    """Whole-footprint page runs in buffer (base) order — the SUV prefetch
    order and the warm-start fill order."""
    runs: List[PageRun] = []
    for b in sorted(prog.space.buffers.values(), key=lambda b: b.base):
        pages = prog.space.pages_of_extent((b.base, b.size))
        if not len(pages):
            continue
        s, e = pages.start, pages.stop
        if runs and runs[-1][1] == s:
            runs[-1] = (runs[-1][0], e)
        else:
            runs.append((s, e))
    return runs


class SUVBackend(Backend):
    """Static-analysis single-task prefetch: on switch, prefetch the whole
    footprint of the incoming task (hotness-ordered = buffer order), with no
    awareness of the other tasks' residency or of the schedule."""

    name = "suv"

    def __init__(self, platform: Platform, pool: HBMPool, programs, page_size: int = 0):
        self.platform = platform
        self.pool = pool
        self.page_size = page_size or platform.page_size
        self.pager = DemandPager(platform, pool, page_size)
        self._task_runs: Dict[int, List[PageRun]] = {}
        for prog in programs:
            self.admit_task(prog)
        self._migrated = 0
        self.last_switch = None  # (populated, evicted) pages, telemetry

    def admit_task(self, prog):
        self._task_runs[prog.task_id] = _task_footprint_runs(prog)
        return None

    def retire_task(self, task_id):
        self._task_runs.pop(task_id, None)

    def on_switch(self, task_id, timeline, now):
        runs = self._task_runs.get(task_id, [])
        # cap the prefetch at HBM capacity (driver clamps)
        runs = clip_runs(runs, self.pool.capacity)
        populated, evicted = self.pool.migrate_runs(runs)
        npop = run_page_count(populated)
        nev = run_page_count(evicted)
        self._migrated += npop
        self.last_switch = (npop, nev)
        mig = plan_population_runs(
            self.platform, populated, nev, False, self.page_size,
        )
        return 0.0, mig.ready_view(now)

    def switch_info(self):
        if self.last_switch is None:
            return None
        npop, nev = self.last_switch
        return {
            "populated_pages": npop,
            "evicted_pages": nev,
            "madvise_us": 0.0,
            "migration_us": 0.0,
        }

    def on_command(self, cmd, runs, now):
        missing = self.pool.missing_runs(runs)
        return self.pager.access_runs(missing) if missing else 0.0

    def faults(self):
        return self.pager.stats.faults

    def migrated_pages(self):
        return self._migrated + self.pager.stats.migrated_pages


# --------------------------------------------------------------------------
# Dynamic task lifecycle
# --------------------------------------------------------------------------


@dataclasses.dataclass
class TaskArrival:
    """A timed task-arrival event: ``program`` joins the task population at
    ``time_us`` (subject to admission control) and retires after
    ``program.total_iterations`` completed iterations."""

    time_us: float
    program: TaskProgram
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class RequestRecord:
    """Lifecycle timestamps of one dynamically-arrived task (one request in
    the serving regime); the raw material for SLO metrics."""

    task_id: int
    arrival_us: float
    admitted_us: Optional[float] = None
    first_iter_us: Optional[float] = None  # end of first completed iteration
    finished_us: Optional[float] = None
    iterations_done: int = 0
    total_iterations: Optional[int] = None
    rejected: bool = False
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def ttft_us(self) -> Optional[float]:
        """Time-to-first-token: arrival → end of the first iteration (the
        prefill + first decode step in the serving lifecycle)."""
        if self.first_iter_us is None:
            return None
        return self.first_iter_us - self.arrival_us

    def tpot_us(self) -> Optional[float]:
        """Time-per-output-token over the decode phase (post first token)."""
        if (
            self.finished_us is None
            or self.first_iter_us is None
            or not self.total_iterations
            or self.total_iterations < 2
        ):
            return None
        return (self.finished_us - self.first_iter_us) / (self.total_iterations - 1)

    def latency_us(self) -> Optional[float]:
        if self.finished_us is None:
            return None
        return self.finished_us - self.arrival_us

    def meets_slo(
        self,
        ttft_slo_us: Optional[float] = None,
        tpot_slo_us: Optional[float] = None,
    ) -> bool:
        if self.finished_us is None:
            return False
        if ttft_slo_us is not None:
            ttft = self.ttft_us()
            if ttft is None or ttft > ttft_slo_us:
                return False
        if (
            tpot_slo_us is not None
            and self.total_iterations is not None
            and self.total_iterations >= 2
        ):
            # single-token requests have no decode phase: TPOT is undefined
            # and cannot be violated
            tpot = self.tpot_us()
            if tpot is None or tpot > tpot_slo_us:
                return False
        return True


class AdmissionController:
    """Decides what happens when a dynamic task arrives (or is re-evaluated
    from the wait queue): ``"admit"``, ``"queue"``, or ``"reject"``.

    ``state`` is the live :class:`SimState` view — pool occupancy, active
    helpers (predicted working sets), the scheduling policy, and the clock —
    so controllers can be MSched-aware without owning simulator internals.
    """

    def decide(
        self, prog: TaskProgram, arrival_us: float, state: "SimState"
    ) -> str:
        return "admit"


@dataclasses.dataclass
class SimState:
    """Read-only view handed to admission controllers (and, via
    :meth:`SimCore.state_view`, to cluster placement policies)."""

    now: float
    platform: Platform
    pool: HBMPool
    policy: "Policy"
    page_size: int
    active: Dict[int, TaskProgram]
    helpers: Dict[int, TaskHelper]
    waiting: int  # queued-but-not-admitted candidates (FIFO ahead included)
    waiting_pages: int = 0  # summed whole-footprint pages of that queue


def active_demand_pages(state: SimState, quantum_us: float) -> int:
    """Per-schedule-cycle HBM demand of the admitted population: every active
    task runs once per round-robin cycle, so the cycle demand is the sum of
    the predicted per-quantum working sets — the whole footprint for tasks
    without a helper (UM-style backends) or with an empty future (the
    conservative bound). Shared by admission control and cluster placement."""
    total = 0
    for tid, prog in state.active.items():
        helper = state.helpers.get(tid)
        if helper is not None and len(helper):
            total += predicted_working_set_pages(helper, quantum_us)
        else:
            total += footprint_pages(prog, state.page_size)
    return total


@dataclasses.dataclass
class EjectedTask:
    """A task forcibly removed mid-run for inter-GPU migration: the program
    (address space intact — *not* released), its completed-iteration count,
    and the working set that was resident when it was ejected. The cluster
    checkpoints the working set, prices the transfer on the link graph, and
    re-injects a continuation on the target GPU."""

    program: TaskProgram
    completed: int
    resident_runs: List[PageRun]
    record: Optional[RequestRecord]

    def working_set_pages(self) -> int:
        return run_page_count(self.resident_runs)


@dataclasses.dataclass
class FailedTask:
    """One running task lost to a device failure: the program (address space
    intact — the backing data model lives in host DRAM, only the HBM cache
    and execution state are gone), the iterations it had completed on this
    visit, and its record fragment. The cluster re-places it from its newest
    durable source (checkpoint > lingering peer copy > cold restart)."""

    program: TaskProgram
    completed: int
    record: Optional[RequestRecord]


@dataclasses.dataclass
class FailureReport:
    """Everything a failing core surrenders to the cluster: running tasks
    (with their progress), queued-but-unadmitted candidates and not-yet-due
    arrivals (both with any pending warm runs — those sit in host DRAM and
    survive the device), and the page count the HBM wipe released."""

    time_us: float
    running: List[FailedTask]
    waiting: List[Tuple[TaskArrival, RequestRecord, Optional[List[PageRun]]]]
    pending: List[Tuple[TaskArrival, Optional[List[PageRun]]]]
    lost_pages: int


# --------------------------------------------------------------------------
# Engine
# --------------------------------------------------------------------------


def percentile(sorted_xs: Sequence[float], pct: float) -> float:
    """The repo-wide percentile convention: nearest-rank over an
    already-sorted sample, index = floor(pct/100 * n) clamped to the last
    element. ``SimResult``, the cluster aggregation layer, and every
    benchmark scoreboard delegate here, so the convention cannot drift
    between per-run and fleet-level metrics (a 1-GPU fleet's merged
    percentiles must equal the single-core run's — pinned in
    ``tests/cluster/test_telemetry_cluster.py``)."""
    assert 0.0 <= pct <= 100.0, f"percentile out of range: {pct}"
    if not sorted_xs:
        return 0.0
    assert sorted_xs[0] <= sorted_xs[-1], "percentile() wants a sorted sample"
    return sorted_xs[min(len(sorted_xs) - 1, int(pct / 100.0 * len(sorted_xs)))]


@dataclasses.dataclass
class TaskStats:
    completions: int = 0
    commands: int = 0
    busy_us: float = 0.0
    latencies_us: List[float] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SimResult:
    sim_us: float
    per_task: Dict[int, TaskStats]
    faults: int
    migrated_bytes: int
    switches: int
    control_us: float
    # dynamic-lifecycle records (empty for static simulations)
    requests: List[RequestRecord] = dataclasses.field(default_factory=list)
    # end-of-run HBM occupancy / reclamation (leak accounting)
    hbm_used_pages: int = 0
    hbm_freed_pages: int = 0

    def total_completions(self) -> int:
        return sum(t.completions for t in self.per_task.values())

    # -- serving / SLO metrics ----------------------------------------------
    # percentile convention: index = floor(pct/100 * n), clamped (see
    # module-level :func:`percentile` — the single implementation every
    # aggregation layer shares)
    def finished_requests(self) -> List[RequestRecord]:
        return [r for r in self.requests if r.finished_us is not None]

    def request_metric_us(self, metric: str) -> List[float]:
        """Per-request metric samples: ``ttft`` | ``tpot`` | ``latency``."""
        fn = {
            "ttft": RequestRecord.ttft_us,
            "tpot": RequestRecord.tpot_us,
            "latency": RequestRecord.latency_us,
        }[metric]
        return [v for r in self.requests if (v := fn(r)) is not None]

    def request_percentile_us(self, metric: str, pct: float) -> float:
        return percentile(sorted(self.request_metric_us(metric)), pct)

    def goodput_per_s(
        self,
        ttft_slo_us: Optional[float] = None,
        tpot_slo_us: Optional[float] = None,
        window_us: Optional[float] = None,
    ) -> float:
        """Completed requests per second that met every given SLO.

        ``window_us`` defaults to this run's makespan; cross-run comparisons
        (e.g. UM vs MSched on the same trace) must pass a *common* window, or
        the ratio conflates SLO attainment with drain speed.
        """
        window = window_us if window_us is not None else self.sim_us
        if not window:
            return 0.0
        good = sum(
            1 for r in self.requests if r.meets_slo(ttft_slo_us, tpot_slo_us)
        )
        return good / (window * 1e-6)

    def throughput_per_s(self) -> float:
        return self.total_completions() / (self.sim_us * 1e-6) if self.sim_us else 0.0

    def latency_percentile_us(
        self, pct: float, task_id: Optional[int] = None
    ) -> float:
        """Request-latency percentile over one task's (or all tasks')
        recorded arrival-to-completion latencies."""
        if task_id is not None:
            xs = sorted(self.per_task[task_id].latencies_us)
        else:
            xs = sorted(
                x for t in self.per_task.values() for x in t.latencies_us
            )
        return percentile(xs, pct)

    def p50_latency_us(self, task_id: Optional[int] = None) -> float:
        return self.latency_percentile_us(50.0, task_id)

    def p99_latency_us(self, task_id: Optional[int] = None) -> float:
        return self.latency_percentile_us(99.0, task_id)


class _RunTask:
    def __init__(
        self,
        prog: TaskProgram,
        helper: Optional[TaskHelper],
        lookahead_us: float = 0.0,
    ):
        self.prog = prog
        self.helper = helper
        self.lookahead_us = lookahead_us
        self.queue: Deque[Command] = deque()
        self.queued_us = 0.0
        self.iter_launched = 0
        self.cmd_in_iter = 0
        self.iter_len = 1
        self.total_iterations: Optional[int] = getattr(
            prog, "total_iterations", None
        )
        self.arrivals: Optional[Deque[float]] = None  # RT mode
        self.current_arrival: Optional[float] = None
        self.stats = TaskStats()
        self._refill()

    def _exhausted(self) -> bool:
        """Finite program with every iteration already launched."""
        return (
            self.total_iterations is not None
            and self.iter_launched >= self.total_iterations
        )

    def finished(self) -> bool:
        """Finite program with every iteration completed — retire the task."""
        return (
            self.total_iterations is not None
            and self.stats.completions >= self.total_iterations
        )

    def _launch_iter(self):
        cmds = self.prog.iteration(self.iter_launched)
        self.iter_len = len(cmds)
        for c in cmds:
            c.seq_no = self.iter_launched
            self.queue.append(c)
            self.queued_us += c.latency_us
            if self.helper is not None:
                self.helper.launch(c)
        self.iter_launched += 1

    def _refill(self):
        # the async launch window must cover at least one full timeslice of
        # future commands for the timeline plan to see the whole working set
        launched_iters = 0
        while (
            launched_iters < MIN_LOOKAHEAD_ITERS
            or self.queued_us < self.lookahead_us
        ):
            if self._exhausted():
                break
            self._launch_iter()
            launched_iters += 1
            if launched_iters > 10_000:
                break

    def peek(self) -> Command:
        return self.queue[0]

    def advance(self, now: float) -> bool:
        """Consume one command; returns True when an iteration completed."""
        cmd = self.queue.popleft()
        self.queued_us -= cmd.latency_us
        if self.helper is not None and len(self.helper.queue):
            self.helper.pop()
        self.cmd_in_iter += 1
        done = False
        if self.cmd_in_iter >= self.iter_len:
            self.cmd_in_iter = 0
            self.stats.completions += 1
            done = True
        if not self._exhausted() and (
            len(self.queue) < self.iter_len or self.queued_us < self.lookahead_us
        ):
            self._launch_iter()
        return done

    def runnable(self, now: float) -> bool:
        if self.arrivals is None:
            return True
        if self.current_arrival is not None:
            return True
        while self.arrivals and self.arrivals[0] <= now:
            self.current_arrival = self.arrivals.popleft()
            return True
        return False

    def next_arrival(self) -> Optional[float]:
        if self.arrivals is None or self.current_arrival is not None:
            return None
        return self.arrivals[0] if self.arrivals else None


def make_backend(
    name: str,
    platform: Platform,
    pool: HBMPool,
    programs: Sequence[TaskProgram],
    predictor_kind: str = "template",
    pipelined: bool = True,
    page_size: int = 0,
    planning: str = "incremental",
    profile_set: Optional[Sequence[TaskProgram]] = None,
) -> Tuple[Backend, Dict[int, TaskHelper]]:
    """``profile_set`` overrides the programs used for offline template
    analysis — dynamic scenarios profile representative programs up front and
    admit instances of the same kernels later."""
    helpers: Dict[int, TaskHelper] = {}
    if name == "um":
        return UMBackend(platform, pool, page_size), helpers
    if name == "suv":
        return SUVBackend(platform, pool, programs, page_size), helpers

    # msched / ideal need per-task helpers with a predictor; the factory is
    # kept on the backend so dynamically admitted tasks get the same kind
    if name == "ideal" or predictor_kind == "oracle":
        factory: Callable[[TaskProgram], Predictor] = lambda p: OraclePredictor()
    elif predictor_kind == "allocation":
        factory = lambda p: AllocationPredictor(p.space)
    else:  # template: offline profile + analyze (the real MSched flow)
        store = profile_programs(list(profile_set or programs), iters=4)
        descriptors = analyze_traces(store)
        factory = lambda p: TemplatePredictor(descriptors)
    for p in programs:
        helpers[p.task_id] = TaskHelper(p.task_id, p.space, factory(p))
    cls = IdealBackend if name == "ideal" else MSchedBackend
    backend = cls(
        platform, pool, helpers, pipelined=pipelined, page_size=page_size,
        legacy_planning=(planning == "legacy"),
        predictor_factory=factory,
    )
    return backend, helpers


class SimCore:
    """Re-entrant single-GPU simulation core.

    Construction performs everything ``simulate()`` used to do before its
    event loop (pool/backend/helper setup, warm start, degenerate-task purge);
    :meth:`run` advances the clock. The classic entrypoint drives one core to
    the horizon in a single ``run(sim_us, final=True)`` call; the cluster
    scheduler interleaves ``run(T, final=False)`` calls with the external
    hooks:

      * :meth:`inject` — enqueue a future :class:`TaskArrival` (placement
        dispatches trace requests to the chosen GPU), optionally with
        ``warm_runs`` — the migrated working set that lands in HBM with the
        task (checkpoint restore);
      * :meth:`eject` — remove an admitted task mid-run *without* retiring it,
        returning its program and resident working set for migration;
      * :meth:`steal_waiting` — pop the newest queued-but-unadmitted
        candidate for rerouting to another GPU (nothing resident: free);
      * :meth:`state_view` — the same read-only :class:`SimState` admission
        controllers get, for load-aware placement.

    ``final=False`` clamps idle clock jumps to ``until_us`` and never
    force-admits a starved wait queue, so events injected at or after the
    horizon are always observed in time; the single terminal
    ``run(horizon, final=True)`` restores ``simulate()``'s end-of-run
    semantics exactly, which is what makes a 1-GPU cluster bit-for-bit
    identical to ``simulate()``.
    """

    def __init__(
        self,
        programs: Sequence[TaskProgram],
        platform: Platform,
        backend_name: str = "msched",
        capacity_bytes: Optional[int] = None,
        policy: Optional[Policy] = None,
        predictor_kind: str = "template",
        pipelined: bool = True,
        arrivals: Optional[Dict[int, List[float]]] = None,
        priorities: Optional[Dict[int, int]] = None,
        prepopulate: bool = True,
        planning: str = "incremental",
        task_events: Optional[Sequence[TaskArrival]] = None,
        admission: Optional[AdmissionController] = None,
        profile_set: Optional[Sequence[TaskProgram]] = None,
        page_size: int = 0,
        pool: str = "run",
        dynamic: Optional[bool] = None,
        name: str = "gpu0",
        telemetry=None,
    ):
        programs = list(programs)
        if not page_size:
            if programs:
                page_size = programs[0].space.page_size
            elif task_events:
                page_size = task_events[0].program.space.page_size
            else:
                page_size = 4096
        all_progs = programs + [ev.program for ev in task_events or ()]
        for prog in all_progs:
            if prog.space.page_size != page_size:
                raise ValueError(
                    f"task {prog.task_id} uses page_size "
                    f"{prog.space.page_size}, simulation uses {page_size}; "
                    "pool residency keys would not be comparable"
                )
        cap_bytes = capacity_bytes or platform.hbm_bytes
        self.name = name
        self.platform = platform
        self.page_size = page_size
        self.pool = make_pool(pool, max(1, cap_bytes // page_size))
        self.backend, self.helpers = make_backend(
            backend_name, platform, self.pool, programs, predictor_kind,
            pipelined, page_size, planning, profile_set,
        )
        self.cached_decode = planning != "legacy"
        self.policy = policy or RoundRobinPolicy()
        self.admission = admission
        self.priorities = priorities
        self.quantum = getattr(self.policy, "quantum_us", 5_000.0)

        self.tasks: Dict[int, _RunTask] = {}
        for prog in programs:
            rt = _RunTask(
                prog, self.helpers.get(prog.task_id),
                lookahead_us=2.2 * self.quantum,
            )
            if arrivals and prog.task_id in arrivals:
                rt.arrivals = deque(arrivals[prog.task_id])
                rt.current_arrival = None
            self.tasks[prog.task_id] = rt
            self.pool.register_task(prog.task_id, prog.space.page_span())

        # warm start: fill HBM fairly (tasks ran before the measuring window).
        # migrate_runs over a fresh pool appends the exact page order the old
        # per-page populate loop produced, at O(runs)
        if prepopulate:
            share = self.pool.capacity // max(1, len(programs))
            for prog in programs:
                self.pool.migrate_runs(clip_runs(_task_footprint_runs(prog), share))

        # -- dynamic lifecycle state ----------------------------------------
        self.dynamic = bool(task_events) if dynamic is None else bool(dynamic)
        self.pending: Deque[TaskArrival] = deque(
            sorted(task_events or [], key=lambda e: e.time_us)
        )
        self.waiting: Deque[Tuple[TaskArrival, RequestRecord, int]] = deque()
        self._waiting_pages = 0
        self.records: List[RequestRecord] = []
        self.rec_by_tid: Dict[int, RequestRecord] = {}
        self.retired_stats: Dict[int, TaskStats] = {}
        self.used_task_ids = set(self.tasks)  # static ids + every id admitted
        self._warm_runs: Dict[int, List[PageRun]] = {}

        # cluster hook: called with (ev, rec, warm_runs) when the admission
        # controller rejects a queued candidate; returning True means the
        # rejection was handled externally (e.g. the cluster re-routed a
        # migrated continuation back to a GPU with headroom) and the record
        # must NOT be marked rejected. None = single-GPU behavior.
        self.reject_hook: Optional[
            Callable[[TaskArrival, RequestRecord, Optional[List[PageRun]]], bool]
        ] = None
        # tasks ejected with linger=True: their working set stays resident
        # (demoted to the eviction-list head) as a peer-prefetch source until
        # reclaimed by pressure or reclaim_linger()
        self.lingering: set = set()
        # cluster hook: called with (task_id, now) when a task retires, so
        # fleet-level bookkeeping (the peer-prefetch fabric's directory
        # hints) is reaped at finish instead of waiting for the next
        # rebalance tick. None = single-GPU behavior.
        self.finish_hook: Optional[Callable[[int, float], None]] = None
        # control-plane hook: called with (task_id, event, now) at the three
        # data-plane lifecycle boundaries ("admitted", "finished",
        # "rejected") so the cluster control plane can journal them. None =
        # no control plane attached (the default, and the single-GPU case).
        self.lifecycle_hook: Optional[Callable[[int, str, float], None]] = None
        # telemetry hub (repro_torch.telemetry.Telemetry) or None; every emission
        # site is guarded, so the None path is exactly the untraced code
        self.telemetry = telemetry
        self._tel_faults = 0  # backend fault counter at last fault event

        self.t = 0.0
        self.switches = 0
        self.control_us = 0.0
        self.sched_cache: Optional[Dict[int, SchedTask]] = None
        # device-failure state: a failed core refuses work (run() no-ops,
        # inject() raises) until recover()
        self.failed = False

        # purge degenerate zero-iteration static programs before the clock
        # starts
        for tid in [tid for tid, rt in self.tasks.items() if rt.finished()]:
            self._retire(tid, 0.0)

    # -- external hooks (cluster composition) -------------------------------
    def state_view(self) -> SimState:
        return self._state(self.t)

    def inject(
        self, ev: TaskArrival, warm_runs: Optional[Sequence[PageRun]] = None
    ) -> None:
        """Enqueue a future arrival. ``warm_runs`` (a migrated task's
        checkpointed working set) is populated into HBM at admission — the
        restore half of the transfer the cluster already priced."""
        if self.failed:
            raise RuntimeError(
                f"cannot inject into failed core {self.name}; callers must "
                "dispatch to an alive device"
            )
        self.dynamic = True
        if self.pending and ev.time_us < self.pending[-1].time_us:
            self.pending = deque(
                sorted([*self.pending, ev], key=lambda e: e.time_us)
            )
        else:
            self.pending.append(ev)
        if warm_runs:
            self._warm_runs[ev.program.task_id] = list(warm_runs)

    def eject(
        self,
        task_id: int,
        resident_runs: Optional[List[PageRun]] = None,
        linger: bool = False,
    ) -> EjectedTask:
        """Forcibly remove an admitted task for migration: scheduler state,
        helper, and resident pages are torn down on this GPU, but the program
        is *not* released and its record is *not* marked finished. Work of a
        partially-completed iteration is replayed on the target (checkpoints
        are iteration-granular). ``resident_runs`` lets a caller that already
        snapshotted the working set (to price the transfer before committing
        to the move) pass it through instead of recomputing it — it must be
        current, i.e. no pool mutation since the snapshot.

        ``linger=True`` keeps the working set *resident* instead of freeing
        it, demoted to the eviction-list head: the pages cost this GPU
        nothing (they are the first victims under any pressure) but remain a
        peer-prefetch source the migration target can pull over NVLink —
        until local eviction or :meth:`reclaim_linger` takes them."""
        rt = self.tasks.pop(task_id)
        self.sched_cache = None
        self.backend.retire_task(task_id)
        self.helpers.pop(task_id, None)
        # the id may legitimately come back: a rebalanced task can ping-pong
        # onto a GPU it already visited (each visit is its own record
        # fragment; the cluster merge stitches them)
        self.used_task_ids.discard(task_id)
        span = rt.prog.space.page_span()
        resident = (
            resident_runs
            if resident_runs is not None
            else resident_runs_in(self.pool, span)
        )
        self.pool.register_task(task_id, span)  # cover late allocations
        if linger:
            self.pool.demote_runs(resident)
            self.lingering.add(task_id)
        else:
            self.pool.free_task(task_id)
        self._bank_stats(task_id, rt.stats)
        rec = self.rec_by_tid.get(task_id)
        if rec is not None:
            rec.iterations_done = rt.stats.completions
            rec.meta["ejected_us"] = self.t
        return EjectedTask(
            program=rt.prog,
            completed=rt.stats.completions,
            resident_runs=resident,
            record=rec,
        )

    def reclaim_linger(self, task_id: int) -> int:
        """Free whatever remains of a lingered task's working set (the
        cluster calls this when the migrated task finishes elsewhere, is
        re-migrated, or the run ends). A no-op unless the task is actually
        lingering here — a ping-ponged task that was re-admitted owns its
        pages again and must not lose them. Returns pages reclaimed."""
        if task_id not in self.lingering:
            return 0
        self.lingering.discard(task_id)
        return self.pool.free_task(task_id)

    def steal_waiting(
        self,
    ) -> Optional[Tuple[TaskArrival, RequestRecord, Optional[List[PageRun]]]]:
        """Pop the *newest* queued-but-unadmitted candidate (LIFO steal keeps
        FIFO fairness for the queue head) so the cluster can reroute it to a
        less-loaded GPU. Its record stays in this core's log (the cluster
        merge combines it with the target GPU's). The third element is the
        candidate's pending warm working set, if it was itself a migrated
        continuation still waiting for admission — it travels with the
        steal instead of going stale here."""
        if not self.waiting:
            return None
        ev, rec, pages = self.waiting.pop()
        self._waiting_pages -= pages
        rec.meta["rerouted_us"] = self.t
        return ev, rec, self._warm_runs.pop(ev.program.task_id, None)

    def fail(self, now: float) -> FailureReport:
        """Device-failure teardown: every admitted task is torn down (stats
        banked, record fragment stamped ``failed_us``), queued and pending
        candidates are surrendered with their pending warm runs, lingering
        peer copies evaporate with the HBM they lived in, and the pool is
        wiped. The core refuses work until :meth:`recover`. Returns what the
        cluster must re-place or account as lost."""
        if self.failed:
            raise RuntimeError(f"core {self.name} is already failed")
        self.failed = True
        self.sched_cache = None
        self.t = max(self.t, now)
        running: List[FailedTask] = []
        for tid in list(self.tasks):
            rt = self.tasks.pop(tid)
            self.backend.retire_task(tid)
            self.helpers.pop(tid, None)
            # the id comes back when the victim is re-placed (possibly here,
            # after recovery) — same convention as eject()
            self.used_task_ids.discard(tid)
            self._bank_stats(tid, rt.stats)
            rec = self.rec_by_tid.get(tid)
            if rec is not None:
                rec.iterations_done = rt.stats.completions
                rec.meta["failed_us"] = now
            running.append(FailedTask(rt.prog, rt.stats.completions, rec))
        waiting = []
        for ev, rec, _pages in self.waiting:
            rec.meta["failed_us"] = now
            waiting.append(
                (ev, rec, self._warm_runs.pop(ev.program.task_id, None))
            )
        self.waiting.clear()
        self._waiting_pages = 0
        pending = [
            (ev, self._warm_runs.pop(ev.program.task_id, None))
            for ev in self.pending
        ]
        self.pending.clear()
        self._warm_runs.clear()
        self.lingering.clear()
        lost = self.pool.wipe()
        return FailureReport(now, running, waiting, pending, lost)

    def recover(self, now: float) -> None:
        """Bring a failed device back empty-handed: HBM is cold, the queue
        empty — the device simply starts taking work again."""
        if not self.failed:
            return
        self.failed = False
        self.t = max(self.t, now)

    def shed_one_waiting(
        self, pred: Callable[[TaskArrival], bool]
    ) -> Optional[Tuple[TaskArrival, RequestRecord]]:
        """Shed the *newest* queued candidate matching ``pred`` (graceful
        degradation under shrunken fleet capacity; newest-first preserves
        FIFO fairness for the older queue head, mirroring
        :meth:`steal_waiting`). The record is marked rejected and any
        pending warm runs are dropped. Returns the shed (event, record), or
        ``None`` when nothing matches."""
        for i in range(len(self.waiting) - 1, -1, -1):
            ev, rec, pages = self.waiting[i]
            if not pred(ev):
                continue
            del self.waiting[i]
            self._waiting_pages -= pages
            self._warm_runs.pop(ev.program.task_id, None)
            rec.rejected = True
            rec.meta["shed_us"] = self.t
            if self.telemetry is not None:
                self.telemetry.instant(
                    "shed",
                    self.name,
                    self.t,
                    task_id=ev.program.task_id,
                    reason="capacity_shed",
                )
            if self.lifecycle_hook is not None:
                self.lifecycle_hook(ev.program.task_id, "rejected", self.t)
            return ev, rec
        return None

    def cancel_task(self, task_id: int, now: float) -> bool:
        """Operator cancel (control-plane API): remove the task wherever it
        lives on this core — running (ejected, pages freed), queued, or
        pending — and mark its record rejected with a ``cancelled_us``
        stamp. A pending arrival has no record yet, so one is synthesized
        (cancelled work is accounted, never silently dropped). Returns
        True when the task was found here; lifecycle hooks do not fire —
        the caller journals the cancel itself."""
        if task_id in self.tasks:
            ej = self.eject(task_id)
            if ej.record is not None:
                ej.record.rejected = True
                ej.record.meta["cancelled_us"] = now
            return True
        for i, (ev, rec, pages) in enumerate(self.waiting):
            if ev.program.task_id == task_id:
                del self.waiting[i]
                self._waiting_pages -= pages
                self._warm_runs.pop(task_id, None)
                rec.rejected = True
                rec.meta["cancelled_us"] = now
                return True
        for i, ev in enumerate(self.pending):
            if ev.program.task_id == task_id:
                del self.pending[i]
                self._warm_runs.pop(task_id, None)
                rec = RequestRecord(
                    task_id,
                    ev.time_us,
                    rejected=True,
                    meta=dict(ev.meta, cancelled_us=now),
                )
                self.records.append(rec)
                self.rec_by_tid[task_id] = rec
                return True
        return False

    # -- lifecycle internals -------------------------------------------------
    def _state(self, now: float) -> SimState:
        return SimState(
            now=now,
            platform=self.platform,
            pool=self.pool,
            policy=self.policy,
            page_size=self.page_size,
            active={tid: r.prog for tid, r in self.tasks.items()},
            helpers=self.helpers,
            waiting=len(self.waiting),
            waiting_pages=self._waiting_pages,
        )

    def _admit(self, ev: TaskArrival, rec: RequestRecord, now: float) -> None:
        self.sched_cache = None
        prog = ev.program
        if prog.task_id in self.used_task_ids:
            raise ValueError(
                f"TaskArrival task_id {prog.task_id} collides with an "
                "existing task; ids must be unique across programs and events"
            )
        self.used_task_ids.add(prog.task_id)
        # a ping-ponged task returning to a GPU where its old working set
        # still lingers re-owns those pages through the normal span
        # registration below
        self.lingering.discard(prog.task_id)
        helper = self.backend.admit_task(prog)
        if helper is not None:
            self.helpers[prog.task_id] = helper
        rt = _RunTask(prog, helper, lookahead_us=2.2 * self.quantum)
        self.tasks[prog.task_id] = rt
        self.pool.register_task(prog.task_id, prog.space.page_span())
        warm = self._warm_runs.pop(prog.task_id, None)
        if warm:
            self.pool.migrate_runs(clip_runs(warm, self.pool.capacity))
        rec.admitted_us = now
        if self.telemetry is not None:
            self.telemetry.instant(
                "admission",
                self.name,
                now,
                task_id=prog.task_id,
                queued_us=max(0.0, now - ev.time_us),
            )
        if self.lifecycle_hook is not None:
            self.lifecycle_hook(prog.task_id, "admitted", now)
        if rt.finished():
            # degenerate zero-iteration program: it can never produce the
            # completion event that triggers retirement, so retire it here
            self._retire(prog.task_id, now)

    def _bank_stats(self, tid: int, stats: TaskStats) -> None:
        """Accumulate a departing task's stats. A rebalanced task can visit
        this GPU more than once (eject, then ping-pong back); each visit's
        work must add up, not overwrite."""
        cur = self.retired_stats.get(tid)
        if cur is None:
            self.retired_stats[tid] = stats
        else:
            cur.completions += stats.completions
            cur.commands += stats.commands
            cur.busy_us += stats.busy_us
            cur.latencies_us.extend(stats.latencies_us)

    def _retire(self, tid: int, now: float) -> None:
        self.sched_cache = None
        rt = self.tasks.pop(tid)
        self.backend.retire_task(tid)
        self.helpers.pop(tid, None)
        # final span (covers any post-admission allocations), then reclaim
        span = rt.prog.release()
        self.pool.register_task(tid, span)
        self.pool.free_task(tid)
        self._bank_stats(tid, rt.stats)
        rec = self.rec_by_tid.get(tid)
        if rec is not None:
            rec.finished_us = now
            rec.iterations_done = rt.stats.completions
        if self.telemetry is not None:
            self.telemetry.instant(
                "finish",
                self.name,
                now,
                task_id=tid,
                iterations=rt.stats.completions,
            )
        if self.finish_hook is not None:
            self.finish_hook(tid, now)
        if self.lifecycle_hook is not None:
            self.lifecycle_hook(tid, "finished", now)

    def _drain_waiting(self, now: float) -> None:
        # FIFO re-evaluation of the wait queue: stop at the first candidate
        # the controller still holds back (no overtaking)
        while self.waiting:
            ev, rec, pages = self.waiting[0]
            verdict = (
                self.admission.decide(ev.program, ev.time_us, self._state(now))
                if self.admission is not None
                else "admit"
            )
            if verdict == "admit":
                self.waiting.popleft()
                self._waiting_pages -= pages
                self._admit(ev, rec, now)
            elif verdict == "reject":
                self.waiting.popleft()
                self._waiting_pages -= pages
                warm = self._warm_runs.pop(ev.program.task_id, None)
                if self.reject_hook is not None and self.reject_hook(
                    ev, rec, warm
                ):
                    # handled externally (re-routed); this fragment stays
                    # unfinished — the target GPU's fragment completes it
                    continue
                rec.rejected = True
                if self.telemetry is not None:
                    self.telemetry.instant(
                        "shed",
                        self.name,
                        now,
                        task_id=ev.program.task_id,
                        reason="admission_reject",
                    )
                if self.lifecycle_hook is not None:
                    self.lifecycle_hook(ev.program.task_id, "rejected", now)
            else:
                break

    def _process_arrivals(self, now: float) -> None:
        # due arrivals join the wait queue in arrival order; one FIFO drain
        # then decides everyone (no overtaking: the drain stops at the first
        # candidate the controller holds back)
        while self.pending and self.pending[0].time_us <= now:
            ev = self.pending.popleft()
            rec = RequestRecord(
                ev.program.task_id,
                ev.time_us,
                total_iterations=getattr(ev.program, "total_iterations", None),
                meta=dict(ev.meta),
            )
            self.records.append(rec)
            self.rec_by_tid[ev.program.task_id] = rec
            pages = footprint_pages(ev.program, self.page_size)
            self.waiting.append((ev, rec, pages))
            self._waiting_pages += pages
        self._drain_waiting(now)

    def _complete(self, tid: int, rt: _RunTask, now: float) -> bool:
        """Post-iteration bookkeeping shared by the per-command and macro
        paths; returns True when the task finished and retired (end the
        timeslice)."""
        if rt.current_arrival is not None:
            rt.stats.latencies_us.append(now - rt.current_arrival)
            rt.current_arrival = None
            # next pending arrival (if already due) picked up by runnable()
        if self.dynamic:
            rec = self.rec_by_tid.get(tid)
            if rec is not None and rt.stats.completions == 1:
                rec.first_iter_us = now
        if rt.finished():
            # finite programs retire regardless of how they entered —
            # a drained static task must not pin the scheduler forever
            self._retire(tid, now)
            if self.dynamic:
                self._process_arrivals(now)  # freed pages may unblock queue
            return True
        return False

    # -- the event loop ------------------------------------------------------
    def run(self, until_us: float, final: bool = True) -> float:
        """Advance the clock to ``until_us`` (a timeslice in flight may
        overrun it, exactly as ``simulate()`` overruns its horizon). Returns
        the clock. Non-final runs stop — without consuming time — when the
        core has nothing to do before the horizon. A failed core holds its
        clock still until recovered."""
        if self.failed:
            return self.t
        while self.t < until_us:
            if not self._step(until_us, final):
                break
        return self.t

    def _step(self, until_us: float, final: bool) -> bool:
        t = self.t
        if self.dynamic:
            self._process_arrivals(t)
        if self.sched_cache is not None:
            sched = self.sched_cache
        else:
            sched = {
                tid: SchedTask(
                    tid,
                    priority=(self.priorities or {}).get(tid, 0),
                    runnable=rt.runnable(t),
                )
                for tid, rt in self.tasks.items()
            }
            # runnable-ness only changes with the clock in RT-arrivals mode;
            # otherwise the view is invalidated solely by admit/retire, so it
            # can be reused across the (possibly hundreds of thousands of)
            # switches of a long serving trace
            if all(rt.arrivals is None for rt in self.tasks.values()):
                self.sched_cache = sched
        entry = self.policy.next_entry(sched)
        if entry is None:
            # idle until the next RT arrival or task-arrival event
            nxt = [rt.next_arrival() for rt in self.tasks.values()]
            nxt = [x for x in nxt if x is not None]
            if self.pending:
                nxt.append(self.pending[0].time_us)
            if nxt:
                target = min(nxt)
                if not final:
                    # never leap past the cluster event horizon: an arrival
                    # injected there must still be observed in time
                    target = min(target, until_us)
                self.t = max(t, target)
                return True
            if self.waiting:
                if not final:
                    # the cluster may still inject or steal work; starved-
                    # queue force-admission belongs to the terminal drain
                    return False
                # nothing running and nothing due: force-admit the queue head
                # (an idle device can always take work) to guarantee progress
                ev, rec, pages = self.waiting.popleft()
                self._waiting_pages -= pages
                self._admit(ev, rec, t)
                return True
            return False
        # the timeline's first entry must be the task about to run —
        # next_entry() already rotated the policy's run queue past it.
        # Backends that never read the plan (um/suv) skip the multi-entry
        # build: at 2 ms TSG quanta over hundreds of serving tasks it is
        # pure overhead
        backend = self.backend
        if backend.uses_timeline:
            timeline = TaskTimeline([entry] + self.policy.timeline(sched).entries)
        else:
            timeline = TaskTimeline([entry])
        ctrl, ready = backend.on_switch(entry.task_id, timeline, t)
        tel = self.telemetry
        aud = tel.audit if tel is not None else None
        if tel is not None:
            self._tel_switch_begin(entry.task_id, t, ctrl)
        t += ctrl
        self.control_us += ctrl
        self.switches += 1

        rt = self.tasks[entry.task_id]
        if not rt.queue:
            # only reachable when iteration() returns no commands: fail loud
            # instead of spinning the scheduler at zero simulated time
            raise RuntimeError(
                f"task {entry.task_id} is runnable but has no queued "
                "commands; its iteration() produced an empty command list"
            )
        budget = entry.timeslice_us
        space = rt.prog.space
        tid = entry.task_id
        pool = self.pool
        cached_decode = self.cached_decode
        ready_max = ready.global_max if ready is not None else None
        # macro-stepping: once migration has landed (past the last ready
        # time), check the upcoming command window's merged working set once;
        # while it is fully resident, every command runs with zero stall and
        # no backend interaction, so advance the window in a tight loop.
        # A failed check disables re-checking until pool state changes again
        # (any command that actually stalls re-arms it).
        try_macro = cached_decode
        while budget > 0 and rt.runnable(t) and rt.queue:
            if try_macro and (ready_max is None or t >= ready_max):
                # cheap precheck: a window can only qualify if its first
                # command is fully resident — under fault-thrash (UM) this
                # skips the merged-group build entirely
                if not pool.all_resident_runs(rt.queue[0].true_page_runs(space)):
                    try_macro = False
                    window = 0
                else:
                    window = _macro_window(rt.queue, budget)
                merged = (
                    merged_command_runs(islice(rt.queue, window), space)
                    if window
                    else None
                )
                if merged is not None and pool.all_resident_runs(merged):
                    touches = backend.resident_touch
                    ended = False
                    while (
                        window > 0 and budget > 0 and rt.queue
                        and rt.runnable(t)
                    ):
                        cmd = rt.queue[0]
                        if aud is not None:
                            aud.observe_command(self.name, cmd, space)
                        if touches:
                            pool.touch_runs(cmd.true_page_runs(space))
                        end = t + cmd.latency_us  # start == t, stall == 0
                        rt.stats.commands += 1
                        rt.stats.busy_us += end - t
                        budget -= end - t
                        t = end
                        window -= 1
                        if rt.advance(t) and self._complete(tid, rt, t):
                            ended = True
                            break
                    if ended:
                        break
                    continue  # window exhausted: re-derive it
                try_macro = False
            cmd = rt.peek()
            # cached run-length decode; the legacy path re-walks the extents
            # per executed command (preserved for the sim-throughput baseline)
            if cached_decode:
                runs = cmd.true_page_runs(space)
            else:
                runs = pages_to_runs(_true_page_order(space, cmd))
            start = t
            if ready is not None and start < ready_max:
                r = ready.max_ready(runs)
                if r is not None and r > start:
                    start = r
            stall = backend.on_command(cmd, runs, start)
            if stall > 0.0:
                try_macro = cached_decode  # residency changed: re-arm
            if aud is not None:
                aud.observe_command(self.name, cmd, space)
            if tel is not None and (start > t or stall > 0.0):
                self._tel_command(tid, t, start, stall)
            end = start + stall + cmd.latency_us
            rt.stats.commands += 1
            rt.stats.busy_us += end - t
            budget -= end - t
            t = end
            if rt.advance(t) and self._complete(tid, rt, t):
                break
        if tel is not None:
            if aud is not None:
                aud.end_quantum(self.name)
            tel.end("switch", self.name, t, task_id=tid)
            if self.switches % tel.sample_stride == 0:
                tel.counter(self.name, "hbm_used_pages", t, self.pool.used)
                tel.counter(self.name, "run_queue_depth", t, len(self.tasks))
                tel.counter(
                    self.name, "wait_queue_depth", t, len(self.waiting)
                )
        self.t = t
        return True

    # -- telemetry emission (slow path only; never reached when off) ---------
    def _tel_switch_begin(self, tid: int, t: float, ctrl: float) -> None:
        tel = self.telemetry
        tel.begin("switch", self.name, t, task_id=tid, ctrl_us=ctrl)
        if ctrl > 0.0:
            tel.stall(tid, "scheduler_control", ctrl)
        if tel.audit is not None:
            # predictive backends (msched/ideal) expose the coordinator's
            # SwitchReport; backends that plan nothing are not audited
            rep = getattr(self.backend, "last_report", None)
            if rep is not None:
                tel.audit.begin_quantum(
                    self.name, tid, rep.predicted_runs,
                    rep.migration.populated_runs, self.page_size,
                )
        info = self.backend.switch_info()
        if info is not None:
            if info["populated_pages"] > 0:
                tel.span(
                    "migration_plan",
                    self.name,
                    t + info["madvise_us"],
                    info["migration_us"],
                    task_id=tid,
                    pages=info["populated_pages"],
                )
            if info["evicted_pages"] > 0:
                tel.instant(
                    "eviction_batch",
                    self.name,
                    t,
                    task_id=tid,
                    pages=info["evicted_pages"],
                )

    def _tel_command(
        self, tid: int, t: float, start: float, stall: float
    ) -> None:
        tel = self.telemetry
        if start > t:
            # the command waited for planned migration traffic to land
            # (the backend's ready-view): migration-wait inside the slice
            tel.stall(tid, "mig_wait_exec", start - t)
            tel.span(
                "migration_land", self.name, t, start - t, task_id=tid
            )
        if stall > 0.0:
            faults = self.backend.faults()
            tel.span(
                "fault_service",
                self.name,
                start,
                stall,
                task_id=tid,
                faults=faults - self._tel_faults,
            )
            self._tel_faults = faults
            tel.stall(tid, "fault_service", stall)
            if tel.audit is not None:
                # under-fetch residue: pages the populate plan failed to
                # cover, serviced by the fallback demand pager
                tel.audit.observe_fault(self.name, tid, stall)

    def result(self) -> SimResult:
        per_task = {tid: rt.stats for tid, rt in self.tasks.items()}
        for tid, banked in self.retired_stats.items():
            live = per_task.get(tid)
            if live is None:
                per_task[tid] = banked
            else:
                # a previously-ejected task is back and still running at the
                # horizon: both visits' work counts (fresh copy — result()
                # must not mutate live state)
                per_task[tid] = TaskStats(
                    banked.completions + live.completions,
                    banked.commands + live.commands,
                    banked.busy_us + live.busy_us,
                    banked.latencies_us + live.latencies_us,
                )
        return SimResult(
            sim_us=self.t,
            per_task=per_task,
            faults=self.backend.faults(),
            migrated_bytes=self.backend.migrated_pages() * self.page_size,
            switches=self.switches,
            control_us=self.control_us,
            requests=self.records,
            hbm_used_pages=self.pool.used,
            hbm_freed_pages=self.pool.freed_pages,
        )


def simulate(
    programs: Sequence[TaskProgram],
    platform: Platform,
    backend_name: str = "msched",
    capacity_bytes: Optional[int] = None,
    sim_us: float = 2_000_000.0,
    policy: Optional[Policy] = None,
    predictor_kind: str = "template",
    pipelined: bool = True,
    arrivals: Optional[Dict[int, List[float]]] = None,
    priorities: Optional[Dict[int, int]] = None,
    prepopulate: bool = True,
    planning: str = "incremental",
    task_events: Optional[Sequence[TaskArrival]] = None,
    admission: Optional[AdmissionController] = None,
    profile_set: Optional[Sequence[TaskProgram]] = None,
    page_size: int = 0,
    pool: str = "run",
    telemetry=None,
) -> SimResult:
    core = SimCore(
        programs,
        platform,
        backend_name,
        capacity_bytes=capacity_bytes,
        policy=policy,
        predictor_kind=predictor_kind,
        pipelined=pipelined,
        arrivals=arrivals,
        priorities=priorities,
        prepopulate=prepopulate,
        planning=planning,
        task_events=task_events,
        admission=admission,
        profile_set=profile_set,
        page_size=page_size,
        pool=pool,
        telemetry=telemetry,
    )
    core.run(sim_us, final=True)
    res = core.result()
    if telemetry is not None:
        telemetry.finalize(res)
    return res


def _true_page_order(space: AddressSpace, cmd: Command) -> List[int]:
    seen = set()
    order = []
    for ext in cmd.true_extents:
        for p in space.pages_of_extent(ext):
            if p not in seen:
                seen.add(p)
                order.append(p)
    return order


def _macro_window(queue: "Deque[Command]", budget_us: float) -> int:
    """Number of queued commands a zero-stall execution would start within
    ``budget_us`` (the slice consumption rule: a command starts while budget
    remains > 0)."""
    rem = budget_us
    k = 0
    for cmd in queue:
        if rem <= 0:
            break
        rem -= cmd.latency_us
        k += 1
    return k
