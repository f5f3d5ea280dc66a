"""Task schedulers: round-robin and priority (RT/BE) policies.

The scheduler owns the preemptive context switcher (XSched's TSG-based
switching in the paper) and — crucially for MSched — *exposes its timeline*
to the memory manager. Policies only need to produce that timeline; memory
management is fully decoupled (paper §6.1: "the timeline … effectively
decouples the scheduling policy from memory management").
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

from repro_torch.core.timeline import TaskTimeline, TimelineEntry


@dataclasses.dataclass
class SchedTask:
    task_id: int
    priority: int = 0  # higher = more urgent (RT), 0 = best-effort
    runnable: bool = True  # has pending work (admitted and not blocked)


class Policy:
    def next_entry(self, tasks: Dict[int, SchedTask]) -> Optional[TimelineEntry]:
        raise NotImplementedError

    def timeline(self, tasks: Dict[int, SchedTask], horizon: int = 0) -> TaskTimeline:
        raise NotImplementedError


class RoundRobinPolicy(Policy):
    """Equal timeslices in fixed order — the paper's default (matches the
    time-sharing behavior of commodity GPUs).

    The task population is dynamic: tasks absent from ``tasks`` have departed
    and are purged from the rotation; tasks present but ``runnable=False``
    (blocked tasks, e.g. RT jobs waiting between request arrivals) keep their
    rotation slot but are *skipped* by both ``next_entry`` and ``timeline`` —
    a non-runnable task must never be scheduled nor planned for. (Requests
    queued by admission control are *not* in ``tasks`` at all: they only
    enter the population once admitted.)
    """

    def __init__(self, quantum_us: float = 5_000.0):
        self.quantum_us = quantum_us
        self._rr: List[int] = []

    def _order(self, tasks: Dict[int, SchedTask]) -> List[int]:
        # purge departed tasks; enroll new ones at the tail (arrival order)
        self._rr = [t for t in self._rr if t in tasks]
        known = set(self._rr)
        for t in sorted(tasks):
            if t not in known:
                self._rr.append(t)
        return [t for t in self._rr if tasks[t].runnable]

    def next_entry(self, tasks):
        order = self._order(tasks)
        if not order:
            return None
        tid = order[0]
        # rotate only the dispatched task; skipped (non-runnable) tasks keep
        # their position so they run promptly once admitted/unblocked
        self._rr.remove(tid)
        self._rr.append(tid)
        return TimelineEntry(tid, self.quantum_us)

    def timeline(self, tasks, horizon: int = 0) -> TaskTimeline:
        order = self._order(tasks)
        horizon = horizon or 2 * max(len(order), 1)
        entries = [
            TimelineEntry(order[i % len(order)], self.quantum_us)
            for i in range(horizon)
        ] if order else []
        return TaskTimeline(entries)


class PriorityPolicy(Policy):
    """Strict priority with RR among equals; RT preempts BE on arrival."""

    def __init__(self, quantum_us: float = 5_000.0, rt_quantum_us: float = 2_000.0):
        self.quantum_us = quantum_us
        self.rt_quantum_us = rt_quantum_us
        self._rr = RoundRobinPolicy(quantum_us)

    def _split(self, tasks):
        """Partition by priority class. Both classes keep their non-runnable
        members (so the BE rotation preserves their slots); runnable filtering
        happens at selection time."""
        rt = {t: s for t, s in tasks.items() if s.priority > 0}
        be = {t: s for t, s in tasks.items() if s.priority == 0}
        return rt, be

    def next_entry(self, tasks):
        rt, be = self._split(tasks)
        runnable_rt = [t for t, s in rt.items() if s.runnable]
        if runnable_rt:
            tid = min(runnable_rt)  # deterministic among RT
            return TimelineEntry(tid, self.rt_quantum_us)
        return self._rr.next_entry(be) if be else None

    def timeline(self, tasks, horizon: int = 0) -> TaskTimeline:
        rt, be = self._split(tasks)
        entries: List[TimelineEntry] = []
        for tid in sorted(t for t, s in rt.items() if s.runnable):
            entries.append(TimelineEntry(tid, self.rt_quantum_us))
        n_be = sum(1 for s in be.values() if s.runnable)
        be_tl = self._rr.timeline(be, horizon or 2 * max(n_be, 1))
        entries.extend(be_tl.entries)
        return TaskTimeline(entries)
