"""SLO deadline policy: which RT tasks are at risk, and which BE task pays.

``DeadlineSpec`` gives real-time ("rt" SLO class) requests a TTFT deadline
and a completion deadline; the :class:`DeadlineMonitor` projects both at
every control tick:

  * an RT request with no first iteration past ``ttft_grace`` of its TTFT
    budget is at risk (queued or starved behind best-effort work);
  * a started RT request whose rate-extrapolated completion lands past its
    completion deadline is at risk.

Risk does not miss the deadline by itself — the control plane preempts a
best-effort task on the same GPU (eject + delayed re-injection through the
existing migration machinery), escalating through capped-exponential
backoff per victim until ``max_preemptions``, after which the victim is
shed. The per-victim counters are coordinator-volatile (wiped by
``coordinator_crash``): a restarted coordinator restarts the escalation
ladder, which only delays — never skips — the shed.

Copied from the JAX package's ``control/deadline.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


@dataclasses.dataclass(frozen=True)
class DeadlineSpec:
    """Per-class deadlines. ``rt_ttft_us`` bounds arrival → first iteration
    for "rt" requests; ``rt_latency_us`` bounds arrival → completion.
    ``ttft_grace`` is the fraction of the TTFT budget an un-started RT
    request may burn before enforcement kicks in (enforcing at 1.0 would
    always be too late to matter)."""

    rt_ttft_us: float = 200_000.0
    rt_latency_us: float = 5_000_000.0
    ttft_grace: float = 0.5

    def __post_init__(self):
        if self.rt_ttft_us <= 0 or self.rt_latency_us <= 0:
            raise ValueError("deadlines must be positive")
        if not 0.0 < self.ttft_grace <= 1.0:
            raise ValueError("ttft_grace must be in (0, 1]")


def slo_class_of(meta: Optional[dict], prog) -> str:
    """A request's SLO class, the way the fault runtime and admission
    already read it: the arrival's meta wins, then the program attribute
    (continuations carry it — see ``ResumedTask``), default best-effort."""
    k = (meta or {}).get("slo_class") or getattr(prog, "slo_class", None)
    return k or "be"


class DeadlineMonitor:
    """Risk projection + victim selection. Enforcement (journal, eject,
    re-inject, telemetry) lives on the control plane; the monitor only
    answers "who is at risk on this core" and "which BE task pays"."""

    def __init__(
        self,
        spec: DeadlineSpec,
        backoff_us: float = 50_000.0,
        backoff_cap_us: float = 400_000.0,
        max_preemptions: int = 3,
    ):
        if backoff_us <= 0 or backoff_cap_us < backoff_us:
            raise ValueError("need 0 < backoff_us <= backoff_cap_us")
        if max_preemptions < 1:
            raise ValueError("max_preemptions must be >= 1")
        self.spec = spec
        self.backoff_us = backoff_us
        self.backoff_cap_us = backoff_cap_us
        self.max_preemptions = max_preemptions
        # coordinator-volatile escalation state
        self._preempts: Dict[int, int] = {}

    def reset(self) -> None:
        """Coordinator crash: escalation counters are coordinator memory."""
        self._preempts.clear()

    def preempt_count(self, task_id: int) -> int:
        return self._preempts.get(task_id, 0)

    def backoff_for(self, task_id: int) -> float:
        """Capped-exponential re-injection delay for the *next* preemption
        of this victim, and bump its counter."""
        n = self._preempts.get(task_id, 0)
        self._preempts[task_id] = n + 1
        return min(self.backoff_us * (2.0 ** n), self.backoff_cap_us)

    # -- risk projection -----------------------------------------------------
    def _rt_record_at_risk(self, rec, completions: int, now: float) -> bool:
        ttft_cut = rec.arrival_us + self.spec.ttft_grace * self.spec.rt_ttft_us
        if rec.first_iter_us is None:
            return now > ttft_cut
        total = rec.total_iterations
        if not total or completions <= 0:
            return False
        elapsed = now - rec.first_iter_us
        if elapsed <= 0.0:
            return False
        eta = now + (elapsed / completions) * max(0, total - completions)
        return eta > rec.arrival_us + self.spec.rt_latency_us

    def at_risk(self, core, now: float) -> List[int]:
        """RT task ids on ``core`` (running or queued) projected to miss a
        deadline at ``now``."""
        risky: List[int] = []
        for tid in sorted(core.tasks):
            rt = core.tasks[tid]
            rec = core.rec_by_tid.get(tid)
            if rec is None:
                continue
            if slo_class_of(rec.meta, rt.prog) != "rt":
                continue
            if self._rt_record_at_risk(rec, rt.stats.completions, now):
                risky.append(tid)
        for ev, rec, _pages in core.waiting:
            if slo_class_of(ev.meta, ev.program) != "rt":
                continue
            if self._rt_record_at_risk(rec, 0, now):
                risky.append(ev.program.task_id)
        return risky

    def pick_victim(self, core, now: float) -> Optional[int]:
        """The BE running task that pays: most recently admitted (least
        sunk prefix — the rebalancer's work-stealing heuristic),
        deterministic tie-break on task id."""
        best = None
        for tid, rt in core.tasks.items():
            rec = core.rec_by_tid.get(tid)
            if slo_class_of(rec.meta if rec else None, rt.prog) == "rt":
                continue
            admitted = rec.admitted_us if rec is not None else None
            key = (admitted if admitted is not None else 0.0, tid)
            if best is None or key > best[0]:
                best = (key, tid)
        return None if best is None else best[1]
