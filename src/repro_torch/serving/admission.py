"""Admission control for the dynamic serving regime.

``AlwaysAdmit`` is the naive baseline: every request becomes a task the
moment it arrives, so concurrency — and with it memory pressure — is
unbounded (demand paging's thrashing regime).

``MSchedAdmission`` is MSched-aware: it reconstructs the *per-schedule-cycle
HBM demand* from exactly the state the memory manager already maintains —
each admitted task's predicted working set (the helper's annotated future,
cut to one scheduling quantum, i.e. what the planner would migrate on that
task's next switch) — and admits a candidate only while that demand plus the
candidate's *full footprint* (no helper exists yet, so the conservative
bound) fits within a headroom fraction of HBM.
Otherwise the request queues; the queue head is re-evaluated at every
scheduler step — so capacity freed by a retirement is picked up at the next
context switch — in FIFO order with no overtaking. A wait deadline turns
starvation into an explicit rejection.

Copied from the JAX package's ``serving/admission.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from typing import Dict, Optional

# predicted_working_set_pages / footprint_pages / active_demand_pages moved
# into core (repro_torch.core.memory_manager / workloads / simulator) so the
# cluster placement bin-packer can share them; re-exported here for
# backwards compatibility.
from repro_torch.core.memory_manager import predicted_working_set_pages  # noqa: F401
from repro_torch.core.simulator import (
    AdmissionController,
    SimState,
    active_demand_pages,
)
from repro_torch.core.workloads import TaskProgram, footprint_pages  # noqa: F401
from repro_torch.control.deadline import slo_class_of


class AlwaysAdmit(AdmissionController):
    """Naive baseline: unbounded concurrency."""

    def decide(self, prog, arrival_us, state):
        return "admit"


class MSchedAdmission(AdmissionController):
    """Admit while predicted per-cycle working sets fit in HBM headroom.

    ``headroom`` is the fraction of HBM capacity the admitted working sets
    may claim (< 1 reserves slack for mispredictions and the control plane;
    > 1 deliberately oversubscribes the *working sets*, betting on MSched's
    proactive swap). ``max_wait_us`` rejects requests queued longer than the
    deadline (callers surface this as load shedding). ``be_headroom``
    optionally holds best-effort ("be" SLO class) candidates to a tighter
    budget than real-time ones, reserving slack for "rt" work under
    degraded capacity.
    """

    def __init__(
        self,
        headroom: float = 0.9,
        max_wait_us: Optional[float] = None,
        quantum_us: Optional[float] = None,
        be_headroom: Optional[float] = None,
    ):
        assert headroom > 0
        assert be_headroom is None or 0 < be_headroom <= headroom
        self.headroom = headroom
        self.be_headroom = be_headroom
        self.max_wait_us = max_wait_us
        self.quantum_us = quantum_us
        # diagnostics (per request, not per decide() call — queued candidates
        # are re-evaluated on every scheduler step)
        self.admitted = 0
        self.queued = 0
        self.rejected = 0
        self._queued_ids: set = set()

    def _demand_pages(self, state: SimState, quantum_us: float) -> int:
        """Per-cycle HBM demand: every active task runs once per round-robin
        cycle of the scheduler timeline, so the cycle demand is the sum of
        the predicted per-quantum working sets of all admitted tasks (see
        :func:`repro_torch.core.simulator.active_demand_pages`)."""
        return active_demand_pages(state, quantum_us)

    def decide(self, prog, arrival_us, state):
        if (
            self.max_wait_us is not None
            and state.now - arrival_us > self.max_wait_us
        ):
            self.rejected += 1
            self._queued_ids.discard(prog.task_id)
            return "reject"
        if not state.active:
            self.admitted += 1
            self._queued_ids.discard(prog.task_id)
            return "admit"  # an idle device always takes work
        quantum = self.quantum_us or getattr(state.policy, "quantum_us", 5_000.0)
        demand = self._demand_pages(state, quantum)
        candidate = footprint_pages(prog, state.page_size)
        # best-effort work admits against the tighter be_headroom budget so
        # that degraded fleets keep slack for real-time requests; classify
        # with the control plane's rule so admission, deadline enforcement,
        # and shedding all agree on what counts as "rt"
        headroom = self.headroom
        if (
            self.be_headroom is not None
            and slo_class_of(getattr(prog, "meta", None), prog) == "be"
        ):
            headroom = self.be_headroom
        if demand + candidate <= headroom * state.pool.capacity:
            self.admitted += 1
            self._queued_ids.discard(prog.task_id)
            return "admit"
        if prog.task_id not in self._queued_ids:
            self._queued_ids.add(prog.task_id)
            self.queued += 1
        return "queue"
