"""Task lifecycle state machine: the control plane's authoritative view of
every task the cluster has ever seen.

States follow the submit→finish graph from the ROADMAP's online-control-plane
item::

    SUBMITTED ──► ADMITTED ──► RUNNING ──► FINISHED
        │            │  ▲        │  ▲
        │            │  │        ├──┼──► MIGRATING ──► (RUNNING | SHED)
        │            │  │        ├──┼──► CHECKPOINTED ─► RUNNING
        │            ▼  │        ▼  │
        └─────────► SHED └── FAILED ┴──► ADMITTED   (re-placement)

plus CANCELLED, reachable from every non-terminal state (operator cancel).
``FINISHED``/``CANCELLED``/``SHED`` are terminal. Transitions are validated:
an illegal edge raises :class:`LifecycleError`, which subclasses
:class:`~repro_torch.core.invariants.InvariantViolation` so auditing test
harnesses catch control-plane bugs with the same ``pytest.raises`` they use
for memory-accounting bugs.

The map itself is *coordinator-volatile*: a ``coordinator_crash`` wipes it,
and recovery rebuilds it — from the decision journal (journal mode) or by
scanning the surviving cores (cold mode, via :meth:`TaskLifecycle.assume`).

Copied from the JAX package's ``control/lifecycle.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.invariants import InvariantViolation

SUBMITTED = "SUBMITTED"
ADMITTED = "ADMITTED"
RUNNING = "RUNNING"
MIGRATING = "MIGRATING"
CHECKPOINTED = "CHECKPOINTED"
FAILED = "FAILED"
FINISHED = "FINISHED"
CANCELLED = "CANCELLED"
SHED = "SHED"

TASK_STATES = frozenset(
    {
        SUBMITTED,
        ADMITTED,
        RUNNING,
        MIGRATING,
        CHECKPOINTED,
        FAILED,
        FINISHED,
        CANCELLED,
        SHED,
    }
)
TERMINAL_STATES = frozenset({FINISHED, CANCELLED, SHED})

# every legal edge; anything else raises LifecycleError
LEGAL_EDGES: Dict[str, frozenset] = {
    SUBMITTED: frozenset({ADMITTED, CANCELLED, SHED}),
    ADMITTED: frozenset({RUNNING, FAILED, SHED, CANCELLED}),
    RUNNING: frozenset(
        {MIGRATING, CHECKPOINTED, FAILED, FINISHED, CANCELLED}
    ),
    MIGRATING: frozenset({RUNNING, ADMITTED, FAILED, SHED, CANCELLED}),
    CHECKPOINTED: frozenset({RUNNING, FAILED, FINISHED, CANCELLED}),
    FAILED: frozenset({ADMITTED, SHED, CANCELLED}),
    FINISHED: frozenset(),
    CANCELLED: frozenset(),
    SHED: frozenset(),
}


class LifecycleError(InvariantViolation):
    """An illegal lifecycle transition (or an event for a task the control
    plane never saw) — a control-plane wiring bug, never a recoverable
    runtime condition."""


class TaskLifecycle:
    """The per-task state map with validated transitions.

    ``submit`` registers a new task; ``transition`` moves it along a legal
    edge; ``assume`` registers a state *without* edge validation — only the
    cold-restart scan uses it (an amnesiac coordinator rediscovering the
    fleet has no history to validate against)."""

    def __init__(self):
        self._state: Dict[int, str] = {}
        self._since: Dict[int, float] = {}

    def __len__(self) -> int:
        return len(self._state)

    def submit(self, task_id: int, now: float) -> None:
        if task_id in self._state:
            raise LifecycleError(
                f"task {task_id} submitted twice (currently "
                f"{self._state[task_id]})"
            )
        self._state[task_id] = SUBMITTED
        self._since[task_id] = now

    def transition(self, task_id: int, new_state: str, now: float) -> None:
        if new_state not in TASK_STATES:
            raise LifecycleError(f"unknown lifecycle state {new_state!r}")
        cur = self._state.get(task_id)
        if cur is None:
            raise LifecycleError(
                f"transition to {new_state} for unknown task {task_id}"
            )
        if new_state not in LEGAL_EDGES[cur]:
            raise LifecycleError(
                f"illegal lifecycle edge {cur} -> {new_state} "
                f"for task {task_id}"
            )
        self._state[task_id] = new_state
        self._since[task_id] = now

    def assume(self, task_id: int, state: str, now: float) -> None:
        """Register ``state`` without edge validation (cold-restart
        rediscovery only)."""
        if state not in TASK_STATES:
            raise LifecycleError(f"unknown lifecycle state {state!r}")
        self._state[task_id] = state
        self._since[task_id] = now

    def state(self, task_id: int) -> Optional[str]:
        return self._state.get(task_id)

    def since(self, task_id: int) -> Optional[float]:
        return self._since.get(task_id)

    def states(self) -> Dict[int, str]:
        return dict(self._state)

    def count(self, state: str) -> int:
        return sum(1 for s in self._state.values() if s == state)


def apply_event(
    lc: TaskLifecycle, kind: str, task_id: Optional[int], now: float
) -> None:
    """Apply one journal record to a lifecycle map. This is the single
    mapping from decision kinds to state-machine edges — the live control
    plane, journal replay, and ``msctl``'s offline replay all go through
    it, so they cannot disagree about what a record means.

    ``crash``/``recover`` are markers and ``hold``/``strand``/``requeue``/
    ``release`` queue bookkeeping: neither moves lifecycle state.
    ``checkpoint`` is a transient double-step (RUNNING → CHECKPOINTED →
    RUNNING: the snapshot completes within the decision); ``reroute`` is
    state-preserving but still validated — rerouting a task that is not
    in flight is a wiring bug.
    """
    if kind == "submit":
        lc.submit(task_id, now)
        return
    if kind in ("crash", "recover", "hold", "strand", "requeue", "release"):
        return
    if task_id is None:
        raise LifecycleError(f"journal record {kind!r} without a task id")
    if kind == "place":
        lc.transition(task_id, ADMITTED, now)
    elif kind == "admit":
        lc.transition(task_id, RUNNING, now)
    elif kind == "finish":
        lc.transition(task_id, FINISHED, now)
    elif kind in ("reject", "shed"):
        lc.transition(task_id, SHED, now)
    elif kind in ("migrate", "preempt"):
        lc.transition(task_id, MIGRATING, now)
    elif kind == "fail":
        lc.transition(task_id, FAILED, now)
    elif kind == "recovery":
        lc.transition(task_id, ADMITTED, now)
    elif kind == "cancel":
        lc.transition(task_id, CANCELLED, now)
    elif kind == "checkpoint":
        lc.transition(task_id, CHECKPOINTED, now)
        lc.transition(task_id, RUNNING, now)
    elif kind == "reroute":
        cur = lc.state(task_id)
        if cur not in (ADMITTED, MIGRATING):
            raise LifecycleError(
                f"reroute of task {task_id} in state {cur} (must be in "
                "flight: ADMITTED or MIGRATING)"
            )
    else:
        raise LifecycleError(f"unknown journal kind {kind!r}")
