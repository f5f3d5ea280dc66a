"""Crash-safe control plane over ``simulate_cluster``: task lifecycle
state machine, write-ahead decision journal with idempotent replay, and
SLO deadline enforcement. See ``docs/architecture.md`` ("Control plane:
journal, replay, and deadline enforcement").

Copied from the JAX package's ``control/__init__.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from repro_torch.control.deadline import DeadlineMonitor, DeadlineSpec, slo_class_of
from repro_torch.control.journal import JOURNAL_KINDS, DecisionJournal, JournalRecord
from repro_torch.control.lifecycle import (
    ADMITTED,
    CANCELLED,
    CHECKPOINTED,
    FAILED,
    FINISHED,
    LEGAL_EDGES,
    MIGRATING,
    RUNNING,
    SHED,
    SUBMITTED,
    TASK_STATES,
    TERMINAL_STATES,
    LifecycleError,
    TaskLifecycle,
    apply_event,
)
from repro_torch.control.plane import ControlPlane

__all__ = [
    "ADMITTED",
    "CANCELLED",
    "CHECKPOINTED",
    "ControlPlane",
    "DeadlineMonitor",
    "DeadlineSpec",
    "DecisionJournal",
    "FAILED",
    "FINISHED",
    "JOURNAL_KINDS",
    "JournalRecord",
    "LEGAL_EDGES",
    "LifecycleError",
    "MIGRATING",
    "RUNNING",
    "SHED",
    "SUBMITTED",
    "TASK_STATES",
    "TERMINAL_STATES",
    "TaskLifecycle",
    "apply_event",
    "slo_class_of",
]
