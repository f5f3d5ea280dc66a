"""The write-ahead decision journal: every scheduler decision, appended
*before* it takes effect.

The journal is the control plane's only durable state across a
``coordinator_crash`` (fsync-free and in-sim: per-node agents append to a
log the coordinator's memory loss cannot touch, the way etcd/raft logs
survive an apiserver restart). Records carry two kinds of payload field:

  * **primitive** fields (str/int/float/bool/None) — what ``to_json``
    exports for the ``msctl`` CLI and offline lifecycle replay;
  * **reference** fields (live sim objects: ``TaskArrival``\\ s, programs,
    request records) — what :meth:`ControlPlane.replay` re-inserts into the
    fault runtime's queues after a crash. In-sim, the durable log *is* the
    object store.

``hold``/``strand``/``requeue`` records are matched against ``release``
records (FIFO per ``(kind, task_id)``) to find work that was parked in a
coordinator queue and never dispatched — exactly what replay must
reconstruct and what end-of-run drain must account as lost if the
coordinator never came back.

Copied from the JAX package's ``control/journal.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional

# every decision kind the control plane journals. "crash"/"recover" are
# markers (no lifecycle effect); "hold"/"strand"/"requeue"/"release" are
# coordinator-queue bookkeeping; the rest map 1:1 onto lifecycle events.
JOURNAL_KINDS = frozenset(
    {
        "submit",  # client arrival accepted by the control plane
        "place",  # placement decision (fresh or re-dispatched arrival)
        "admit",  # core admitted the task (data-plane ack)
        "finish",  # task retired
        "reject",  # admission reject / graceful-degradation shed
        "shed",  # deadline-enforcement shed of a running task
        "cancel",  # operator cancel
        "migrate",  # rebalancer checkpoint/p2p move decision
        "reroute",  # steal or retry bounce (state-preserving)
        "checkpoint",  # vault snapshot decision
        "recovery",  # recovery-tier choice for a fault victim
        "preempt",  # deadline-enforcement BE preemption
        "fail",  # a core failure/crash tore the task down
        "hold",  # arrival parked: no alive GPU / coordinator down
        "strand",  # running victim parked: no alive GPU / coordinator down
        "requeue",  # denied restore backing off on the retry heap
        "release",  # a parked item left its queue (payload "of" names it)
        "crash",  # coordinator_crash marker
        "recover",  # coordinator_recover marker
    }
)

_PRIMITIVES = (str, int, float, bool, type(None))


@dataclasses.dataclass(frozen=True)
class JournalRecord:
    """One appended decision. ``seq`` is the global append order (replay
    order); ``payload`` holds both primitive and reference fields."""

    seq: int
    time_us: float
    kind: str
    task_id: Optional[int]
    payload: Dict[str, object]

    def primitives(self) -> Dict[str, object]:
        return {
            k: v
            for k, v in self.payload.items()
            if isinstance(v, _PRIMITIVES)
        }


class DecisionJournal:
    """Append-only decision log. Appending an unknown kind raises — the
    journal's schema is closed, mirroring ``EVENT_TYPES``."""

    def __init__(self):
        self.records: List[JournalRecord] = []
        self._seq = 0

    def append(
        self,
        kind: str,
        time_us: float,
        task_id: Optional[int] = None,
        **payload,
    ) -> JournalRecord:
        if kind not in JOURNAL_KINDS:
            raise ValueError(f"unknown journal kind {kind!r}")
        rec = JournalRecord(self._seq, time_us, kind, task_id, payload)
        self._seq += 1
        self.records.append(rec)
        return rec

    def __len__(self) -> int:
        return len(self.records)

    def __iter__(self) -> Iterator[JournalRecord]:
        return iter(self.records)

    def unreleased(self) -> List[JournalRecord]:
        """Every ``hold``/``strand``/``requeue`` record whose item never got
        a matching ``release`` — the parked work a journal replay must
        reconstruct (FIFO matching per ``(kind, task_id)``)."""
        open_holds: Dict[tuple, List[JournalRecord]] = {}
        for r in self.records:
            if r.kind in ("hold", "strand", "requeue"):
                open_holds.setdefault((r.kind, r.task_id), []).append(r)
            elif r.kind == "release":
                lst = open_holds.get((r.payload.get("of"), r.task_id))
                if lst:
                    lst.pop(0)
        out = [r for lst in open_holds.values() for r in lst]
        out.sort(key=lambda r: r.seq)
        return out

    def to_json(self) -> List[Dict[str, object]]:
        """Primitive-only export (the ``msctl`` dump format): reference
        payload fields are dropped, everything else round-trips."""
        return [
            {
                "seq": r.seq,
                "time_us": r.time_us,
                "kind": r.kind,
                "task_id": r.task_id,
                **r.primitives(),
            }
            for r in self.records
        ]
