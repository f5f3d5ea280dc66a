"""Task scheduling timeline — the scheduler↔memory-manager contract (§6.1).

"The task scheduling timeline is an ordered sequence of task entries and
allocated timeslices akin to the run queue in OS schedulers. … It provides the
ground truth for the future execution timeline — which task will execute, for
how long, and in what order." It is the *Rosetta Stone* that lets the memory
manager reconstruct the global future access sequence and enforce OPT.
"""
from __future__ import annotations

import dataclasses
from typing import List


@dataclasses.dataclass(frozen=True)
class TimelineEntry:
    task_id: int
    timeslice_us: float


class TaskTimeline:
    def __init__(self, entries: List[TimelineEntry]):
        self.entries = list(entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self):
        return len(self.entries)

    def reversed(self):
        return reversed(self.entries)

    def horizon_us(self) -> float:
        return sum(e.timeslice_us for e in self.entries)

    def task_ids(self):
        return [e.task_id for e in self.entries]
