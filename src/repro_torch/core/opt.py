"""Belady-OPT planning over the reconstructed global access sequence (§6.2).

The coordinator merges each task's *local* future command sequence (from the
per-process helpers) with the scheduler's timeline to obtain the global order
in which pages will be touched. Two artifacts come out of it:

  * ``timeslice_page_groups`` — the page set touched within each timeline
    entry, in timeline order. Walking these groups in *reverse* and madvising
    each to the eviction-list tail leaves the list head holding exactly the
    pages unreferenced for the longest time: Belady's OPT order (Fig. 4).
  * ``first_access_order`` — pages of the next timeslice ordered by first
    access, used by the migration pipeline for *early execution* (§6.3).

``belady_reference`` is an explicit OPT cache simulator used by tests and the
*Ideal* baseline to prove the list mechanism achieves the optimal migration
volume. It evicts via a lazy max-heap on next-use (O(log R) per miss);
``belady_reference_scan`` preserves the original O(R)-per-miss victim scan as
the equivalence reference.
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from repro_torch.core.pages import PageRun, expand_runs, pages_to_runs
from repro_torch.core.timeline import TaskTimeline


@dataclasses.dataclass
class PlannedAccess:
    task_id: int
    seq_no: int  # command sequence number within the task (absolute launch index)
    pages: Optional[List[int]]  # page first-touch order; None when runs-backed
    latency_us: float
    # run-length form of the same first-touch order; the incremental planner
    # fills this from the command's annotate-time cache and leaves ``pages``
    # unmaterialized.
    runs: Optional[Tuple[PageRun, ...]] = None

    def page_runs(self) -> Tuple[PageRun, ...]:
        if self.runs is None:
            self.runs = pages_to_runs(self.pages or [])
        return self.runs

    def page_list(self) -> List[int]:
        if self.pages is None:
            self.pages = expand_runs(self.runs or ())
        return self.pages


@dataclasses.dataclass
class OptPlan:
    timeslice_page_groups: List[Set[int]]  # one per timeline entry
    first_access_order: List[int]  # next timeslice, de-duplicated
    global_sequence: List[List[int]]  # per global command, page lists


def build_plan(
    timeline: TaskTimeline,
    task_futures: Dict[int, Sequence[PlannedAccess]],
) -> OptPlan:
    """Reconstruct the global access sequence by walking the timeline and
    consuming each task's future commands up to its allocated timeslice."""
    cursors = {tid: 0 for tid in task_futures}
    groups: List[Set[int]] = []
    global_seq: List[List[int]] = []
    first_order: List[int] = []
    first_seen: Set[int] = set()

    for i, entry in enumerate(timeline):
        group: Set[int] = set()
        budget = entry.timeslice_us
        future = task_futures.get(entry.task_id, ())
        cur = cursors.get(entry.task_id, 0)
        while cur < len(future) and budget > 0:
            acc = future[cur]
            pages = acc.page_list()
            group.update(pages)
            global_seq.append(list(pages))
            if i == 0:
                for p in pages:
                    if p not in first_seen:
                        first_seen.add(p)
                        first_order.append(p)
            budget -= acc.latency_us
            cur += 1
        cursors[entry.task_id] = cur
        groups.append(group)
    return OptPlan(groups, first_order, global_seq)


def belady_eviction_order(plan: OptPlan, resident: Iterable[int]) -> List[int]:
    """Expected eviction order under the madvise-walk: pages never referenced
    in the horizon first, then by *decreasing* distance to next use.

    ``resident`` may be any iterable — in particular the pool's lazy
    ``iter_eviction()`` view, so OPT-path callers never copy the full
    resident list just to re-sort it."""
    next_use: Dict[int, int] = {}
    for i, group in enumerate(plan.timeslice_page_groups):
        for p in group:
            next_use.setdefault(p, i)
    inf = len(plan.timeslice_page_groups) + 1
    return sorted(
        resident,
        key=lambda p: -next_use.get(p, inf),
    )


def belady_reference(
    accesses: Sequence[Sequence[int]],
    capacity: int,
    initially_resident: Optional[Set[int]] = None,
) -> Tuple[int, int]:
    """Exact Belady OPT cache simulation over a page-access sequence.

    Returns (misses, evictions) — the minimum achievable migration volume.

    Victim selection uses a lazy max-heap keyed on next-use index, making a
    miss O(log R) instead of the O(R) residency scan of
    :func:`belady_reference_scan`. Finite next-use indices are unique (each
    access position names one page), and never-referenced pages are mutually
    interchangeable, so the (misses, evictions) counts are identical to the
    scan for any tie-breaking choice.
    """
    flat: List[int] = []
    for group in accesses:
        flat.extend(group)
    n = len(flat)
    inf = n + 1
    # next occurrence of flat[i]'s page strictly after position i
    nxt = [inf] * n
    last: Dict[int, int] = {}
    for i in range(n - 1, -1, -1):
        nxt[i] = last.get(flat[i], inf)
        last[flat[i]] = i

    resident: Set[int] = set(initially_resident or ())
    next_of: Dict[int, int] = {}  # current next-use per resident page
    heap: List[Tuple[int, int]] = []  # (-next_use, page), lazily invalidated
    for q in resident:
        next_of[q] = last.get(q, inf)  # ``last`` now holds first occurrences
        heapq.heappush(heap, (-next_of[q], q))

    misses = evictions = 0
    for i, p in enumerate(flat):
        if p in resident:
            next_of[p] = nxt[i]
            heapq.heappush(heap, (-nxt[i], p))
            continue
        misses += 1
        if len(resident) >= capacity:
            while True:
                negd, q = heapq.heappop(heap)
                if q in resident and next_of[q] == -negd:
                    break
            resident.remove(q)
            evictions += 1
        resident.add(p)
        next_of[p] = nxt[i]
        heapq.heappush(heap, (-nxt[i], p))
    return misses, evictions


def belady_reference_scan(
    accesses: Sequence[Sequence[int]],
    capacity: int,
    initially_resident: Optional[Set[int]] = None,
) -> Tuple[int, int]:
    """Original O(n·R) Belady OPT simulation (linear victim scan). Kept as
    the straightforward reference that :func:`belady_reference` must match."""
    flat: List[int] = []
    for group in accesses:
        flat.extend(group)
    # next-use index table
    next_use: Dict[int, List[int]] = {}
    for i, p in enumerate(flat):
        next_use.setdefault(p, []).append(i)
    for lst in next_use.values():
        lst.reverse()  # pop() yields the next upcoming index

    resident: Set[int] = set(initially_resident or ())
    misses = evictions = 0
    for i, p in enumerate(flat):
        uses = next_use[p]
        while uses and uses[-1] <= i:
            uses.pop()
        if p in resident:
            continue
        misses += 1
        if len(resident) >= capacity:
            # evict the resident page with the farthest next use
            victim, dist = None, -1.0
            for q in resident:
                lst = next_use.get(q)
                while lst and lst[-1] <= i:
                    lst.pop()
                d = lst[-1] if lst else float("inf")
                if d > dist:
                    dist, victim = d, q
                    if d == float("inf"):
                        break
            resident.remove(victim)
            evictions += 1
        resident.add(p)
    return misses, evictions
