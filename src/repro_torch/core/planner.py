"""Incremental planning engine: O(1)-amortized working-set prediction.

The straightforward coordinator (``opt.build_plan`` over per-switch future
rebuilds) re-decodes every queued command's extents into page lists on every
context switch — O(queue depth x footprint) per switch, which makes the
*simulator* the bottleneck long before the modeled hardware is (cf. the
paper's <1 ms control-plane budget, §6/Fig. 11).

This module plans each switch from state the helpers already maintain
incrementally:

  * every command's page order is decoded **once**, at ``annotate()`` time,
    into run-length page intervals cached on the command;
  * each helper keeps its ``PlannedAccess`` future as an append/pop deque with
    a cumulative-latency prefix array, so locating a timeslice's command range
    is a bisect, not a walk;
  * timeslice page groups are merged interval lists, never materialized int
    sets, so madvise/migrate can stream GiB-scale working sets.

A switch therefore costs O(timeline entries · log queue + horizon runs +
pages actually migrated) instead of O(queue · footprint). ``RunPlan`` can be
materialized into a classic ``OptPlan`` for equivalence testing against
``build_plan``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Sequence, Tuple

from repro_torch.core.opt import OptPlan
from repro_torch.core.pages import (
    PageRun,
    RunSet,
    expand_runs,
    intersect_runs,
    merge_runs,
    subtract_runs,
)
from repro_torch.core.timeline import TaskTimeline

# (task_id, start, end): future-queue index range consumed by one entry
EntryCut = Tuple[int, int, int]


@dataclasses.dataclass
class RunPlan:
    """Run-length form of an OPT plan over the scheduling timeline."""

    entry_cuts: List[EntryCut]
    run_groups: List[List[PageRun]]  # merged (sorted, disjoint) per entry
    first_access_runs: List[PageRun]  # next timeslice, first-touch order

    def to_opt_plan(self, helpers: Dict[int, "TaskHelper"]) -> OptPlan:
        """Materialize the classic set-based plan (equivalence tests only)."""
        groups = [set(expand_runs(g)) for g in self.run_groups]
        first = expand_runs(self.first_access_runs)
        global_seq: List[List[int]] = []
        for tid, start, end in self.entry_cuts:
            h = helpers.get(tid)
            if h is None:
                continue
            for acc in h.future_slice(start, end):
                global_seq.append(list(acc.page_list()))
        return OptPlan(groups, first, global_seq)


def compute_cuts(
    timeline: TaskTimeline, helpers: Dict[int, "TaskHelper"]
) -> List[EntryCut]:
    """Walk the timeline, assigning each entry its command range via bisect
    over the helper's cumulative-latency prefix array (same consumption rule
    as ``build_plan``: a command is consumed while budget remains > 0)."""
    cursors = {tid: h.head_index() for tid, h in helpers.items()}
    cuts: List[EntryCut] = []
    for entry in timeline:
        h = helpers.get(entry.task_id)
        if h is None:
            cuts.append((entry.task_id, 0, 0))
            continue
        start = cursors[entry.task_id]
        end = h.consume_cut(start, entry.timeslice_us)
        cursors[entry.task_id] = end
        cuts.append((entry.task_id, start, end))
    return cuts


def first_access_runs(
    helpers: Dict[int, "TaskHelper"], cuts: List[EntryCut]
) -> List[PageRun]:
    """Pages of the next timeslice in first-access order (deduplicated),
    as runs — the migration pipeline's population order (§6.3)."""
    if not cuts:
        return []
    tid, start, end = cuts[0]
    h = helpers.get(tid)
    if h is None:
        return []
    seen = RunSet()
    seen_shapes: set = set()
    out: List[PageRun] = []
    for acc in h.future_slice(start, end):
        runs = acc.page_runs()
        # iteration-structured workloads repeat identical cached run tuples;
        # an exact repeat has every page seen already, so skip the interval
        # walk entirely (this is the O(1)-amortized part of the hot path)
        if not runs or runs in seen_shapes:
            continue
        seen_shapes.add(runs)
        for s, e in runs:
            out.extend(seen.add(s, e))
    return out


def run_groups(
    helpers: Dict[int, "TaskHelper"], cuts: List[EntryCut]
) -> List[List[PageRun]]:
    """Per-timeline-entry touched-page groups as merged interval lists.
    Iterating a merged group yields ascending unique pages — the same visit
    order as ``sorted(set(...))`` over the per-page representation."""
    groups: List[List[PageRun]] = []
    for tid, start, end in cuts:
        h = helpers.get(tid)
        runs: List[PageRun] = []
        if h is not None:
            seen_shapes: set = set()
            for acc in h.future_slice(start, end):
                r = acc.page_runs()
                # duplicate cached run tuples add nothing to the union
                if r and r not in seen_shapes:
                    seen_shapes.add(r)
                    runs.extend(r)
        groups.append(merge_runs(runs))
    return groups


def plan_switch(
    timeline: TaskTimeline, helpers: Dict[int, "TaskHelper"]
) -> RunPlan:
    """Full incremental plan for one context switch."""
    cuts = compute_cuts(timeline, helpers)
    return RunPlan(cuts, run_groups(helpers, cuts), first_access_runs(helpers, cuts))


def partition_source_tiers(
    requested: Sequence[PageRun],
    peer_candidate: Sequence[PageRun],
    missing_on_peer: Callable[[List[PageRun]], List[PageRun]],
) -> Tuple[List[PageRun], List[PageRun], List[PageRun]]:
    """Split a migration's populate set by *source tier*.

    ``requested`` is the switch's population set in first-access order;
    ``peer_candidate`` is the sorted disjoint run set a peer GPU may still
    hold (e.g. a migrated task's lingering working set from the cluster's
    page-location directory); ``missing_on_peer`` is the peer pool's live
    ``missing_runs`` — the directory is a hint, the pool is the truth.

    Returns ``(peer, host, fresh)``, each order-preserving:

      * **peer**  — lingered *and* still resident on the peer: fetchable over
        NVLink at the link graph's fluid-share rate;
      * **host**  — lingered but since evicted by the peer (the data went to
        host DRAM): a host round-trip at PCIe rate — the fallback a source
        GPU's mid-stream eviction forces;
      * **fresh** — never part of the peer-held set (pages the task had not
        materialized when it migrated): populated through the standard host
        path, counted separately so the tier mix is observable.
    """
    avail = intersect_runs(requested, list(peer_candidate))
    gone = merge_runs(missing_on_peer(avail)) if avail else []
    peer = subtract_runs(avail, gone)
    host = intersect_runs(avail, gone)
    fresh = subtract_runs(requested, merge_runs(avail))
    return peer, host, fresh


def merged_command_runs(cmds, space) -> List[PageRun]:
    """Merged (sorted, disjoint) ground-truth page runs of a command window —
    the macro-stepper's residency precondition: when the merged group is fully
    resident, every command in the window executes with zero stall and no
    backend interaction, so the simulator may advance the whole window in one
    tight loop."""
    runs: List[PageRun] = []
    for cmd in cmds:
        runs.extend(cmd.true_page_runs(space))
    return merge_runs(runs)
