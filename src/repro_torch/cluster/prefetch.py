"""NVLink peer-to-peer working-set prefetch: the cluster side of the
extended context switch.

When a task migrates between NVLink-connected GPUs, the bulk working-set
copy is unnecessary: only the *manifest* ships (``Rebalancer``'s lazy path),
the pages stay resident on the source — demoted to its eviction-list head,
so they cost the source nothing — and the target's memory manager pulls the
predicted working set over NVLink during its own extended context switches.
That turns the paper's core move (one proactive migration instead of
fragmented faults) into a cluster-level primitive: the prefetch is sourced
from whichever tier is fastest (peer HBM ≫ host DRAM), priced by the link
graph's fluid-share bandwidth, and contends with ordinary migrations on the
same edges.

:class:`PeerPrefetchFabric` is the wiring layer the cluster engine installs
when (and only when) the topology has NVLink edges:

  * a per-core ``peer_source`` hook on each MSched coordinator that
    partitions a switch's population set into **peer / host / fresh** source
    tiers (:func:`repro_torch.core.planner.partition_source_tiers`) and returns a
    :class:`~repro_torch.core.migration.TieredMigration` pricing the peer tier at
    the NVLink fluid-share rate (``ClusterTopology.plan_transfer`` — the same
    contention bookkeeping migrations use);
  * a per-core ``cluster_view`` hook feeding the coordinator's madvise walk
    the *fleet-level* next-use estimate of lingering foreign runs, so each
    GPU's eviction list realizes Belady-OPT over the cluster-wide timeline —
    the eviction head holds the page the *cluster* needs last, and
    evicted-but-peer-resident runs become prefetch sources instead of host
    round-trips;
  * :meth:`reap` — reclaims lingering copies once the fleet no longer needs
    them (task finished/rejected elsewhere, or end of run).

The directory is a hint, never the truth: every fetch re-checks the source
pool's live residency, and lingered sub-runs the source evicted under its
own pressure fall back to the host tier (counted in ``fallback_pages``).
Fetched runs *move* (single-owner accounting): they are dropped from the
source pool and consumed from the directory.

Copied from the JAX package's ``cluster/prefetch.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.migration import (
    PeerGroup,
    TieredMigration,
    plan_population_runs,
)
from repro_torch.core.pages import PageRun, merge_runs, run_page_count, subtract_runs
from repro_torch.core.planner import partition_source_tiers
from repro_torch.core.simulator import SimCore
from repro_torch.cluster.topology import ClusterTopology, LingerEntry, PageDirectory


@dataclasses.dataclass
class PeerFetchEvent:
    """One committed peer-HBM fetch, for reporting: ``pages`` moved from
    ``src`` to ``dst`` over NVLink, landing at ``arrival_us``;
    ``fallback_pages`` of the same switch's lingered set had already been
    evicted by the source and took the host tier instead."""

    time_us: float
    task_id: int
    src: str
    dst: str
    pages: int
    nbytes: int
    arrival_us: float
    fallback_pages: int


class PeerPrefetchFabric:
    """Owns the page-location directory and wires the per-core cluster hooks.

    Built by ``simulate_cluster`` for NVLink-bearing topologies with the
    ``msched`` backend; a peer-less fleet never constructs one, which is the
    structural guarantee that plain compositions stay bit-for-bit with the
    single-GPU engine.
    """

    def __init__(self, topology: ClusterTopology, cores: Sequence[SimCore]):
        self.topology = topology
        self.cores: Dict[str, SimCore] = {c.name: c for c in cores}
        self.directory = PageDirectory()
        self.fetches: List[PeerFetchEvent] = []
        self.fallback_pages = 0  # lingered runs lost to source-side eviction
        self.fresh_pages = 0  # populated pages never held by any peer
        self.reclaimed_pages = 0
        # linger copies reclaimed by the finish hook — i.e. at the instant
        # their task retired, instead of waiting for the next rebalance tick
        self.finish_reaped = 0
        # telemetry hub or None; assigned by simulate_cluster when tracing
        self.telemetry = None
        # TransferPlanner or None; assigned by simulate_cluster in
        # transfer_plan="auto" mode. When present, the cluster view applies
        # the planner's pressure feedback: a lingering copy whose refetch
        # saving no longer covers the local misses its retention causes is
        # left unprotected for the eviction scavenger.
        self.planner = None

    def wire(self) -> None:
        """Install ``peer_source`` + ``cluster_view`` on every MSched
        coordinator (um/suv have no coordinator; ideal keeps its idealized
        bound and ignores real interconnects by design), and the per-core
        finish hook that reaps a retired task's directory hint immediately
        — a task that finishes mid-flight (its lazy-migration manifest still
        in transit) must not leave its linger copy pinned on the source
        until the next rebalance tick."""
        for core in self.cores.values():
            core.finish_hook = self._on_finish
            if core.backend.name != "msched":
                continue
            coord = core.backend.coordinator
            coord.peer_source = self._make_peer_source(core)
            coord.cluster_view = self._make_cluster_view(core)

    def _on_finish(self, task_id: int, now: float) -> None:
        if self.directory.get(task_id) is None:
            return
        freed = self.release(task_id)
        if freed > 0:
            self.finish_reaped += freed

    # -- peer-sourced population ---------------------------------------------
    def _make_peer_source(self, core: SimCore):
        def plan(
            task_id: int,
            populated_runs: Sequence[PageRun],
            evicted_pages: int,
            now: float,
        ) -> Optional[TieredMigration]:
            return self._plan_fetch(
                core, task_id, populated_runs, evicted_pages, now
            )

        return plan

    def _plan_fetch(
        self,
        core: SimCore,
        task_id: int,
        populated_runs: Sequence[PageRun],
        evicted_pages: int,
        now: float,
    ) -> Optional[TieredMigration]:
        entry = self.directory.get(task_id)
        if entry is None:
            return None
        if entry.src == core.name:
            # the task ping-ponged back onto the GPU that still held its
            # old working set: admission re-owned those pages, the hint is
            # stale — drop it
            self.directory.forget(task_id)
            return None
        src_core = self.cores.get(entry.src)
        link = self.topology.nvlink_peer(entry.src, core.name)
        if src_core is None or link is None:
            # re-routed beyond NVLink reach: everything comes from host
            return None
        peer, lost, fresh = partition_source_tiers(
            populated_runs, entry.runs, src_core.pool.missing_runs
        )
        self.fallback_pages += run_page_count(lost)
        self.fresh_pages += run_page_count(fresh)
        if lost:
            # source-evicted sub-runs are gone for good: drop them from the
            # hint so later switches neither re-count the fallback nor keep
            # madvising stale runs through the cluster view
            self.directory.consume(task_id, lost)
            self._reclaim_if_exhausted(task_id, src_core)
        if not peer:
            return None
        nbytes = run_page_count(peer) * core.page_size
        plan = self.topology.plan_transfer(
            entry.src, core.name, nbytes, now,
            kind="peer_fetch", task_id=task_id,
        )
        if plan is None:  # direct edges never stage, but stay defensive
            return None
        rate = nbytes / max(plan.arrival_us - now, 1e-9)
        # the copy moves: drop it at the source (reclaiming linger space)
        # and shrink the directory hint to what still lingers
        src_core.pool.drop_runs(peer)
        self.directory.consume(task_id, peer)
        self._reclaim_if_exhausted(task_id, src_core)
        host_runs = subtract_runs(list(populated_runs), merge_runs(peer))
        host_mig = plan_population_runs(
            core.platform,
            host_runs,
            evicted_pages,
            core.backend.coordinator.pipelined,
            core.page_size,
        )
        fetch = PeerFetchEvent(
            now, task_id, entry.src, core.name,
            run_page_count(peer), nbytes, plan.arrival_us,
            run_page_count(lost),
        )
        self.fetches.append(fetch)
        if self.telemetry is not None:
            # transit is NOT ledger-attributed here: the fetch overlaps the
            # switch, and any wait the task actually experiences surfaces as
            # the backend's ready-view delay (migration-wait, in-slice)
            self.telemetry.span(
                "peer_fetch",
                core.name,
                now,
                plan.arrival_us - now,
                task_id=task_id,
                src=entry.src,
                pages=fetch.pages,
                nbytes=nbytes,
                fallback_pages=fetch.fallback_pages,
            )
        return TieredMigration(
            host_mig, [PeerGroup(entry.src, peer, rate)], core.page_size
        )

    # -- fleet-level next-use (cluster-wide OPT) ------------------------------
    def _make_cluster_view(self, core: SimCore):
        def view(now: float) -> List[Tuple[float, List[PageRun]]]:
            out: List[Tuple[float, List[PageRun]]] = []
            for entry in self.directory.on_gpu(core.name):
                if self.planner is not None and not (
                    self.planner.linger_retention_ok(entry, core, now)
                ):
                    # pressure feedback: the refetch saving no longer pays
                    # for the holder's misses (or there is zero headroom) —
                    # leave the copy unprotected; the scavenger may take it
                    # and later fetches fall back to the host tier
                    continue
                est = self._next_use_estimate(entry, now)
                if est is not None:
                    out.append((est, entry.runs))
            return out

        return view

    def _next_use_estimate(
        self, entry: LingerEntry, now: float
    ) -> Optional[float]:
        """When the fleet will next touch a lingering working set: imminent
        if the continuation is running on its target GPU, one quantum per
        queue position if it is waiting behind admission, the manifest
        landing time if still in flight — and never (``None`` → stay
        unprotected, reaped soon) once it finished or was shed."""
        dst = self.cores.get(entry.dst)
        if dst is None or dst.failed:
            # a failed target's victims are resolved by the fault runtime at
            # the failure boundary; anything still pointing at it is garbage
            return None
        rec = dst.rec_by_tid.get(entry.task_id)
        if rec is not None and (rec.finished_us is not None or rec.rejected):
            return None
        if entry.task_id in dst.tasks:
            return max(now, dst.t)
        for pos, (ev, _rec, _pages) in enumerate(dst.waiting):
            if ev.program.task_id == entry.task_id:
                return max(now, dst.t) + (pos + 1) * dst.quantum
        return max(entry.arrival_us, now)

    def _reclaim_if_exhausted(self, task_id: int, src_core: SimCore) -> None:
        """A fully-consumed hint must also release the source's linger
        bookkeeping (the ``lingering`` flag and the registered task span)
        — otherwise every completed lazy migration leaks one stale entry
        on its source core for the rest of the run."""
        if self.directory.get(task_id) is None:
            self.reclaimed_pages += src_core.reclaim_linger(task_id)

    def harvest(self, task_id: int) -> Optional[List[PageRun]]:
        """Withdraw a task's lingering working set so it can travel with the
        task as warm runs (a steal or retry re-routed it to a GPU with *no*
        NVLink edge to the linger source — the copy must move through host
        staging with the task, like any stolen checkpoint, rather than be
        silently re-materialized from a host DRAM that never held it).
        Returns the still-resident runs (dropped from the source pool and
        forgotten from the directory), or ``None`` if nothing lingers."""
        entry = self.directory.forget(task_id)
        if entry is None:
            return None
        src = self.cores.get(entry.src)
        if src is None:
            return None
        gone = merge_runs(src.pool.missing_runs(entry.runs))
        live = subtract_runs(entry.runs, gone)
        src.pool.drop_runs(live)
        src.reclaim_linger(task_id)  # clears the flag; nothing left to free
        return live or None

    def drop_gpu(self, name: str) -> int:
        """A GPU failed: every linger hint *on* it is void (the peer-HBM
        copy vanished with the device — later fetches for those tasks fall
        back to host DRAM, where the backing copy lives). Entries pointing
        *at* the failed GPU (``dst``) are left alone: they are recovery
        sources for its victims, resolved by the fault runtime. Returns the
        number of entries dropped."""
        dropped = 0
        for entry in self.directory.entries():
            if entry.src == name:
                self.directory.forget(entry.task_id)
                dropped += 1
        return dropped

    # -- lifecycle -----------------------------------------------------------
    def release(self, task_id: int) -> int:
        """Reclaim a task's lingering copy outright (re-migration, terminal
        rejection). Returns pages reclaimed."""
        entry = self.directory.forget(task_id)
        if entry is None:
            return 0
        src = self.cores.get(entry.src)
        freed = src.reclaim_linger(task_id) if src is not None else 0
        self.reclaimed_pages += freed
        return freed

    def reap(self, final: bool = False) -> int:
        """Reclaim lingering copies the fleet no longer needs (their task
        finished or was shed on its target GPU); ``final`` reclaims
        everything so end-of-run HBM accounting balances. Called by the
        engine at rebalance ticks and after the terminal drain."""
        freed = 0
        for entry in self.directory.entries():
            if final or self._next_use_estimate(entry, 0.0) is None:
                freed += self.release(entry.task_id)
        return freed

    def peer_bytes(self) -> int:
        return sum(f.nbytes for f in self.fetches)
