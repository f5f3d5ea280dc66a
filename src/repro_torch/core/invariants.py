"""Fleet-wide invariant auditing: prove the memory accounting survives
failures.

The simulator's pools, cores, and cluster directories each keep redundant
views of the same state (LRU chain vs. sorted index, linger flags vs.
directory entries, staging intervals vs. host budget). In steady state the
views agree by construction; a *failure* — GPU loss, link flap, task crash —
is exactly the kind of event that can silently break one view while the
others limp on. :class:`InvariantAuditor` cross-checks them, read-only, so
tests (and ``simulate_cluster(..., audit=True)``) can assert at every
failure boundary that no page was duplicated, leaked, or double-freed.

Everything here is strictly observational: auditing never mutates a pool,
directory, or core, so an audited run is bit-for-bit identical to an
unaudited one.

Copied from the JAX package's ``core/invariants.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence

from repro_torch.core.pages import (
    PageRun,
    merge_runs,
    pages_to_runs,
    run_page_count,
    subtract_runs,
)


class InvariantViolation(AssertionError):
    """Raised by :class:`InvariantAuditor` (and the ``audit_*`` helpers)
    when a cross-check fails. Subclasses ``AssertionError`` so plain
    ``pytest.raises(AssertionError)`` also catches it."""


def _resident_runs(pool) -> List[PageRun]:
    """Merged resident runs of either pool kind, via public-ish state."""
    if getattr(pool, "RUN_NATIVE", False):
        return [(s.start, s.stop) for s in pool._segs]
    return list(pages_to_runs(sorted(pool._list)))


def audit_pool(pool, name: str = "pool") -> List[str]:
    """Page-conservation checks on one HBM pool. Returns human-readable
    violation strings (empty = clean)."""
    bad: List[str] = []
    used = pool.used
    if used < 0:
        bad.append(f"{name}: negative resident count {used}")
    if used > pool.capacity:
        bad.append(f"{name}: resident {used} exceeds capacity {pool.capacity}")
    if getattr(pool, "RUN_NATIVE", False):
        # chain vs. count
        chain = pool.eviction_runs()
        chain_pages = sum(e - s for s, e in chain)
        if chain_pages != pool._count:
            bad.append(
                f"{name}: LRU chain holds {chain_pages} pages but _count is "
                f"{pool._count}"
            )
        # chain vs. sorted index (same segments, as multisets)
        index = [(s.start, s.stop) for s in pool._segs]
        if sorted(chain) != sorted(index):
            bad.append(
                f"{name}: chain segments {sorted(chain)[:4]}... disagree "
                f"with index {sorted(index)[:4]}..."
            )
        # index sorted, aligned, disjoint
        if pool._starts != [s for s, _ in index]:
            bad.append(f"{name}: _starts out of sync with segment index")
        if any(a >= b for a, b in index):
            bad.append(f"{name}: empty/inverted segment in index")
        if any(
            index[i][1] > index[i + 1][0] for i in range(len(index) - 1)
        ):
            bad.append(f"{name}: overlapping segments in index")
    else:
        if len(pool._list) != used:
            bad.append(f"{name}: paged list/count mismatch")
    # every resident page must belong to some registered task span
    spans = merge_runs(list(pool._task_spans.values()))
    orphans = subtract_runs(_resident_runs(pool), spans)
    if orphans:
        bad.append(
            f"{name}: {run_page_count(orphans)} resident pages outside every "
            f"registered task span (e.g. {orphans[0]})"
        )
    return bad


def audit_core(core) -> List[str]:
    """Per-core coherence checks (pool included)."""
    name = core.name
    bad = audit_pool(core.pool, f"{name}.pool")
    if core.failed:
        # a failed core must be fully quiescent — fail() surrendered
        # everything, and nothing may have been injected since
        if core.tasks or core.waiting or core.pending:
            bad.append(f"{name}: failed core still holds work")
        if core.pool.used != 0:
            bad.append(
                f"{name}: failed core still has {core.pool.used} resident "
                f"pages"
            )
        if core.lingering:
            bad.append(f"{name}: failed core still flags linger copies")
        if core._warm_runs:
            bad.append(f"{name}: failed core still holds warm runs")
        return bad
    queued_ids = {ev.program.task_id for ev in core.pending} | {
        ev.program.task_id for ev, _rec, _pages in core.waiting
    }
    stale_warm = set(core._warm_runs) - queued_ids
    if stale_warm:
        bad.append(
            f"{name}: warm runs held for non-queued tasks {sorted(stale_warm)}"
        )
    waiting_pages = sum(pages for _ev, _rec, pages in core.waiting)
    if waiting_pages != core._waiting_pages:
        bad.append(
            f"{name}: _waiting_pages {core._waiting_pages} != queue sum "
            f"{waiting_pages}"
        )
    for tid in core.lingering:
        if tid in core.tasks:
            bad.append(f"{name}: task {tid} both running and lingering")
        if tid not in core.pool._task_spans:
            bad.append(
                f"{name}: lingering task {tid} has no registered span "
                f"(double-free?)"
            )
    for rec in core.records:
        if rec.finished_us is not None and rec.rejected:
            bad.append(
                f"{name}: task {rec.task_id} both finished and rejected"
            )
    return bad


class InvariantAuditor:
    """Cross-layer auditor for a (possibly single-GPU) fleet.

    Wire it with whatever layers exist — ``topology``/``fabric``/``vault``
    are optional — and call :meth:`check` at interesting boundaries. With
    ``raise_on_violation`` (the default) the first dirty check raises
    :class:`InvariantViolation` listing every violation found; otherwise
    violations accumulate in :attr:`violations` for later assertion.
    """

    def __init__(
        self,
        cores: Sequence,
        topology=None,
        fabric=None,
        vault=None,
        control=None,
        raise_on_violation: bool = True,
    ):
        self.cores = list(cores)
        self.topology = topology
        self.fabric = fabric
        self.vault = vault
        # ControlPlane or None: while the coordinator is down the directory
        # is legitimately empty but linger copies survive on the cores, so
        # the orphaned-copy reverse check is suspended (recovery must close
        # the window — replay rebuilds the entries or reclaims the copies,
        # and the post-recovery audit enforces it again)
        self.control = control
        self.raise_on_violation = raise_on_violation
        self.violations: List[str] = []
        self.checks = 0

    # -- sub-audits ----------------------------------------------------------
    def _audit_directory(self) -> List[str]:
        bad: List[str] = []
        by_name = {c.name: c for c in self.cores}
        entries = self.fabric.directory.entries()
        for e in entries:
            src = by_name.get(e.src)
            if src is None:
                bad.append(f"directory: entry {e.task_id} on unknown GPU {e.src}")
                continue
            if src.failed:
                bad.append(
                    f"directory: entry {e.task_id} lingers on failed GPU "
                    f"{e.src}"
                )
                continue
            if e.task_id not in src.lingering:
                bad.append(
                    f"directory: entry {e.task_id} on {e.src} but the core "
                    f"does not flag it lingering"
                )
            span = src.pool._task_spans.get(e.task_id)
            if span is None:
                bad.append(
                    f"directory: entry {e.task_id} has no span on {e.src}"
                )
            elif subtract_runs(e.runs, [span]):
                bad.append(
                    f"directory: entry {e.task_id} hints runs outside its "
                    f"span on {e.src}"
                )
            if e.dst not in by_name:
                bad.append(
                    f"directory: entry {e.task_id} targets unknown GPU {e.dst}"
                )
        # reverse: every flagged linger copy must be findable via the
        # directory (else it is unreclaimable — a leak). Suspended while
        # the coordinator is down: the directory died with it, and the
        # copies are exactly what recovery must re-hint or reclaim.
        if self.control is not None and self.control.down:
            return bad
        hinted = {(e.src, e.task_id) for e in entries}
        for core in self.cores:
            for tid in core.lingering:
                if (core.name, tid) not in hinted:
                    bad.append(
                        f"{core.name}: linger flag for task {tid} has no "
                        f"directory entry (orphaned copy)"
                    )
        return bad

    def _audit_topology(self, now: float) -> List[str]:
        bad: List[str] = []
        topo = self.topology
        for start, end, nbytes in topo._staged:
            if nbytes <= 0:
                bad.append(f"topology: staged interval with {nbytes} bytes")
            if end < start:
                bad.append(
                    f"topology: staged interval ends before it starts "
                    f"({start} > {end})"
                )
        in_flight = topo.host_staged_bytes(now)
        if in_flight > topo.host_dram_bytes:
            bad.append(
                f"topology: {in_flight} staged bytes exceed the host budget "
                f"{topo.host_dram_bytes}"
            )
        links = {l.key() for l in topo.links()}
        for key, factor in topo._degraded.items():
            if key not in links:
                bad.append(f"topology: degrade entry for unknown link {key}")
            if not 0.0 <= factor <= 1.0:
                bad.append(f"topology: degrade factor {factor} out of range")
        if topo.deferred < 0:
            bad.append("topology: negative deferral count")
        return bad

    def _audit_vault(self) -> List[str]:
        bad: List[str] = []
        for tid, cks in self.vault._by_task.items():
            if len(cks) > self.vault.keep:
                bad.append(
                    f"vault: {len(cks)} checkpoints kept for task {tid} "
                    f"(cap {self.vault.keep})"
                )
            for ck in cks:
                if ck.task_id != tid:
                    bad.append(f"vault: checkpoint keyed under wrong task {tid}")
                if ck.ready_us < ck.taken_us:
                    bad.append(
                        f"vault: checkpoint for task {tid} ready before taken"
                    )
                if ck.nbytes < 0 or ck.completed < 0:
                    bad.append(f"vault: negative checkpoint fields for {tid}")
        return bad

    # -- entry point ---------------------------------------------------------
    def check(self, now: float = 0.0, where: str = "") -> List[str]:
        """Run every wired audit. Returns (and records) the violations."""
        self.checks += 1
        bad: List[str] = []
        for core in self.cores:
            bad.extend(audit_core(core))
        if self.fabric is not None:
            bad.extend(self._audit_directory())
        if self.topology is not None:
            bad.extend(self._audit_topology(now))
        if self.vault is not None:
            bad.extend(self._audit_vault())
        if bad:
            tagged = [f"[{where or 'audit'}@{now:.0f}us] {b}" for b in bad]
            self.violations.extend(tagged)
            if self.raise_on_violation:
                raise InvariantViolation(
                    f"{len(bad)} invariant violation(s):\n  "
                    + "\n  ".join(tagged)
                )
        return bad
