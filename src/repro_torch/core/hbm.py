"""HBM residency pool with an explicit eviction list.

This is the library form of the paper's modified kernel-mode driver state:
an LRU-ordered eviction list over resident pages, with two new operations —

  madvise(pages)  — move pages to the list *tail*, protecting them (the new
                    ioctl MSched adds to the KMD, §6.2);
  migrate(pages)  — evict from the list *head* until there is room, then
                    populate the given pages (the new migrate engine).

Under demand paging, faults evict from the head (standard driver behavior).
Page keys are global integers (task address spaces are disjoint).

Two implementations share one interface:

``HBMPool`` (default) is *run-native*: residency is a doubly-linked chain of
page-run segments (contiguous in page space AND adjacent in list order, with
intra-segment order ascending) plus a sorted start-index for point/range
lookups. Every driver op — ``madvise_runs``/``migrate_runs``/``touch_runs``/
``populate_runs``/``drop_runs``/``free_task`` — costs O(segments touched +
log n) instead of O(pages), which is what lets 4 KiB simulation pages and
GiB-scale working sets stream through the simulator. The per-page semantics
are preserved exactly: visiting a run's pages in ascending order and moving
each to the OrderedDict tail yields the same list as splicing the run's
resident fragments to the chain tail in ascending order, so the eviction
order (and therefore every downstream SimResult) is bit-for-bit identical.

``HBMPoolPaged`` is the original per-page ``OrderedDict`` implementation,
selectable with ``simulate(..., pool="paged")`` and kept as the equivalence
reference for the randomized op-sequence suite.
"""
from __future__ import annotations

from bisect import bisect_left, bisect_right
from collections import OrderedDict
from typing import Dict, Iterable, Iterator, List, Sequence, Set, Tuple

from repro_torch.core.pages import PageRun, pages_to_runs


class _Seg:
    """One eviction-list segment: a half-open page run whose pages occupy
    consecutive list positions in ascending page order."""

    __slots__ = ("start", "stop", "prev", "nxt")

    def __init__(self, start: int, stop: int):
        self.start = start
        self.stop = stop
        self.prev: "_Seg | None" = None
        self.nxt: "_Seg | None" = None


class HBMPool:
    """Run-native eviction list (sorted disjoint segments + LRU chain)."""

    RUN_NATIVE = True

    def __init__(self, capacity_pages: int):
        assert capacity_pages > 0
        self.capacity = capacity_pages
        # LRU chain sentinels: head.nxt = next eviction victim segment
        self._h = _Seg(-1, -1)
        self._t = _Seg(-1, -1)
        self._h.nxt = self._t
        self._t.prev = self._h
        # sorted-by-start index over live segments (disjoint -> unique starts)
        self._starts: List[int] = []
        self._segs: List[_Seg] = []
        self._count = 0
        # task_id -> page span, registered so free_task() can find a retired
        # task's resident pages without scanning the whole list
        self._task_spans: Dict[int, PageRun] = {}
        # counters
        self.evictions = 0
        self.populations = 0
        self.freed_pages = 0

    # -- queries -------------------------------------------------------------
    def resident(self, page: int) -> bool:
        i = bisect_right(self._starts, page) - 1
        return i >= 0 and page < self._segs[i].stop

    def resident_count(self) -> int:
        return self._count

    @property
    def used(self) -> int:
        """Resident page count (alias of :meth:`resident_count`)."""
        return self._count

    def free_pages(self) -> int:
        return self.capacity - self._count

    def eviction_order(self) -> List[int]:
        """Full page list in eviction order. O(pages) — tests/debug only;
        hot paths use :meth:`eviction_runs` / :meth:`iter_eviction`."""
        return [p for s, e in self.eviction_runs() for p in range(s, e)]

    def eviction_runs(self) -> List[PageRun]:
        """Eviction order as segments (head first), without expansion."""
        out: List[PageRun] = []
        seg = self._h.nxt
        while seg is not self._t:
            out.append((seg.start, seg.stop))
            seg = seg.nxt
        return out

    def iter_eviction(self) -> Iterator[int]:
        """Lazy page iterator in eviction order (no list materialization)."""
        seg = self._h.nxt
        while seg is not self._t:
            yield from range(seg.start, seg.stop)
            seg = seg.nxt

    def resident_stretch_end(self, page: int) -> int:
        """Stop of the contiguous resident stretch containing ``page``
        (``page`` itself must be resident)."""
        i = bisect_right(self._starts, page) - 1
        return self._segs[i].stop

    # -- chain/index plumbing ------------------------------------------------
    def _index_remove(self, seg: _Seg) -> None:
        i = bisect_left(self._starts, seg.start)
        del self._starts[i]
        del self._segs[i]

    def _index_insert(self, seg: _Seg) -> None:
        i = bisect_left(self._starts, seg.start)
        self._starts.insert(i, seg.start)
        self._segs.insert(i, seg)

    @staticmethod
    def _unlink(seg: _Seg) -> None:
        seg.prev.nxt = seg.nxt
        seg.nxt.prev = seg.prev

    @staticmethod
    def _link_after(seg: _Seg, after: _Seg) -> None:
        seg.prev = after
        seg.nxt = after.nxt
        after.nxt.prev = seg
        after.nxt = seg

    def _append_tail(self, start: int, stop: int) -> None:
        """Place run ``[start, stop)`` at the chain tail (most-recent end),
        merging with the tail segment when it continues it ascending."""
        last = self._t.prev
        if last is not self._h and last.stop == start:
            last.stop = stop  # index start unchanged; no gap can exist inside
            return
        seg = _Seg(start, stop)
        self._link_after(seg, last)
        self._index_insert(seg)

    def _extract(self, a: int, b: int) -> List[PageRun]:
        """Detach the resident sub-runs of ``[a, b)`` from the chain (keeping
        any non-overlapping remainders at their list positions) and return
        them in ascending page order."""
        starts, segs = self._starts, self._segs
        i = bisect_right(starts, a) - 1
        if i < 0 or segs[i].stop <= a:
            i += 1
        out: List[PageRun] = []
        while i < len(starts) and starts[i] < b:
            seg = segs[i]
            lo = seg.start if seg.start > a else a
            hi = seg.stop if seg.stop < b else b
            out.append((lo, hi))
            if seg.start < lo and hi < seg.stop:
                # middle extraction: left keeps seg, right is a new segment
                right = _Seg(hi, seg.stop)
                seg.stop = lo
                self._link_after(right, seg)
                self._index_insert(right)
                i += 2
            elif seg.start < lo:
                seg.stop = lo
                i += 1
            elif hi < seg.stop:
                seg.start = hi
                starts[i] = hi
                i += 1
            else:
                self._unlink(seg)
                del starts[i]
                del segs[i]
        return out

    # -- driver ops ----------------------------------------------------------
    def touch(self, page: int) -> None:
        """LRU update on access (demand-paging behavior)."""
        i = bisect_right(self._starts, page) - 1
        if i < 0 or page >= self._segs[i].stop:
            return
        seg = self._segs[i]
        if seg.nxt is self._t and seg.stop == page + 1:
            return  # already the most-recent page
        for lo, hi in self._extract(page, page + 1):
            self._append_tail(lo, hi)

    def touch_runs(self, runs: Iterable[PageRun]) -> None:
        """LRU-update every *resident* page of ``runs``, in run order (the
        run-level form of per-page ``touch`` over a command's access order)."""
        for a, b in runs:
            for lo, hi in self._extract(a, b):
                self._append_tail(lo, hi)

    def madvise(self, pages: Iterable[int]) -> int:
        """Move resident pages to the tail (protect). Returns #moved."""
        n = 0
        for p in pages:
            if self.resident(p):
                self.touch(p)
                n += 1
        return n

    def madvise_runs(self, runs: Iterable[PageRun]) -> int:
        """``madvise`` over half-open page runs. Visits resident fragments in
        ascending order within each run — the same final list order as the
        per-page walk — at O(fragments) cost. Returns #pages moved."""
        n = 0
        for a, b in runs:
            for lo, hi in self._extract(a, b):
                self._append_tail(lo, hi)
                n += hi - lo
        return n

    def demote_runs(self, runs: Iterable[PageRun]) -> int:
        """Move the resident pages of ``runs`` (which must be disjoint) to
        the eviction-list *head* — the next victims. The inverse of
        ``madvise``: demoted pages are scavengeable, reclaimed before any
        protected page the moment the pool needs room. Pages end up at the
        head in ascending run order (the same order the per-page reference —
        ``move_to_front`` in reverse page order — produces). The cluster
        layer demotes a migrated-away task's lingering working set so a peer
        can prefetch it over NVLink while the local GPU loses nothing.
        Returns #pages moved."""
        frags: List[PageRun] = []
        for a, b in runs:
            frags.extend(self._extract(a, b))
        for lo, hi in reversed(frags):
            seg = _Seg(lo, hi)
            self._link_after(seg, self._h)
            self._index_insert(seg)
        return sum(hi - lo for lo, hi in frags)

    def evict_head(self) -> int:
        seg = self._h.nxt
        if seg is self._t:
            raise KeyError("pool is empty")
        page = seg.start
        if seg.stop - seg.start == 1:
            self._unlink(seg)
            self._index_remove(seg)
        else:
            i = bisect_left(self._starts, page)
            seg.start = page + 1
            self._starts[i] = page + 1
        self.evictions += 1
        self._count -= 1
        return page

    def _evict_head_run(self, n: int) -> List[PageRun]:
        """Evict ``n`` pages from the head as whole segments; returns the
        victim runs in eviction order."""
        out: List[PageRun] = []
        while n > 0:
            seg = self._h.nxt
            if seg is self._t:
                raise KeyError("pool is empty")
            size = seg.stop - seg.start
            if size <= n:
                out.append((seg.start, seg.stop))
                self._unlink(seg)
                self._index_remove(seg)
                self.evictions += size
                self._count -= size
                n -= size
            else:
                out.append((seg.start, seg.start + n))
                i = bisect_left(self._starts, seg.start)
                seg.start += n
                self._starts[i] = seg.start
                self.evictions += n
                self._count -= n
                n = 0
        return out

    def populate(self, page: int) -> List[int]:
        """Make one page resident (at the tail); returns evicted victims."""
        if self.resident(page):
            self.touch(page)
            return []
        victims = []
        while self._count >= self.capacity:
            victims.append(self.evict_head())
        self._append_tail(page, page + 1)
        self._count += 1
        self.populations += 1
        return victims

    def populate_runs(self, runs: Iterable[PageRun]) -> List[PageRun]:
        """Make every page of the (non-resident) ``runs`` resident at the
        tail, evicting from the head for room. Victims are returned as runs
        in eviction order. Closed-form equivalent of per-page ``populate``
        over each run: victims are the first ``max(0, count + L - capacity)``
        pages of the concatenated order [current list, run]; when a run
        exceeds capacity, its own leading pages count as populated *and*
        evicted without ever materializing (exactly what the per-page loop
        does to them)."""
        victims: List[PageRun] = []
        for a, b in runs:
            victims.extend(self._populate_run(a, b))
        return victims

    def _populate_run(self, a: int, b: int) -> List[PageRun]:
        need = self._count + (b - a) - self.capacity
        self.populations += b - a
        victims: List[PageRun] = []
        if need > 0:
            if need > self._count:
                overflow = need - self._count
                victims.extend(self._evict_head_run(self._count))
                # leading run pages: populated then immediately evicted
                victims.append((a, a + overflow))
                self.evictions += overflow
                a += overflow
            else:
                victims.extend(self._evict_head_run(need))
        self._append_tail(a, b)
        self._count += b - a
        return victims

    def migrate(self, pages: Iterable[int]) -> Tuple[List[int], List[int]]:
        """Proactively populate ``pages`` (in order), evicting from the head.

        Returns (populated, evicted) — only pages that actually moved.
        Per-page API preserved for callers holding explicit lists."""
        populated: List[int] = []
        evicted: List[int] = []
        for p in pages:
            if self.resident(p):
                self.touch(p)
                continue
            evicted.extend(self.populate(p))
            populated.append(p)
        return populated, evicted

    def migrate_runs(
        self, runs: Iterable[PageRun]
    ) -> Tuple[List[PageRun], List[PageRun]]:
        """``migrate`` over half-open page runs (first-access order), fully
        run-native: resident stretches are spliced to the tail, missing
        stretches are populated with batched head eviction. Returns
        (populated_runs, evicted_runs) — ``expand_runs`` of each equals the
        page lists the per-page path produces."""
        populated: List[PageRun] = []
        evicted: List[PageRun] = []
        starts, segs = self._starts, self._segs
        for a, b in runs:
            cur = a
            while cur < b:
                i = bisect_right(starts, cur) - 1
                if i >= 0 and cur < segs[i].stop:
                    # resident stretch: protect (splice to tail)
                    hi = min(segs[i].stop, b)
                    for lo, h2 in self._extract(cur, hi):
                        self._append_tail(lo, h2)
                    cur = hi
                else:
                    # missing stretch up to the next resident segment
                    j = bisect_right(starts, cur)
                    hi = min(b, starts[j]) if j < len(starts) else b
                    evicted.extend(self._populate_run(cur, hi))
                    if populated and populated[-1][1] == cur:
                        populated[-1] = (populated[-1][0], hi)
                    else:
                        populated.append((cur, hi))
                    cur = hi
        return populated, evicted

    def all_resident_runs(self, runs: Iterable[PageRun]) -> bool:
        starts, segs = self._starts, self._segs
        for a, b in runs:
            cur = a
            while cur < b:
                i = bisect_right(starts, cur) - 1
                if i < 0 or cur >= segs[i].stop:
                    return False
                cur = segs[i].stop
        return True

    def missing_runs(self, runs: Iterable[PageRun]) -> List[PageRun]:
        """Non-resident sub-runs of ``runs``, in run order — the run-level
        complement query the fault path is built on."""
        out: List[PageRun] = []
        starts, segs = self._starts, self._segs
        for a, b in runs:
            cur = a
            while cur < b:
                i = bisect_right(starts, cur) - 1
                if i >= 0 and cur < segs[i].stop:
                    cur = min(segs[i].stop, b)
                    continue
                j = bisect_right(starts, cur)
                hi = min(b, starts[j]) if j < len(starts) else b
                out.append((cur, hi))
                cur = hi
        return out

    def missing_pages(self, pages: Sequence[int]) -> List[int]:
        """Non-resident subset of ``pages``, in order (compat API)."""
        return [p for p in pages if not self.resident(p)]

    def drop(self, pages: Iterable[int]) -> None:
        """Remove pages without counting an eviction (task exit/free)."""
        for p in pages:
            self._count -= sum(hi - lo for lo, hi in self._discard(p, p + 1))

    def drop_runs(self, runs: Iterable[PageRun]) -> None:
        for a, b in runs:
            self._count -= sum(hi - lo for lo, hi in self._discard(a, b))

    def _discard(self, a: int, b: int) -> List[PageRun]:
        """Remove the resident sub-runs of ``[a, b)`` outright: ``_extract``
        already detaches every overlapping piece from the chain and index, so
        simply not re-appending them deletes them. Returns what was removed."""
        return self._extract(a, b)

    # -- task lifecycle ------------------------------------------------------
    def register_task(self, task_id: int, span: PageRun) -> None:
        """Declare the page span a task's address space occupies, so its
        residual pages can be reclaimed when the task retires."""
        self._task_spans[task_id] = span

    def free_task(self, task_id: int) -> int:
        """Reclaim a retired task's resident pages (process exit: the driver
        frees the whole address space). Freed pages don't count as evictions.
        Returns the number of pages actually reclaimed."""
        span = self._task_spans.pop(task_id, None)
        if span is None:
            return 0
        freed = sum(hi - lo for lo, hi in self._discard(span[0], span[1]))
        self._count -= freed
        self.freed_pages += freed
        return freed

    def wipe(self) -> int:
        """Release every resident page and every task registration at once
        (device failure: HBM contents are gone). Counts as freed pages, not
        evictions. Returns the number of pages released."""
        freed = self._count
        self._h.nxt = self._t
        self._t.prev = self._h
        self._starts.clear()
        self._segs.clear()
        self._count = 0
        self._task_spans.clear()
        self.freed_pages += freed
        return freed


class HBMPoolPaged:
    """Original per-page ``OrderedDict`` pool (the straightforward reference
    implementation). Selectable with ``simulate(..., pool="paged")``; the
    randomized equivalence suite drives it against :class:`HBMPool`."""

    RUN_NATIVE = False

    def __init__(self, capacity_pages: int):
        assert capacity_pages > 0
        self.capacity = capacity_pages
        # insertion order == eviction order; first item = next eviction victim
        self._list: "OrderedDict[int, None]" = OrderedDict()
        self._task_spans: Dict[int, PageRun] = {}
        self.evictions = 0
        self.populations = 0
        self.freed_pages = 0

    # -- queries -------------------------------------------------------------
    def resident(self, page: int) -> bool:
        return page in self._list

    def resident_count(self) -> int:
        return len(self._list)

    @property
    def used(self) -> int:
        return self.resident_count()

    def free_pages(self) -> int:
        return self.capacity - len(self._list)

    def eviction_order(self) -> List[int]:
        return list(self._list.keys())

    def eviction_runs(self) -> List[PageRun]:
        return list(pages_to_runs(self.eviction_order()))

    def iter_eviction(self) -> Iterator[int]:
        return iter(self._list.keys())

    # -- driver ops ----------------------------------------------------------
    def touch(self, page: int) -> None:
        if page in self._list:
            self._list.move_to_end(page)

    def touch_runs(self, runs: Iterable[PageRun]) -> None:
        lst = self._list
        for start, stop in runs:
            for p in range(start, stop):
                if p in lst:
                    lst.move_to_end(p)

    def madvise(self, pages: Iterable[int]) -> int:
        n = 0
        for p in pages:
            if p in self._list:
                self._list.move_to_end(p)
                n += 1
        return n

    def madvise_runs(self, runs: Iterable[PageRun]) -> int:
        n = 0
        lst = self._list
        for start, stop in runs:
            for p in range(start, stop):
                if p in lst:
                    lst.move_to_end(p)
                    n += 1
        return n

    def demote_runs(self, runs: Iterable[PageRun]) -> int:
        """Per-page reference of :meth:`HBMPool.demote_runs`: walking the
        disjoint runs' pages in reverse and moving each to the front leaves
        the demoted pages at the head in ascending run order."""
        n = 0
        lst = self._list
        for start, stop in reversed(list(runs)):
            for p in reversed(range(start, stop)):
                if p in lst:
                    lst.move_to_end(p, last=False)
                    n += 1
        return n

    def evict_head(self) -> int:
        page, _ = self._list.popitem(last=False)
        self.evictions += 1
        return page

    def populate(self, page: int) -> List[int]:
        if page in self._list:
            self._list.move_to_end(page)
            return []
        victims = []
        while len(self._list) >= self.capacity:
            victims.append(self.evict_head())
        self._list[page] = None
        self.populations += 1
        return victims

    def populate_runs(self, runs: Iterable[PageRun]) -> List[PageRun]:
        victims: List[int] = []
        for start, stop in runs:
            for p in range(start, stop):
                victims.extend(self.populate(p))
        return list(pages_to_runs(victims))

    def migrate(self, pages: Iterable[int]) -> Tuple[List[int], List[int]]:
        populated: List[int] = []
        evicted: List[int] = []
        for p in pages:
            if p in self._list:
                self._list.move_to_end(p)
                continue
            evicted.extend(self.populate(p))
            populated.append(p)
        return populated, evicted

    def migrate_runs(
        self, runs: Iterable[PageRun]
    ) -> Tuple[List[PageRun], List[PageRun]]:
        populated, evicted = self.migrate(
            p for start, stop in runs for p in range(start, stop)
        )
        return list(pages_to_runs(populated)), list(pages_to_runs(evicted))

    def all_resident_runs(self, runs: Iterable[PageRun]) -> bool:
        lst = self._list
        return all(p in lst for start, stop in runs for p in range(start, stop))

    def missing_runs(self, runs: Iterable[PageRun]) -> List[PageRun]:
        return list(
            pages_to_runs(
                [
                    p
                    for start, stop in runs
                    for p in range(start, stop)
                    if p not in self._list
                ]
            )
        )

    def missing_pages(self, pages: Sequence[int]) -> List[int]:
        lst = self._list
        return [p for p in pages if p not in lst]

    def drop(self, pages: Iterable[int]) -> None:
        for p in pages:
            self._list.pop(p, None)

    def drop_runs(self, runs: Iterable[PageRun]) -> None:
        for start, stop in runs:
            for p in range(start, stop):
                self._list.pop(p, None)

    # -- task lifecycle ------------------------------------------------------
    def register_task(self, task_id: int, span: PageRun) -> None:
        self._task_spans[task_id] = span

    def free_task(self, task_id: int) -> int:
        span = self._task_spans.pop(task_id, None)
        if span is None:
            return 0
        lst = self._list
        lo, hi = span
        if hi - lo <= len(lst):
            freed = [p for p in range(lo, hi) if p in lst]
        else:
            freed = [p for p in lst if lo <= p < hi]
        for p in freed:
            del lst[p]
        self.freed_pages += len(freed)
        return len(freed)

    def wipe(self) -> int:
        """Release everything at once (device failure); see
        :meth:`HBMPool.wipe`."""
        freed = len(self._list)
        self._list.clear()
        self._task_spans.clear()
        self.freed_pages += freed
        return freed


def resident_runs_in(pool, span: PageRun) -> List[PageRun]:
    """Resident sub-runs of ``span`` in ascending page order, computed as the
    complement of :meth:`missing_runs` so it works on both pool
    implementations without touching their state. Used by the cluster's
    inter-GPU migration path to snapshot a task's live working set."""
    lo, hi = span
    out: List[PageRun] = []
    cur = lo
    for s, e in pool.missing_runs([(lo, hi)]):
        if s > cur:
            out.append((cur, s))
        cur = e
    if cur < hi:
        out.append((cur, hi))
    return out


def make_pool(kind: str, capacity_pages: int):
    """``"run"`` (default run-native) or ``"paged"`` (per-page reference)."""
    if kind == "run":
        return HBMPool(capacity_pages)
    if kind == "paged":
        return HBMPoolPaged(capacity_pages)
    raise ValueError(f"unknown pool kind {kind!r} (use 'run' or 'paged')")
