"""Page-granular address spaces and buffers.

Each task owns a virtual address space; buffers are page-aligned allocations
(the analogue of cudaMalloc regions / framework memory pools). Extents are
(start, size) byte ranges; pages are integer page indices global to a task.

Page *runs* are the run-length form used by the planning hot path: a run is a
half-open ``(first_page, stop_page)`` interval, so GiB-scale working sets are
carried around as a handful of intervals instead of huge int sets.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_left, bisect_right
from typing import Dict, Iterable, List, Sequence, Set, Tuple

Extent = Tuple[int, int]  # (start byte, size in bytes)
PageRun = Tuple[int, int]  # half-open page interval (first_page, stop_page)


@dataclasses.dataclass(frozen=True)
class Buffer:
    buf_id: int
    base: int
    size: int
    label: str = ""

    @property
    def end(self) -> int:
        return self.base + self.size

    def slice(self, offset: int, size: int) -> Extent:
        assert 0 <= offset and offset + size <= self.size, (offset, size, self.size)
        return (self.base + offset, size)


class AddressSpace:
    """Bump allocator with page alignment (frees recycle only at the end)."""

    def __init__(self, page_size: int = 4096, base: int = 0x10_0000_0000):
        self.page_size = page_size
        self._base = base
        self._next = base
        self._next_id = 0
        self.buffers: Dict[int, Buffer] = {}
        # sorted-by-base index for O(log n) pointer lookups (bases are
        # monotonic under the bump allocator, so malloc is a plain append)
        self._bases: List[int] = []
        self._by_base: List[Buffer] = []
        # memoized extent-tuple -> page-run decode (see page_runs_of_extents)
        self._run_cache: Dict[Tuple[Extent, ...], Tuple[PageRun, ...]] = {}

    def malloc(self, size: int, label: str = "") -> Buffer:
        aligned = _round_up(size, self.page_size)
        buf = Buffer(self._next_id, self._next, size, label)
        self.buffers[buf.buf_id] = buf
        self._bases.append(buf.base)
        self._by_base.append(buf)
        self._next += aligned
        self._next_id += 1
        return buf

    def page_span(self) -> PageRun:
        """Half-open page interval covering every allocation ever made in
        this space (bump allocator: the span never shrinks)."""
        return (self._base // self.page_size, _round_up(self._next, self.page_size) // self.page_size)

    def release(self) -> PageRun:
        """Tear the space down (task exit): drop every buffer and cache and
        return the page span the owner must reclaim from the HBM pool."""
        span = self.page_span()
        self.buffers.clear()
        self._bases.clear()
        self._by_base.clear()
        self._run_cache.clear()
        return span

    def free(self, buf: Buffer) -> None:
        if self.buffers.pop(buf.buf_id, None) is None:
            return
        # zero-size allocations can share a base; match on buf_id
        i = bisect_left(self._bases, buf.base)
        while i < len(self._bases) and self._bases[i] == buf.base:
            if self._by_base[i].buf_id == buf.buf_id:
                del self._bases[i]
                del self._by_base[i]
                return
            i += 1

    def find_buffer(self, addr: int) -> Buffer | None:
        """Containing allocation for a pointer (allocation-granularity path)."""
        i = bisect_right(self._bases, addr) - 1
        if i >= 0:
            b = self._by_base[i]
            if addr < b.end:
                return b
        return None

    # -- page helpers -------------------------------------------------------
    def pages_of_extent(self, ext: Extent) -> range:
        start, size = ext
        if size <= 0:
            return range(0)
        first = start // self.page_size
        last = (start + size - 1) // self.page_size
        return range(first, last + 1)

    def pages_of(self, extents: Iterable[Extent]) -> Set[int]:
        pages: Set[int] = set()
        for ext in extents:
            pages.update(self.pages_of_extent(ext))
        return pages

    def total_pages(self) -> int:
        return sum(_round_up(b.size, self.page_size) for b in self.buffers.values()) // self.page_size

    def page_runs_of_extents(
        self, extents: Iterable[Extent]
    ) -> Tuple[PageRun, ...]:
        """Deduplicated page runs in first-access order.

        Run-length equivalent of the per-page first-touch walk: expanding the
        result with :func:`expand_runs` yields exactly the page order the old
        per-page decode produced, but the decode itself never materializes
        individual pages. Results are memoized per extent tuple — repeated
        command shapes (the common case for iteration-structured workloads)
        decode once per address space, which is what makes `annotate()`-time
        caching O(1) amortized.
        """
        key = extents if isinstance(extents, tuple) else tuple(extents)
        cached = self._run_cache.get(key)
        if cached is not None:
            return cached
        seen = RunSet()
        out: List[PageRun] = []
        ps = self.page_size
        for start, size in key:
            if size <= 0:
                continue
            out.extend(seen.add(start // ps, (start + size - 1) // ps + 1))
        runs = tuple(out)
        if len(self._run_cache) >= 8192:
            self._run_cache.clear()
        self._run_cache[key] = runs
        return runs


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def merge_extents(extents: List[Extent]) -> List[Extent]:
    """Coalesce overlapping/adjacent byte ranges (canonical trace form)."""
    if not extents:
        return []
    xs = sorted(extents)
    out = [list(xs[0])]
    for s, sz in xs[1:]:
        cs, csz = out[-1]
        if s <= cs + csz:
            out[-1][1] = max(cs + csz, s + sz) - cs
        else:
            out.append([s, sz])
    return [tuple(e) for e in out]


def extents_bytes(extents: Iterable[Extent]) -> int:
    return sum(sz for _, sz in merge_extents(list(extents)))


# --------------------------------------------------------------------------
# Page-run (interval) helpers — the planning hot path's working currency
# --------------------------------------------------------------------------


def merge_runs(runs: Iterable[PageRun]) -> List[PageRun]:
    """Coalesce page runs into a sorted disjoint interval list. Expanding the
    result yields the same pages as ``sorted(set(expand_runs(runs)))``."""
    xs = sorted(runs)
    if not xs:
        return []
    out: List[PageRun] = []
    cs, ce = xs[0]
    for s, e in xs:
        if s <= ce:
            if e > ce:
                ce = e
        else:
            out.append((cs, ce))
            cs, ce = s, e
    out.append((cs, ce))
    return out


def expand_runs(runs: Iterable[PageRun]) -> List[int]:
    return [p for s, e in runs for p in range(s, e)]


def run_page_count(runs: Iterable[PageRun]) -> int:
    return sum(e - s for s, e in runs)


def pages_to_runs(pages: Sequence[int]) -> Tuple[PageRun, ...]:
    """Order-preserving coalesce of an explicit page list (ascending
    consecutive pages fold into one run)."""
    runs: List[List[int]] = []
    for p in pages:
        if runs and p == runs[-1][1]:
            runs[-1][1] = p + 1
        else:
            runs.append([p, p + 1])
    return tuple((s, e) for s, e in runs)


def intersect_runs(
    runs: Iterable[PageRun], other: Sequence[PageRun]
) -> List[PageRun]:
    """Sub-runs of ``runs`` covered by ``other`` (which must be sorted and
    disjoint — e.g. a ``merge_runs`` result), preserving the order of
    ``runs``. The run-level form of ``[p for p in pages if p in other]``."""
    starts = [s for s, _ in other]
    out: List[PageRun] = []
    for a, b in runs:
        i = max(0, bisect_right(starts, a) - 1)
        while i < len(other) and other[i][0] < b:
            s, e = other[i]
            lo, hi = max(a, s), min(b, e)
            if lo < hi:
                out.append((lo, hi))
            i += 1
    return out


def subtract_runs(
    runs: Iterable[PageRun], remove: Sequence[PageRun]
) -> List[PageRun]:
    """Sub-runs of ``runs`` *not* covered by ``remove`` (sorted, disjoint),
    preserving the order of ``runs`` — the order-preserving complement of
    :func:`intersect_runs`."""
    starts = [s for s, _ in remove]
    out: List[PageRun] = []
    for a, b in runs:
        cur = a
        i = bisect_right(starts, a) - 1
        if i < 0 or remove[i][1] <= a:
            i += 1
        while cur < b and i < len(remove) and remove[i][0] < b:
            s, e = remove[i]
            if s > cur:
                out.append((cur, s))
            cur = max(cur, min(e, b))
            i += 1
        if cur < b:
            out.append((cur, b))
    return out


def clip_runs(runs: Iterable[PageRun], max_pages: int) -> List[PageRun]:
    """First ``max_pages`` pages of ``runs`` in order (run-level equivalent
    of ``expand_runs(runs)[:max_pages]``)."""
    out: List[PageRun] = []
    left = max_pages
    for s, e in runs:
        if left <= 0:
            break
        take = min(left, e - s)
        out.append((s, s + take))
        left -= take
    return out


class RunSet:
    """Sorted disjoint interval set with insert-and-report-new support.

    ``add`` inserts a half-open page interval and returns the sub-runs that
    were *not* already present, in ascending order — exactly the pieces a
    first-touch dedup walk would have appended page by page. All operations
    are O(log n + k) in the number of stored intervals.
    """

    def __init__(self) -> None:
        self._starts: List[int] = []
        self._stops: List[int] = []

    def add(self, start: int, stop: int) -> List[PageRun]:
        if start >= stop:
            return []
        starts, stops = self._starts, self._stops
        i = bisect_right(starts, start) - 1
        lo = i if (i >= 0 and stops[i] >= start) else i + 1
        new_runs: List[PageRun] = []
        cur = start
        j = lo
        while j < len(starts) and starts[j] <= stop:
            if starts[j] > cur:
                new_runs.append((cur, starts[j]))
            cur = max(cur, stops[j])
            j += 1
        if cur < stop:
            new_runs.append((cur, stop))
        if lo < j:
            starts[lo:j] = [min(start, starts[lo])]
            stops[lo:j] = [max(stop, stops[j - 1 if j > lo else lo])]
        else:
            starts[lo:lo] = [start]
            stops[lo:lo] = [stop]
        return new_runs

    def __contains__(self, page: int) -> bool:
        i = bisect_right(self._starts, page) - 1
        return i >= 0 and page < self._stops[i]

    def runs(self) -> List[PageRun]:
        return list(zip(self._starts, self._stops))
