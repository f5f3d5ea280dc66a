"""Demand-paging (CUDA UM) baseline emulation (§2.3, §3).

TPUs cannot page-fault, so the UM baseline is an explicit cost model
calibrated from the paper's measurements: 31.79 µs per fault (96 % control
plane), LRU eviction from the driver list head, and a UM-style neighborhood
prefetch (fault groups) that explains why migrated volume exceeds
faults × 4 KiB (paper Fig. 6c).

``access_runs`` is the hot path: with a run-native pool it services faults
per missing *run* — fault counts, prefetch volume, and batched evictions in
closed form over interval arithmetic — instead of one Python-loop iteration
per page. Stall times are accumulated with the exact same per-page float
rounding as the scalar loop (``np.add.accumulate`` is sequential), so the
vectorized path is bit-for-bit identical to ``access`` + ``HBMPoolPaged``.

Copied from the JAX package's ``core/demand_paging.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import Platform
from repro_torch.core.hbm import HBMPool
from repro_torch.core.pages import PageRun, run_page_count

# below this many pages a plain Python loop beats the numpy setup cost
_VECTOR_MIN_PAGES = 256


@dataclasses.dataclass
class FaultStats:
    faults: int = 0
    migrated_pages: int = 0
    evicted_pages: int = 0
    fault_us: float = 0.0


class DemandPager:
    def __init__(self, platform: Platform, pool: HBMPool, page_size: int = 0):
        self.platform = platform
        self.pool = pool
        self.page_size = page_size or platform.page_size  # simulation page
        self.stats = FaultStats()

    # -- shared rate math ----------------------------------------------------
    def _rates(self) -> Tuple[float, float, int]:
        """(h2d bytes/µs for the serialized UM fault path, group bytes,
        eviction batch pages)."""
        # the UM fault path serializes eviction and population on one engine:
        # effective data rate is the harmonic combination of both directions
        d2h = self.platform.d2h_gbps * 1e3
        h2d_only = self.platform.h2d_gbps * 1e3
        h2d = 1.0 / (1.0 / d2h + 1.0 / h2d_only)  # bytes/us
        group_bytes = 4096 * max(1, self.platform.um_prefetch_pages)
        batch = max(1, self.platform.um_evict_batch_bytes // self.page_size)
        return h2d, group_bytes, batch

    # -- per-page reference path --------------------------------------------
    def access(self, pages: List[int]) -> float:
        """Serve a kernel's accesses; returns the stall time in µs.

        UM migrates in 64 KiB fault groups (4 KiB faulting page + 60 KiB
        neighborhood), one CPU-serviced fault per group. When the simulation
        page is larger than a fault group, a missing page costs
        ``page/64KiB`` faults; when smaller, a fault brings in the whole
        aligned group (which is why UM's migrated volume exceeds
        faults × 4 KiB — paper Fig. 6c).

        This is the straightforward per-page implementation; the simulator's
        hot path uses :meth:`access_runs`, which must stay bit-for-bit
        equivalent (see tests/core/test_run_native_pool.py).
        """
        stall = 0.0
        p_sz = self.page_size
        h2d, group_bytes, batch = self._rates()
        if p_sz >= group_bytes:
            units_per_page = (p_sz + group_bytes - 1) // group_bytes
            for p in pages:
                if self.pool.resident(p):
                    self.pool.touch(p)
                    continue
                self.stats.faults += units_per_page
                stall += units_per_page * self.platform.fault_total_us
                # non-faulting remainder of each group moves at batched H2D
                stall += (p_sz - units_per_page * 4096) / h2d
                self._batch_evict(batch)
                evicted = self.pool.populate(p)
                self.stats.evicted_pages += len(evicted)
                self.stats.migrated_pages += 1
            return stall
        # 4 KiB simulation pages: fault + neighborhood prefetch
        group = group_bytes // p_sz
        for p in pages:
            if self.pool.resident(p):
                self.pool.touch(p)
                continue
            self.stats.faults += 1
            stall += self.platform.fault_total_us
            self._batch_evict(batch)
            base = (p // group) * group
            extra = [
                q
                for q in range(base, base + group)
                if q != p and not self.pool.resident(q)
            ]
            for q in [p] + extra:
                evicted = self.pool.populate(q)
                self.stats.evicted_pages += len(evicted)
                self.stats.migrated_pages += 1
            stall += len(extra) * p_sz / h2d
        return stall

    def _batch_evict(self, batch: int) -> None:
        """Driver chunk reclamation: when HBM is full, free a whole batch
        (never the entire pool — with a single resident page ``populate``'s
        own head eviction makes room, so the batch path stands down)."""
        if self.pool.free_pages() > 0:
            return
        n = min(batch, self.pool.resident_count() - 1)
        for _ in range(n):
            self.pool.evict_head()
            self.stats.evicted_pages += 1

    # -- run-native path -----------------------------------------------------
    def access_runs(self, runs: Sequence[PageRun]) -> float:
        """Serve a kernel's accesses given as first-touch-ordered page runs.

        With a run-native pool, resident stretches are LRU-spliced and each
        missing stretch is serviced in closed form (fault count, prefetch
        volume, batched evictions); with a paged pool this falls back to the
        per-page reference, making ``pool="paged"`` a full-stack equivalence
        mode."""
        if not getattr(self.pool, "RUN_NATIVE", False):
            return self.access([p for s, e in runs for p in range(s, e)])
        p_sz = self.page_size
        h2d, group_bytes, batch = self._rates()
        if p_sz >= group_bytes:
            return self._access_runs_coarse(runs, h2d, group_bytes, batch)
        return self._access_runs_grouped(runs, h2d, group_bytes, batch)

    def _access_runs_coarse(
        self, runs: Sequence[PageRun], h2d: float, group_bytes: int, batch: int
    ) -> float:
        """Simulation page >= fault group: each missing page is its own
        fault unit; a whole missing run is one arithmetic event."""
        pool = self.pool
        p_sz = self.page_size
        units = (p_sz + group_bytes - 1) // group_bytes
        x = units * self.platform.fault_total_us  # per-page stall add #1
        y = (p_sz - units * 4096) / h2d  # per-page stall add #2
        cap = pool.capacity
        stall = 0.0
        for a, b in runs:
            cur = a
            while cur < b:
                if pool.resident(cur):
                    hi = min(b, pool.resident_stretch_end(cur))
                    pool.touch_runs(((cur, hi),))
                    cur = hi
                    continue
                hi = self._missing_stretch_end(cur, b)
                L = hi - cur
                self.stats.faults += units * L
                self.stats.migrated_pages += L
                stall = _acc2(stall, x, y, L)
                # room-filling prefix needs no eviction at all
                first = min(L, pool.free_pages())
                if first:
                    pool._populate_run(cur, cur + first)
                rem = L - first
                if rem:
                    self._evict_and_fill(cur + first, hi, batch, cap)
                cur = hi
        return stall

    def _evict_and_fill(self, c: int, d: int, batch: int, cap: int) -> None:
        """Insert missing run ``[c, d)`` into a *full* pool with the driver's
        batch-reclaim rhythm: each time HBM fills, a batch of
        ``min(batch, capacity-1)`` head pages is reclaimed, then population
        resumes — the closed form of per-page ``_batch_evict`` + ``populate``
        (victims are the first k·e pages of [list order, run order], which
        can reach into the run itself when it exceeds capacity)."""
        pool = self.pool
        rem = d - c
        e = min(batch, cap - 1)
        if e == 0:
            # capacity-1 pool: every insert displaces the previous page
            pool._evict_head_run(1)
            pool.evictions += rem - 1
            pool.populations += rem - 1
            pool._populate_run(d - 1, d)
            self.stats.evicted_pages += rem
            return
        k = -(-rem // e)
        total = k * e
        self.stats.evicted_pages += total
        if total <= cap:
            pool._evict_head_run(total)
            pool._populate_run(c, d)
        else:
            # the run outsizes HBM: its own leading pages are populated and
            # reclaimed before the tail lands (exactly the per-page dynamics)
            overflow = total - cap
            pool._evict_head_run(cap)
            pool.evictions += overflow
            pool.populations += overflow
            pool._populate_run(c + overflow, d)

    def _access_runs_grouped(
        self, runs: Sequence[PageRun], h2d: float, group_bytes: int, batch: int
    ) -> float:
        """Simulation page < fault group (4 KiB regime): one fault services
        the whole aligned neighborhood, so the event loop advances a fault
        group at a time instead of a page at a time."""
        pool = self.pool
        p_sz = self.page_size
        group = group_bytes // p_sz
        stall = 0.0
        for a, b in runs:
            cur = a
            while cur < b:
                if pool.resident(cur):
                    hi = min(b, pool.resident_stretch_end(cur))
                    pool.touch_runs(((cur, hi),))
                    cur = hi
                    continue
                p = cur
                g0 = (p // group) * group
                g1 = g0 + group
                self.stats.faults += 1
                stall += self.platform.fault_total_us
                if pool.free_pages() == 0:
                    e = min(batch, pool.resident_count() - 1)
                    if e > 0:
                        pool._evict_head_run(e)
                        self.stats.evicted_pages += e
                missing = pool.missing_runs(((g0, g1),))
                n_new = run_page_count(missing)
                # population order: faulting page first, then the still-
                # missing neighborhood ascending
                order: List[PageRun] = [(p, p + 1)]
                for s, e2 in missing:
                    if s <= p < e2:
                        if s < p:
                            order.append((s, p))
                        if p + 1 < e2:
                            order.append((p + 1, e2))
                    else:
                        order.append((s, e2))
                victims = pool.populate_runs(order)
                self.stats.evicted_pages += run_page_count(victims)
                self.stats.migrated_pages += n_new
                stall += (n_new - 1) * p_sz / h2d
                # the rest of this group's pages are usually hits now, but a
                # group that outsizes HBM evicts its own early pages during
                # service — resume the walk and let residency decide
                cur = p + 1
        return stall

    def _missing_stretch_end(self, cur: int, b: int) -> int:
        """End of the non-resident stretch starting at ``cur`` (bounded by
        ``b``), against the pool's current segment index."""
        starts = self.pool._starts
        j = bisect_right(starts, cur)
        return min(b, starts[j]) if j < len(starts) else b


def _acc2(stall: float, x: float, y: float, n: int) -> float:
    """``n`` repetitions of ``stall += x; stall += y`` with per-step float
    rounding — the exact accumulation the per-page loop performs."""
    if n < _VECTOR_MIN_PAGES:
        for _ in range(n):
            stall = stall + x
            stall = stall + y
        return stall
    arr = np.empty(2 * n + 1)
    arr[0] = stall
    arr[1::2] = x
    arr[2::2] = y
    return float(np.add.accumulate(arr)[-1])
