"""Page-migration pipeline timing model (§6.3, Figs. 5 & 9).

Baseline driver behavior serializes unmap → D2H evict → H2D populate → map per
page, so the effective swap bandwidth is the harmonic-style combination of the
two directions. MSched drives eviction on one copy engine and population on
the other, exploiting the full-duplex interconnect; the overlapped pipeline is
capped by the host-side ceiling (``duplex_cap_gbps`` — the paper's measured
63.5 GB/s on RTX 5080, limited by the Intel chiplet NoC).

``plan_population`` additionally returns per-page ready times in first-access
order, which the simulator uses for *early execution*: a kernel starts as soon
as its own pages are resident rather than after the whole working set lands.
"""
from __future__ import annotations

import dataclasses
from bisect import bisect_right
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.hardware import Platform
from repro_torch.core.pages import PageRun, pages_to_runs, run_page_count


@dataclasses.dataclass
class MigrationResult:
    evict_bytes: int
    populate_bytes: int
    total_us: float
    page_ready_us: Dict[int, float]  # page -> time (relative to start)

    @property
    def populated_runs(self) -> List[PageRun]:
        """Populated pages (dict insertion order = first-access order) as
        order-preserving runs."""
        return list(pages_to_runs(list(self.page_ready_us.keys())))

    def ready_view(self, base: float) -> Optional["DictReadyView"]:
        """Run-queryable view over the per-page dict (legacy-planning path)."""
        if not self.page_ready_us:
            return None
        return DictReadyView(self.page_ready_us, base)


class DictReadyView:
    """Ready-time view backed by the legacy per-page dict. O(pages) per
    query — only the preserved ``planning="legacy"`` benchmark path uses it."""

    def __init__(self, page_ready_us: Dict[int, float], base: float):
        self._d = page_ready_us
        self._base = base
        self.global_max = base + max(page_ready_us.values())

    def max_ready(self, runs: Sequence[PageRun]) -> Optional[float]:
        best = None
        get = self._d.get
        for s, e in runs:
            for p in range(s, e):
                t = get(p)
                if t is not None and (best is None or t > best):
                    best = t
        return None if best is None else self._base + best


class IndexReadyView:
    """Ready-time view over populated runs whose per-page ready time is
    monotone in population order: the max over any page subset is the value
    at the subset's largest population index, so one command costs
    O(runs · log populated-runs) instead of O(pages)."""

    def __init__(
        self,
        populated_runs: Sequence[PageRun],
        value_fn: Callable[[int], float],
        n_pages: int,
    ):
        order = sorted(range(len(populated_runs)), key=lambda i: populated_runs[i][0])
        self._starts = [populated_runs[i][0] for i in order]
        self._stops = [populated_runs[i][1] for i in order]
        offsets = []
        off = 0
        for s, e in populated_runs:
            offsets.append(off)
            off += e - s
        self._offsets = [offsets[i] for i in order]
        self._value = value_fn
        self.global_max = value_fn(n_pages - 1) if n_pages else float("-inf")

    def max_ready(self, runs: Sequence[PageRun]) -> Optional[float]:
        starts, stops, offs = self._starts, self._stops, self._offsets
        best_idx = -1
        for a, b in runs:
            j = bisect_right(starts, a) - 1
            if j < 0:
                j = 0
            while j < len(starts) and starts[j] < b:
                if stops[j] > a:
                    hi = stops[j] if stops[j] < b else b
                    idx = offs[j] + (hi - starts[j]) - 1
                    if idx > best_idx:
                        best_idx = idx
                j += 1
        return None if best_idx < 0 else self._value(best_idx)


@dataclasses.dataclass
class RunMigration:
    """Run-native migration plan: per-page ready times in population order,
    without a per-page dict (``times[i]`` is the i-th populated page's ready
    time relative to the switch, computed with the exact float rounding of
    the per-page pipeline loop)."""

    evict_bytes: int
    populate_bytes: int
    total_us: float
    populated_runs: List[PageRun]  # first-access order
    times: Optional[np.ndarray]  # float64, len == populated page count

    @property
    def page_ready_us(self) -> Dict[int, float]:
        """Materialized per-page dict (tests/debug; O(pages))."""
        out: Dict[int, float] = {}
        i = 0
        for s, e in self.populated_runs:
            for p in range(s, e):
                out[p] = float(self.times[i])
                i += 1
        return out

    def ready_view(self, base: float) -> Optional[IndexReadyView]:
        if self.times is None or not len(self.times):
            return None
        times = self.times
        return IndexReadyView(
            self.populated_runs, lambda i: float(base + times[i]), len(times)
        )


@dataclasses.dataclass
class PeerGroup:
    """One peer-HBM source tier of a tiered migration: ``runs`` stream from
    ``src`` (a peer GPU's HBM, over its direct NVLink edge) at
    ``rate_bytes_per_us`` — the *fluid-share* rate the link graph granted the
    fetch, so a contended edge prices slower. Ready times are linear fill in
    population order, independent of the host-link pipeline (NVLink traffic
    never touches the PCIe root port)."""

    src: str
    runs: List[PageRun]
    rate_bytes_per_us: float

    def page_count(self) -> int:
        return run_page_count(self.runs)


class CombinedReadyView:
    """Max-composition of per-tier ready views: a command is ready when its
    last page has landed, whichever tier carried it."""

    def __init__(self, views: Sequence):
        self._views = [v for v in views if v is not None]
        self.global_max = max(
            (v.global_max for v in self._views), default=float("-inf")
        )

    def max_ready(self, runs: Sequence[PageRun]) -> Optional[float]:
        best = None
        for v in self._views:
            t = v.max_ready(runs)
            if t is not None and (best is None or t > best):
                best = t
        return best


@dataclasses.dataclass
class TieredMigration:
    """Migration plan whose populated pages come from multiple source tiers:
    the *host* tier (standard pipelined D2H-evict/H2D-populate recurrence —
    a :class:`RunMigration`) plus zero or more *peer-HBM* tiers
    (:class:`PeerGroup`s fetched over NVLink). Exposes the same surface as
    ``RunMigration`` (``total_us`` / ``populated_runs`` / ``ready_view``), so
    ``SwitchReport.migration`` and the simulator are tier-agnostic."""

    host: RunMigration
    peers: List[PeerGroup]
    page_size: int

    @property
    def evict_bytes(self) -> int:
        return self.host.evict_bytes

    @property
    def peer_bytes(self) -> int:
        return sum(g.page_count() for g in self.peers) * self.page_size

    @property
    def populate_bytes(self) -> int:
        return self.host.populate_bytes + self.peer_bytes

    @property
    def populated_runs(self) -> List[PageRun]:
        out = list(self.host.populated_runs)
        for g in self.peers:
            out.extend(g.runs)
        return out

    def _peer_times(self, g: PeerGroup) -> np.ndarray:
        n = g.page_count()
        return np.arange(1, n + 1, dtype=np.float64) * (
            self.page_size / g.rate_bytes_per_us
        )

    @property
    def total_us(self) -> float:
        peer_last = max(
            (float(self._peer_times(g)[-1]) for g in self.peers if g.page_count()),
            default=0.0,
        )
        return max(self.host.total_us, peer_last)

    def ready_view(self, base: float) -> Optional[CombinedReadyView]:
        views = [self.host.ready_view(base)]
        for g in self.peers:
            times = self._peer_times(g)
            if not len(times):
                continue
            views.append(
                IndexReadyView(
                    g.runs, lambda i, t=times: float(base + t[i]), len(times)
                )
            )
        views = [v for v in views if v is not None]
        return CombinedReadyView(views) if views else None


def migrate_time_us(
    platform: Platform,
    evict_bytes: int,
    populate_bytes: int,
    pipelined: bool = True,
) -> float:
    d2h = platform.d2h_gbps * 1e3  # bytes/us
    h2d = platform.h2d_gbps * 1e3
    if not pipelined:
        return evict_bytes / d2h + populate_bytes / h2d
    t_overlap = max(evict_bytes / d2h, populate_bytes / h2d)
    # host-side duplex ceiling
    cap = platform.duplex_cap_gbps * 1e3
    t_cap = (evict_bytes + populate_bytes) / cap
    return max(t_overlap, t_cap)


def effective_swap_bandwidth_gbps(
    platform: Platform, bytes_each_way: int, pipelined: bool
) -> float:
    t = migrate_time_us(platform, bytes_each_way, bytes_each_way, pipelined)
    return (2 * bytes_each_way) / (t * 1e3) if t else 0.0


def plan_population(
    platform: Platform,
    populate_pages: Sequence[int],
    evict_count: int,
    pipelined: bool = True,
    page_size: int = 0,
) -> MigrationResult:
    """Timing for one proactive migration batch.

    ``populate_pages`` must be in predicted first-access order. Eviction of
    ``evict_count`` victims runs on CE0; population on CE1. Unpipelined mode
    (ablation) serializes: all evictions complete before population starts.
    """
    ps = page_size or platform.page_size
    d2h = platform.d2h_gbps * 1e3
    h2d = platform.h2d_gbps * 1e3
    cap = platform.duplex_cap_gbps * 1e3

    evict_bytes = evict_count * ps
    pop_bytes = len(populate_pages) * ps
    ready: Dict[int, float] = {}

    if not pipelined:
        t0 = evict_bytes / d2h
        for i, p in enumerate(populate_pages):
            ready[p] = t0 + (i + 1) * ps / h2d
        total = t0 + pop_bytes / h2d
        return MigrationResult(evict_bytes, pop_bytes, total, ready)

    # pipelined: population of page i can begin once space exists; we model
    # space reclamation at D2H rate and transfer at the capped duplex rate.
    # effective per-direction rate under the duplex ceiling:
    both_active_rate = min(h2d, cap - min(d2h, cap / 2.0)) if cap < d2h + h2d else h2d
    t = 0.0
    for i, p in enumerate(populate_pages):
        # page i needs i+1 pages of space reclaimed (if evicting at all)
        space_ready = ((i + 1) * ps / d2h) if evict_count > 0 and i < evict_count else 0.0
        t = max(t, space_ready) + ps / both_active_rate
        ready[p] = t
    total = max(t, evict_bytes / d2h)
    return MigrationResult(evict_bytes, pop_bytes, total, ready)


def plan_population_runs(
    platform: Platform,
    populate_runs: Sequence[PageRun],
    evict_count: int,
    pipelined: bool = True,
    page_size: int = 0,
) -> RunMigration:
    """Run-native :func:`plan_population`: identical per-page ready times
    (same float rounding as the scalar recurrence), computed as numpy arrays
    over population indices instead of a Python loop over a page dict."""
    ps = page_size or platform.page_size
    d2h = platform.d2h_gbps * 1e3
    h2d = platform.h2d_gbps * 1e3
    cap = platform.duplex_cap_gbps * 1e3

    n = run_page_count(populate_runs)
    evict_bytes = evict_count * ps
    pop_bytes = n * ps
    if n == 0:
        total = evict_bytes / d2h if not pipelined else max(0.0, evict_bytes / d2h)
        return RunMigration(evict_bytes, pop_bytes, total, [], None)

    idx = np.arange(1, n + 1, dtype=np.int64)  # (i + 1)

    if not pipelined:
        t0 = evict_bytes / d2h
        times = t0 + (idx * ps) / h2d
        total = t0 + pop_bytes / h2d
        return RunMigration(evict_bytes, pop_bytes, total, list(populate_runs), times)

    both_active_rate = min(h2d, cap - min(d2h, cap / 2.0)) if cap < d2h + h2d else h2d
    step = ps / both_active_rate
    s = np.zeros(n)
    if evict_count > 0:
        e = min(evict_count, n)
        s[:e] = (idx[:e] * ps) / d2h
    times = _max_add_scan(s, step)
    total = max(float(times[-1]), evict_bytes / d2h)
    return RunMigration(evict_bytes, pop_bytes, total, list(populate_runs), times)


def _max_add_scan(s: np.ndarray, step: float) -> np.ndarray:
    """Exact vectorization of ``t_i = max(t_{i-1}, s_i) + step`` (t_{-1}=0).

    The recurrence alternates between two regimes — *stalled* (``s`` wins
    every step, so ``t_i = s_i + step`` elementwise) and *streaming* (``t``
    wins, a pure sequential accumulation, which ``np.add.accumulate``
    reproduces with the same left-to-right rounding). Each regime is solved
    in one vector op and the boundary found by comparison, so the result is
    bit-for-bit the scalar loop's at O(regime switches) vector passes; a
    pathological alternation falls back to the scalar loop."""
    n = len(s)
    t = np.empty(n)
    i = 0
    prev = 0.0
    for _ in range(64):
        if i >= n:
            return t
        # streaming candidate: pure accumulation from prev
        arr = np.full(n - i + 1, step)
        arr[0] = prev
        cand = np.add.accumulate(arr)[1:]
        t_prev = np.empty(n - i)
        t_prev[0] = prev
        t_prev[1:] = cand[:-1]
        viol = s[i:] > t_prev
        if not viol.any():
            t[i:] = cand
            return t
        j = int(np.argmax(viol))
        t[i : i + j] = cand[:j]
        i += j
        # stalled candidate: t_k = s_k + step while s keeps outpacing t
        tr = s[i:] + step
        ok = s[i + 1 :] > tr[:-1]
        if ok.all():
            m = n - i
        else:
            m = int(np.argmin(ok)) + 1
        t[i : i + m] = tr[:m]
        i += m
        prev = float(t[i - 1])
    # degenerate regime flapping: scalar reference (still exact)
    while i < n:
        prev = max(prev, float(s[i])) + step
        t[i] = prev
        i += 1
    return t
