"""GPU command stream model: kernels and memcpys.

From the OS's perspective a GPU task is a sequence of asynchronously-launched
commands (paper §2.1). ``args`` is the flattened 32/64-bit integer view of the
kernel launch arguments (pointers are just big integers; C-structs are sliced
into ints, exactly as the paper's analyzer does). ``true_extents`` is the
ground-truth touched byte ranges — visible only to the *offline* profiler
(the NVBit analogue) and to the simulator, never to the online predictor.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.pages import Extent, PageRun, expand_runs

KERNEL = "kernel"
MEMCPY_H2D = "memcpy_h2d"
MEMCPY_D2H = "memcpy_d2h"


@dataclasses.dataclass
class Command:
    kind: str  # KERNEL | MEMCPY_*
    name: str
    args: Tuple[int, ...]  # flattened int view (pointers + scalars + grid dims)
    latency_us: float  # deterministic execution latency (paper §6: [25,28,39])
    true_extents: List[Extent]  # ground truth (offline/simulation only)
    task_id: int = -1
    seq_no: int = -1
    # attached by the online predictor (per-process helper):
    predicted_extents: Optional[List[Extent]] = None
    # page-order caches: decoded once (at annotate time / first simulated
    # execution), so the planning hot path never re-walks extents.
    # ``predicted_page_runs`` is (re)set by Predictor.annotate().
    predicted_page_runs: Optional[Tuple[PageRun, ...]] = None
    _true_page_runs: Optional[Tuple[PageRun, ...]] = None

    def data_bytes(self) -> int:
        return sum(sz for _, sz in self.true_extents)

    def true_page_runs(self, space) -> Tuple[PageRun, ...]:
        """Ground-truth touched pages as first-access-ordered runs (cached)."""
        if self._true_page_runs is None:
            self._true_page_runs = space.page_runs_of_extents(self.true_extents)
        return self._true_page_runs

    def true_page_list(self, space) -> List[int]:
        """Ground-truth pages in first-access order."""
        return expand_runs(self.true_page_runs(space))


def kernel(name: str, args: Sequence[int], latency_us: float, extents: List[Extent]) -> Command:
    return Command(KERNEL, name, tuple(int(a) for a in args), latency_us, extents)


def memcpy_h2d(dst: Extent, latency_us: float) -> Command:
    """Copy semantics are explicit in the API: dst/size are direct arguments,
    so prediction is trivially exact (paper §5)."""
    return Command(
        MEMCPY_H2D, "memcpy_h2d", (dst[0], dst[1]), latency_us, [dst]
    )


def memcpy_d2h(src: Extent, latency_us: float) -> Command:
    return Command(
        MEMCPY_D2H, "memcpy_d2h", (src[0], src[1]), latency_us, [src]
    )
