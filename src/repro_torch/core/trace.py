"""Profiled traces: the offline phase's raw material.

``TraceStore`` accumulates, per kernel name, every observed invocation's
launch arguments, raw touched extents, and latency. Extents are kept
*unmerged* (the instrumented addresses as NVBit would record them) — merging
happens per attributed pointer region inside the analyzer; premature merging
would fuse regions of adjacent allocations and hide base addresses.

Each invocation also carries the allocation map snapshot: the OS-level
MSched tracks cudaMalloc/Free anyway (§5.1), and the analyzer uses it to
attribute extents to the right allocation.
"""
from __future__ import annotations

import dataclasses
import statistics
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from repro_torch.core.commands import Command, KERNEL
from repro_torch.core.pages import Extent


@dataclasses.dataclass
class Invocation:
    args: Tuple[int, ...]
    extents: List[Extent]  # raw, sorted by start
    latency_us: float
    alloc_ranges: Optional[List[Extent]] = None  # (base, size) of live buffers


class TraceStore:
    def __init__(self):
        self.by_kernel: Dict[str, List[Invocation]] = defaultdict(list)

    def record(self, cmd: Command, space=None) -> None:
        if cmd.kind != KERNEL:
            return  # memcpy semantics are explicit; nothing to learn
        allocs = None
        if space is not None:
            allocs = [(b.base, b.size) for b in space.buffers.values()]
        self.by_kernel[cmd.name].append(
            Invocation(cmd.args, sorted(cmd.true_extents), cmd.latency_us, allocs)
        )

    def latency_us(self, kernel_name: str) -> float:
        inv = self.by_kernel.get(kernel_name)
        if not inv:
            return 0.0
        return statistics.fmean(i.latency_us for i in inv)

    def kernels(self) -> List[str]:
        return sorted(self.by_kernel)
