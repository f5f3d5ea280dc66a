"""Offline kernel profiler (paper §5.2, the NVBit analogue).

Runs workload programs in instrumented mode and records, per kernel, every
invocation's launch arguments, touched extents, and latency into a
``TraceStore``. The memory analyzer then fits the templates offline ("can be
integrated into the compiler or executed during installation").
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.trace import TraceStore
from repro_torch.core.workloads import TaskProgram


def profile_programs(
    programs: Sequence[TaskProgram], iters: int = 4
) -> TraceStore:
    store = TraceStore()
    for prog in programs:
        for it in range(iters):
            for cmd in prog.iteration(it):
                store.record(cmd, space=prog.space)
    return store
