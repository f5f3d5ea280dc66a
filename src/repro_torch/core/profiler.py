"""Offline kernel profiler (paper §5.2, the NVBit analogue).

Runs workload programs in instrumented mode and records, per kernel, every
invocation's launch arguments, touched extents, and latency into a
``TraceStore``. The memory analyzer then fits the templates offline ("can be
integrated into the compiler or executed during installation").
"""
from __future__ import annotations

from typing import Sequence

from repro_torch.core.trace import TraceStore


def profile_programs(programs: Sequence, iters: int = 4) -> TraceStore:
    """``programs`` are tasks with an address space ``.space`` and a command
    stream ``.iteration(it)``."""
    store = TraceStore()
    for prog in programs:
        for it in range(iters):
            for cmd in prog.iteration(it):
                store.record(cmd, space=prog.space)
    return store
