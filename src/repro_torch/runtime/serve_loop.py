"""Batched serving loop with MSched-style multi-model scheduling.

Counterpart of the JAX package's ``runtime/serve_loop.py``. Hosts several
models on one device budget: requests queue per model, the scheduler serves
the model with the oldest request, and the MSched coordinator proactively
migrates the next model's weights into the device pool before its batch runs
— serving-side integration of the paper's extended context switch.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, Dict, List, Optional

from repro_torch.configs import get_config
from repro_torch.core.runtime import LiveModelTask, LiveRuntime


@dataclasses.dataclass
class Request:
    model: int
    arrival_s: float
    tokens: int = 1


@dataclasses.dataclass
class ServeStats:
    served: Dict[int, int]
    latencies_s: Dict[int, List[float]]
    migrated_in_bytes: int
    demand_faults: int

    def p99(self, model: int) -> float:
        xs = sorted(self.latencies_s.get(model, []))
        if not xs:
            return 0.0
        return xs[min(len(xs) - 1, int(0.99 * len(xs)))]


class MultiModelServer:
    """``full=True`` builds the tasks at the published configs instead of
    ``.reduced()``; ``page_size`` is the pages' size in bytes for both the
    task address spaces and the device pool. Without ``hbm_budget_bytes`` the
    budget is the tasks' footprint over ``oversub``."""

    def __init__(
        self,
        archs: List[str],
        hbm_budget_bytes: Optional[int] = None,
        steps_per_slice: int = 4,
        device="cuda",
        full: bool = False,
        page_size: int = 4096,
        oversub: float = 1.5,
    ):
        tasks = [
            LiveModelTask(
                i, a, page_size=page_size, seed=i, device=device,
                cfg=get_config(a) if full else None,
            )
            for i, a in enumerate(archs)
        ]
        total = sum(t.footprint_bytes() for t in tasks)
        budget = hbm_budget_bytes or int(total / oversub)  # 150% by default
        self.runtime = LiveRuntime(
            tasks, budget, steps_per_slice=steps_per_slice, page_size=page_size
        )
        self.queues: Dict[int, Deque[Request]] = {
            t.task_id: deque() for t in tasks
        }

    def submit(self, req: Request) -> None:
        self.queues[req.model].append(req)

    def serve(self, wall_budget_s: float = 5.0) -> ServeStats:
        stats = ServeStats(
            {m: 0 for m in self.queues}, {m: [] for m in self.queues}, 0, 0
        )
        t_end = time.perf_counter() + wall_budget_s
        rt = self.runtime
        while time.perf_counter() < t_end and any(self.queues.values()):
            # pick the model with the oldest pending request (FIFO fairness)
            pending = {m: q for m, q in self.queues.items() if q}
            if not pending:
                break
            model = min(pending, key=lambda m: pending[m][0].arrival_s)
            # run one slice for that model via the MSched runtime
            before = rt.stats.steps[model]
            rt.policy._rr = [model] + [m for m in rt.tasks if m != model]
            rt.run(total_slices=1)
            served_steps = rt.stats.steps[model] - before
            now = time.perf_counter()
            for _ in range(min(served_steps, len(self.queues[model]))):
                req = self.queues[model].popleft()
                stats.served[model] += 1
                stats.latencies_s[model].append(now - req.arrival_s)
        stats.migrated_in_bytes = rt.stats.migrated_in_bytes
        stats.demand_faults = rt.stats.demand_faults
        return stats
