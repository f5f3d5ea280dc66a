"""Live multi-task runtime: MSched driving *real* tensor migrations.

Counterpart of the JAX package's ``core/runtime.py``. Each task is a zoo model
whose parameter leaves are page-granular segments in a task address space.
"HBM" is a budgeted device pool: a resident segment is a tensor on the task's
device; an evicted one lives only in its host copy, which is pinned when the
device is ``cuda`` so that migrations are real pinned-host <-> HBM copies over
PCIe. On every context switch the MSched coordinator predicts the next task's
working set (template predictor over the decode command stream, including the
growing KV slice), enforces the OPT eviction order, and the runtime moves the
segments to match. Copies are synchronous.

Correctness contract (tested): step outputs are bit-identical to an
all-resident baseline, because MSched migration is semantically transparent —
exactly the paper's OS-level transparency claim.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.commands import Command, kernel
from repro_torch.core.hardware import H100_80G
from repro_torch.core.hbm import HBMPool
from repro_torch.core.memory_manager import Coordinator, TaskHelper
from repro_torch.core.pages import AddressSpace
from repro_torch.core.predictor import TemplatePredictor
from repro_torch.core.profiler import profile_programs
from repro_torch.core.scheduler import RoundRobinPolicy, SchedTask
from repro_torch.core.templates import analyze_traces
from repro_torch.core.timeline import TaskTimeline
from repro_torch.models.common import resolve_device
from repro_torch.models.convert import params_from_reference
from repro_torch.models.model import build_model
from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass
class Segment:
    path: str
    base: int
    nbytes: int
    host: torch.Tensor  # authoritative host copy when evicted
    device: Optional[torch.Tensor] = None  # resident copy


class LiveModelTask:
    """A decode job over a zoo model; weights are pageable segments.

    ``params`` is the JAX package's params tree as numpy arrays (converted
    here); without it the model is initialized from ``seed`` on ``device``.
    ``cfg`` defaults to the reduced config of ``arch``, as in the reference.
    """

    def __init__(
        self,
        task_id: int,
        arch: str,
        page_size: int = 4096,
        seed: int = 0,
        device="cuda",
        params=None,
        cfg: Optional[ModelConfig] = None,
    ):
        self.task_id = task_id
        self.device = resolve_device(device)
        self.cfg = cfg if cfg is not None else get_config(arch).reduced()
        self.fns = build_model(self.cfg)
        self.space = AddressSpace(page_size=page_size, base=(task_id + 1) << 44)
        if params is None:
            tree = self.fns.init(torch.Generator(self.device).manual_seed(seed))
        else:
            tree = params_from_reference(params)
        pin = self.device.type == "cuda"
        self.segments: List[Segment] = []
        for path, leaf in flatten(tree):
            host = leaf
            if pin or leaf.device.type != "cpu":
                host = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=pin)
                host.copy_(leaf)
            nbytes = host.numel() * host.element_size()
            buf = self.space.malloc(max(nbytes, 1), path)
            self.segments.append(Segment(path, buf.base, nbytes, host))
        del tree
        self.kv_buf = self.space.malloc(1 << 20, "kv")

    # -- command stream (the helper intercepts these) -----------------------
    def next_commands(self, step_idx: int) -> List[Command]:
        exts = [(s.base, s.nbytes) for s in self.segments]
        exts.append((self.kv_buf.base, min(4096 * (step_idx + 1), self.kv_buf.size)))
        args = tuple(s.base for s in self.segments[:8]) + (
            self.kv_buf.base,
            step_idx + 1,
            4096,
        )
        return [kernel(f"{self.cfg.name}_step", args, 500.0, exts)]

    # -- execution -----------------------------------------------------------
    def run_step(self, rng_step: int) -> torch.Tensor:
        """One-token forward over the resident segments; the logits stay on
        the task's device (no synchronisation)."""
        params = self.resident_params()
        tok = torch.tensor([[1 + (rng_step % 13)]], dtype=torch.int64, device=self.device)
        with torch.inference_mode():
            return self.fns.forward(params, {"tokens": tok})

    def resident_params(self):
        pairs = []
        for s in self.segments:
            if s.device is None:
                raise RuntimeError(f"segment {s.path} not resident (fault)")
            pairs.append((s.path, s.device))
        return unflatten(pairs)

    def footprint_bytes(self) -> int:
        return sum(s.nbytes for s in self.segments) + self.kv_buf.size

    # program interface used by the profiler
    def iteration(self, it: int) -> List[Command]:
        return self.next_commands(it)


@dataclasses.dataclass
class LiveStats:
    steps: Dict[int, int]
    migrated_in_bytes: int
    migrated_out_bytes: int
    demand_faults: int
    switch_wall_s: List[float]  # coordinator plan + the copies it orders
    coordinator_wall_s: List[float] = dataclasses.field(default_factory=list)  # plan only


class LiveRuntime:
    """Round-robin multitasking with proactive working-set migration."""

    def __init__(
        self,
        tasks: List[LiveModelTask],
        hbm_budget_bytes: int,
        steps_per_slice: int = 4,
        page_size: int = 4096,
    ):
        self.tasks = {t.task_id: t for t in tasks}
        self.page_size = page_size
        self.pool = HBMPool(max(1, hbm_budget_bytes // page_size))
        # offline phase: profile + analyze (real MSched flow)
        store = profile_programs(list(tasks), iters=3)
        descriptors = analyze_traces(store)
        # the platform only prices migrations; residency decisions do not read it
        self.coordinator = Coordinator(H100_80G, self.pool, page_size=page_size)
        self.helpers: Dict[int, TaskHelper] = {}
        for t in tasks:
            h = TaskHelper(t.task_id, t.space, TemplatePredictor(descriptors))
            self.helpers[t.task_id] = h
            self.coordinator.register(h)
        # page -> (task, segment) index for real data movement
        self.page_owner: Dict[int, Tuple[int, int]] = {}
        for t in tasks:
            for si, seg in enumerate(t.segments):
                for p in t.space.pages_of_extent((seg.base, seg.nbytes)):
                    self.page_owner[p] = (t.task_id, si)
        self.steps_per_slice = steps_per_slice
        self.policy = RoundRobinPolicy(quantum_us=1000.0 * steps_per_slice)
        self.stats = LiveStats({t.task_id: 0 for t in tasks}, 0, 0, 0, [])
        self._step_counter = {t.task_id: 0 for t in tasks}

    # -- real data movement ---------------------------------------------------
    def _sync_residency(self) -> None:
        """Make device tensors mirror the pool's residency decisions: a
        segment is on-device iff all of its pages are pool-resident."""
        for task in self.tasks.values():
            for seg in task.segments:
                pages = task.space.pages_of_extent((seg.base, seg.nbytes))
                resident = all(self.pool.resident(p) for p in pages)
                if resident and seg.device is None:
                    seg.device = seg.host.to(task.device)  # H2D
                    self.stats.migrated_in_bytes += seg.nbytes
                elif not resident and seg.device is not None:
                    seg.host.copy_(seg.device)  # D2H eviction
                    seg.device = None
                    self.stats.migrated_out_bytes += seg.nbytes

    def _fault_in(self, task: LiveModelTask) -> None:
        """Demand-paging fallback: any still-missing segment faults in."""
        for seg in task.segments:
            if seg.device is None:
                pages = list(task.space.pages_of_extent((seg.base, seg.nbytes)))
                self.pool.migrate(pages)
                self._sync_residency()
                self.stats.demand_faults += 1

    # -- main loop -------------------------------------------------------------
    def run(self, total_slices: int = 12) -> LiveStats:
        for _ in range(total_slices):
            sched = {tid: SchedTask(tid) for tid in self.tasks}
            entry = self.policy.next_entry(sched)
            timeline = TaskTimeline([entry] + self.policy.timeline(sched).entries)
            task = self.tasks[entry.task_id]
            helper = self.helpers[entry.task_id]
            # refill the async window
            while len(helper.queue) < 2 * self.steps_per_slice:
                for cmd in task.next_commands(
                    self._step_counter[entry.task_id] + len(helper.queue)
                ):
                    helper.launch(cmd)
            # extended context switch: proactive working-set migration
            t0 = time.perf_counter()
            self.coordinator.on_context_switch(entry.task_id, timeline)
            self.stats.coordinator_wall_s.append(time.perf_counter() - t0)
            self._sync_residency()
            self.stats.switch_wall_s.append(time.perf_counter() - t0)
            self._fault_in(task)
            for _ in range(self.steps_per_slice):
                step = self._step_counter[entry.task_id]
                task.run_step(step)
                self._step_counter[entry.task_id] += 1
                self.stats.steps[entry.task_id] += 1
                if helper.queue:
                    helper.pop()
            if task.device.type == "cuda":
                # the slice ends when its steps do, so the next switch times
                # its plan and copies alone
                torch.cuda.synchronize(task.device)
        return self.stats
