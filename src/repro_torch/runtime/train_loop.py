"""Fault-tolerant training loop: checkpoint/restart, straggler counting and
failure injection, the JAX package's ``runtime/train_loop.py`` on the port.

* periodic async checkpoints (serialization overlapped with the next steps);
* restart from the latest checkpoint on failure: ``TrainSupervisor.run``
  survives injected faults and resumes with the same losses, because the
  data pipeline is a pure function of the step;
* straggler counting: a step that takes more than ``straggler_factor``
  times the median of the last 20 is counted;
* elastic re-mesh: checkpoints hold whole arrays, so ``run`` can be
  invoked again with another mesh, or none, and continue.

The step runs eagerly (the reference jits it; capturing it is ROADMAP.md §1
item 3), on ``cuda`` unless the caller passes ``device="cpu"``. With a
``mesh`` (a ``DeviceMesh`` over the process group this rank belongs to) and
its ``shardings`` (``sharding.specs.state_shardings``), the state is placed
as DTensors, the step is ``make_sharded_train_step``, the loop runs under
``use_activation_mesh`` (installed once; no module of the port reads it
yet), rank 0 writes the checkpoints and every rank
restores its shards from them.
"""
from __future__ import annotations

import contextlib
import dataclasses
import statistics
import time
from typing import List, Optional

import torch

from repro_torch.checkpointing.checkpoint import AsyncCheckpointer, latest_step, restore
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.data.pipeline import TokenPipeline, pipeline_for
from repro_torch.launch.steps import make_sharded_train_step, make_train_state, make_train_step
from repro_torch.models.common import resolve_device
from repro_torch.sharding.act import use_activation_mesh
from repro_torch.sharding.specs import place


@dataclasses.dataclass
class TrainReport:
    steps_run: int
    final_step: int
    losses: List[float]
    restarts: int
    straggler_steps: int
    checkpoints: int


class FailureInjector:
    """Deterministic fault injection for tests: raises at given steps."""

    def __init__(self, fail_at: Optional[List[int]] = None):
        self.fail_at = set(fail_at or [])
        self.fired = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise RuntimeError(f"injected node failure at step {step}")


class TrainSupervisor:
    def __init__(
        self,
        cfg: ModelConfig,
        shape: ShapeSpec,
        ckpt_dir: str,
        mesh=None,
        shardings=None,
        ckpt_every: int = 10,
        straggler_factor: float = 3.0,
        seed: int = 0,
        device="cuda",
    ):
        if (mesh is None) != (shardings is None):
            raise ValueError("TrainSupervisor: pass a mesh and its shardings together")
        self.cfg = cfg
        self.shape = shape
        self.ckpt_dir = ckpt_dir
        self.mesh = mesh
        self.shardings = shardings
        self.ckpt_every = ckpt_every
        self.straggler_factor = straggler_factor
        self.pipeline: TokenPipeline = pipeline_for(cfg, shape, seed)
        self.seed = seed
        self.device = resolve_device(device)

    def _init_state(self):
        state = make_train_state(self.cfg, torch.Generator(self.device).manual_seed(self.seed))
        return state if self.shardings is None else place(state, self.shardings)

    def run(self, total_steps: int, injector: Optional[FailureInjector] = None,
            max_restarts: int = 3) -> TrainReport:
        restarts = 0
        report = TrainReport(0, 0, [], 0, 0, 0)
        while True:
            try:
                self._run_once(total_steps, injector, report)
                return report
            except RuntimeError as e:
                if "injected node failure" not in str(e) or restarts >= max_restarts:
                    raise
                restarts += 1
                report.restarts = restarts

    def _run_once(self, total_steps, injector, report: TrainReport) -> None:
        ckpt = AsyncCheckpointer(self.ckpt_dir)
        step_fn = make_train_step(self.cfg) if self.mesh is None else make_sharded_train_step(self.cfg, self.mesh)
        start = latest_step(self.ckpt_dir)
        state = self._init_state()
        if start is not None:  # the fresh state is the target the checkpoint fills
            state = restore(self.ckpt_dir, start, state)
            step = start
        else:
            step = 0

        durations: List[float] = []
        try:
            with contextlib.nullcontext() if self.mesh is None else use_activation_mesh(self.mesh):
                while step < total_steps:
                    if injector is not None:
                        injector.maybe_fail(step)
                    batch = {k: torch.from_numpy(v).to(self.device) for k, v in self.pipeline.batch(step).items()}
                    t0 = time.perf_counter()
                    state, metrics = step_fn(state, batch)
                    loss = float(metrics["loss"])  # waits for the step, as the reference's float() does
                    dt = time.perf_counter() - t0
                    durations.append(dt)
                    if len(durations) >= 5:
                        med = statistics.median(durations[-20:])
                        if dt > self.straggler_factor * med:
                            report.straggler_steps += 1
                    report.losses.append(loss)
                    report.steps_run += 1
                    step += 1
                    report.final_step = step
                    if step % self.ckpt_every == 0 or step == total_steps:
                        ckpt.save_async(step, state)
                        report.checkpoints += 1
        finally:
            # a save still in flight when a step fails lands before the
            # restart looks for the latest checkpoint, which it would
            # otherwise miss, starting over from an older one
            ckpt.wait()
