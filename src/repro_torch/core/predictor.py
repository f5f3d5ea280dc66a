"""Online working-set predictors (paper §5).

``TemplatePredictor`` is MSched's predictor: it evaluates the offline-derived
formulas on the live launch arguments (microsecond-scale, pure arithmetic) and
attaches page-aligned predictions to each command.

``AllocationPredictor`` is the naive baseline (§5.1): every pointer-looking
argument is expanded to its entire containing allocation — near-zero false
negatives, catastrophic false positives (up to 99.7% for LLMs, Table 1).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Set

from repro_torch.core.commands import Command, KERNEL
from repro_torch.core.pages import AddressSpace, Extent, merge_extents
from repro_torch.core.templates import KernelDescriptor, PTR_MIN


class Predictor:
    def predict_extents(self, cmd: Command) -> List[Extent]:
        raise NotImplementedError

    def predict_pages(self, cmd: Command, space: AddressSpace) -> Set[int]:
        return space.pages_of(self.predict_extents(cmd))

    def annotate(self, cmd: Command, space: Optional[AddressSpace] = None) -> Command:
        """Attach predicted extents; with ``space``, also decode the page
        order once and cache it on the command (run-length form). Any
        re-annotation replaces both, so the cache can never go stale."""
        cmd.predicted_extents = self.predict_extents(cmd)
        cmd.predicted_page_runs = (
            space.page_runs_of_extents(cmd.predicted_extents)
            if space is not None
            else None
        )
        return cmd


class TemplatePredictor(Predictor):
    def __init__(self, descriptors: Dict[str, KernelDescriptor]):
        self.descriptors = descriptors
        # launches repeat the same (kernel, args) shapes across iterations;
        # the formulas are pure, so their output is memoizable
        self._memo: Dict[tuple, List[Extent]] = {}

    def predict_extents(self, cmd: Command) -> List[Extent]:
        if cmd.kind != KERNEL:
            return list(cmd.true_extents)  # memcpy: explicit API semantics
        key = (cmd.name, cmd.args)
        ext = self._memo.get(key)
        if ext is None:
            desc = self.descriptors.get(cmd.name)
            ext = [] if desc is None else merge_extents(desc.predict_extents(cmd.args))
            if len(self._memo) >= 65536:
                self._memo.clear()
            self._memo[key] = ext
        return ext


class AllocationPredictor(Predictor):
    def __init__(self, space: AddressSpace):
        self.space = space

    def predict_extents(self, cmd: Command) -> List[Extent]:
        if cmd.kind != KERNEL:
            return list(cmd.true_extents)
        out: List[Extent] = []
        for a in cmd.args:
            if a >= PTR_MIN:
                buf = self.space.find_buffer(int(a))
                if buf is not None:
                    out.append((buf.base, buf.size))
        return merge_extents(out)


class OraclePredictor(Predictor):
    """Ground truth (the paper's *Ideal* baseline input)."""

    def predict_extents(self, cmd: Command) -> List[Extent]:
        return list(cmd.true_extents)


# --------------------------------------------------------------------------
# Accuracy accounting (Table 1 methodology: kernel-level F− / F+ over pages)
# --------------------------------------------------------------------------


@dataclasses.dataclass
class AccuracyStats:
    true_pages: int = 0
    missed_pages: int = 0  # false negatives
    pred_pages: int = 0
    wrong_pages: int = 0  # false positives

    @property
    def false_negative_pct(self) -> float:
        return 100.0 * self.missed_pages / self.true_pages if self.true_pages else 0.0

    @property
    def false_positive_pct(self) -> float:
        return 100.0 * self.wrong_pages / self.pred_pages if self.pred_pages else 0.0


def evaluate_accuracy(
    predictor: Predictor,
    commands: Iterable[Command],
    space: AddressSpace,
) -> AccuracyStats:
    stats = AccuracyStats()
    for cmd in commands:
        if cmd.kind != KERNEL:
            continue
        true_pages = space.pages_of(cmd.true_extents)
        pred_pages = predictor.predict_pages(cmd, space)
        stats.true_pages += len(true_pages)
        stats.pred_pages += len(pred_pages)
        stats.missed_pages += len(true_pages - pred_pages)
        stats.wrong_pages += len(pred_pages - true_pages)
    return stats
