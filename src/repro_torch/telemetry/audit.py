"""Online prediction audit: score the paper's accuracy claim live.

MSched's thesis rests on template-based working-set prediction being
near-perfect (paper Table 1: F− ≤ 0.92%, F+ = 0.00%), but Table 1 is an
*offline* score over canned command windows
(``benchmarks/table1_prediction_accuracy.py``). The auditor turns that
headline into a continuously-measured invariant: hooked at every extended
context switch and fault-service boundary, it compares what the predictor
promised against what the task actually touched, at two granularities:

  * **per-command** (the Table 1 methodology, exactly): for every executed
    kernel command carrying an annotate-time prediction, compare
    ``cmd.predicted_page_runs`` against ``cmd.true_page_runs`` at page
    granularity. The fleet F−/F+ rates this produces reconcile with
    :func:`repro_torch.core.predictor.evaluate_accuracy` on the same commands to
    float precision (pinned within 0.1 pp in the tests);
  * **per-quantum** (the populate plan): at each extended context switch the
    coordinator's predicted cut (``SwitchReport.predicted_runs``) and what
    it actually populated (``migration.populated_runs``) are held against
    the union of pages touched during the quantum. Populated-but-untouched
    pages are **over-fetch** (wasted link bytes); demand-paging stalls
    inside the quantum are **under-fetch** residue, cross-checked against
    the stall ledger's ``fault-service`` bucket via :meth:`reconcile_ledger`.

Per-template (kernel name) accumulators drive a drift gauge: the F− rate
over a recent window minus the lifetime rate, in percentage points — a
drifting template shows up here before it degrades placement or admission.

The auditor is an observer under the same contract as the hub: it only runs
when a :class:`~repro_torch.telemetry.hub.Telemetry` hub with ``audit=True`` is
attached, reads simulation state without mutating it, and leaves traced
results bit-for-bit identical to untraced ones. Backends without
predictions (um/suv) produce no audited commands — the auditor simply
reports an empty sample rather than a fake score.

Copied from the JAX package's ``telemetry/audit.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.core.commands import KERNEL
from repro_torch.core.pages import (
    PageRun,
    intersect_runs,
    merge_runs,
    run_page_count,
    subtract_runs,
)

# recent-window length (audited kernel commands) for the drift gauge
_DRIFT_WINDOW = 256


class _Acc:
    """Page-count accumulator in Table 1 terms (true/pred/missed/wrong)."""

    __slots__ = ("true", "pred", "missed", "wrong", "commands")

    def __init__(self) -> None:
        self.true = 0
        self.pred = 0
        self.missed = 0
        self.wrong = 0
        self.commands = 0

    def add(self, true: int, pred: int, missed: int, wrong: int) -> None:
        self.true += true
        self.pred += pred
        self.missed += missed
        self.wrong += wrong
        self.commands += 1

    def fneg_pct(self) -> float:
        return 100.0 * self.missed / self.true if self.true else 0.0

    def fpos_pct(self) -> float:
        return 100.0 * self.wrong / self.pred if self.pred else 0.0

    def to_json(self) -> dict:
        return {
            "commands": self.commands,
            "true_pages": self.true,
            "pred_pages": self.pred,
            "missed_pages": self.missed,
            "wrong_pages": self.wrong,
            "false_negative_pct": self.fneg_pct(),
            "false_positive_pct": self.fpos_pct(),
        }


class _Template(_Acc):
    """Per-template accumulator + the recent window behind the drift gauge."""

    __slots__ = ("window",)

    def __init__(self) -> None:
        super().__init__()
        self.window: Deque[Tuple[int, int, int, int]] = deque(
            maxlen=_DRIFT_WINDOW
        )

    def add(self, true: int, pred: int, missed: int, wrong: int) -> None:
        super().add(true, pred, missed, wrong)
        self.window.append((true, pred, missed, wrong))

    def drift_pp(self) -> float:
        """Recent-window F− minus lifetime F−, in percentage points. ~0 for
        a stable template; grows when recent predictions degrade."""
        wt = sum(w[0] for w in self.window)
        wm = sum(w[2] for w in self.window)
        recent = 100.0 * wm / wt if wt else 0.0
        return recent - self.fneg_pct()


class _Quantum:
    """Open audit window for one track's current timeslice."""

    __slots__ = ("task_id", "predicted", "populated", "touched")

    def __init__(self, task_id: int, predicted, populated) -> None:
        self.task_id = task_id
        self.predicted = predicted  # merged runs: the plan's predicted cut
        self.populated = populated  # merged runs: what the switch moved in
        self.touched: List[PageRun] = []


class PredictionAuditor:
    """Fleet-wide prediction scorer (see module docstring).

    Attach via ``Telemetry(audit=True)``; ``SimCore`` drives the four hooks
    (:meth:`begin_quantum`, :meth:`observe_command`, :meth:`observe_fault`,
    :meth:`end_quantum`) from its existing telemetry emission sites.
    """

    def __init__(self, metrics=None, page_size: int = 0) -> None:
        self.metrics = metrics  # MetricsRegistry or None
        self.page_size = int(page_size)
        self.fleet = _Acc()
        self.per_task: Dict[int, _Acc] = {}
        self.per_template: Dict[str, _Template] = {}
        # per-quantum working-set audit (plan vs touched)
        self.quanta = 0
        self.ws_true_pages = 0
        self.ws_pred_pages = 0
        self.ws_missed_pages = 0
        self.ws_wrong_pages = 0
        self.overfetch_pages = 0
        self.overfetch_bytes = 0
        # under-fetch residue (fault-service stalls inside audited quanta)
        self.underfetch_stall_us = 0.0
        self.underfetch_stall_by_task: Dict[int, float] = {}
        self.underfetch_faults = 0
        self._open: Dict[str, _Quantum] = {}  # track -> current quantum

    # -- switch / command / fault hooks (SimCore emission sites) ------------
    def begin_quantum(
        self,
        track: str,
        task_id: int,
        predicted_runs,
        populated_runs,
        page_size: int,
    ) -> None:
        """An extended context switch opened a timeslice on ``track``. The
        runs come from the coordinator's :class:`SwitchReport` — empty for
        backends that plan nothing (um) or plans without a predicted cut
        (legacy planning)."""
        if not self.page_size:
            self.page_size = int(page_size)
        self._close(track)
        self._open[track] = _Quantum(
            task_id,
            merge_runs(predicted_runs or ()),
            merge_runs(populated_runs or ()),
        )

    def observe_command(self, track: str, cmd, space) -> None:
        """One command executed inside the current quantum. Kernel commands
        with an annotate-time prediction feed the Table 1 accumulators; all
        commands feed the quantum's touched set."""
        q = self._open.get(track)
        true_runs = cmd.true_page_runs(space)
        if q is not None:
            q.touched.extend(true_runs)
        pred_runs = cmd.predicted_page_runs
        if pred_runs is None or cmd.kind != KERNEL:
            return
        true_m = merge_runs(true_runs)
        pred_m = merge_runs(pred_runs)
        nt = run_page_count(true_m)
        np_ = run_page_count(pred_m)
        ni = run_page_count(intersect_runs(true_m, pred_m))
        missed = nt - ni
        wrong = np_ - ni
        self.fleet.add(nt, np_, missed, wrong)
        tid = cmd.task_id
        acc = self.per_task.get(tid)
        if acc is None:
            acc = self.per_task[tid] = _Acc()
        acc.add(nt, np_, missed, wrong)
        tpl = self.per_template.get(cmd.name)
        if tpl is None:
            tpl = self.per_template[cmd.name] = _Template()
        tpl.add(nt, np_, missed, wrong)

    def observe_fault(self, track: str, task_id: int, stall_us: float) -> None:
        """A demand-paging stall inside the quantum: pages the plan failed
        to cover (a false negative, or pressure-evicted residency) serviced
        by the fallback pager — the under-fetch residue."""
        self.underfetch_stall_us += stall_us
        self.underfetch_stall_by_task[task_id] = (
            self.underfetch_stall_by_task.get(task_id, 0.0) + stall_us
        )
        self.underfetch_faults += 1

    def end_quantum(self, track: str) -> None:
        self._close(track)
        self._open.pop(track, None)

    def _close(self, track: str) -> None:
        q = self._open.get(track)
        if q is None:
            return
        touched = merge_runs(q.touched)
        nt = run_page_count(touched)
        npred = run_page_count(q.predicted)
        self.quanta += 1
        self.ws_true_pages += nt
        self.ws_pred_pages += npred
        if q.predicted:
            self.ws_missed_pages += run_page_count(
                subtract_runs(touched, q.predicted)
            )
            self.ws_wrong_pages += npred - run_page_count(
                intersect_runs(q.predicted, touched)
            )
        if q.populated:
            over = run_page_count(subtract_runs(q.populated, touched))
            self.overfetch_pages += over
            self.overfetch_bytes += over * self.page_size

    # -- fleet health -------------------------------------------------------
    def fleet_fneg_pct(self) -> float:
        return self.fleet.fneg_pct()

    def fleet_fpos_pct(self) -> float:
        return self.fleet.fpos_pct()

    def fleet_drift_pp(self) -> float:
        """Worst absolute per-template drift (0 with no audited templates)."""
        return max(
            (abs(t.drift_pp()) for t in self.per_template.values()),
            default=0.0,
        )

    def health(self) -> dict:
        """The gauges `msctl` surfaces next to the deadline counters."""
        return {
            "audited_commands": self.fleet.commands,
            "audited_quanta": self.quanta,
            "false_negative_pct": self.fleet_fneg_pct(),
            "false_positive_pct": self.fleet_fpos_pct(),
            "template_drift_pp": self.fleet_drift_pp(),
            "overfetch_bytes": self.overfetch_bytes,
            "underfetch_stall_us": self.underfetch_stall_us,
        }

    def export_gauges(self, metrics, track: str = "fleet") -> None:
        """Bank the audit totals into a :class:`MetricsRegistry` (called by
        the hub at every rollup). Counters are re-set via gauge-free deltas:
        the registry keeps monotone counters, so we write absolute values
        through a read-modify-write."""
        if metrics is None:
            return
        ps = self.page_size
        for name, value in (
            ("audit_commands_total", self.fleet.commands),
            ("audit_quanta_total", self.quanta),
            ("audit_true_pages_total", self.fleet.true),
            ("audit_pred_pages_total", self.fleet.pred),
            ("audit_fneg_pages_total", self.fleet.missed),
            ("audit_fpos_pages_total", self.fleet.wrong),
            ("audit_overfetch_bytes_total", self.overfetch_bytes),
            ("audit_underfetch_stall_us_total", self.underfetch_stall_us),
        ):
            cur = metrics.counter_value(name, track)
            if value > cur:
                metrics.inc(name, track, value - cur)
        metrics.gauge("audit_fneg_page_pct", track, self.fleet_fneg_pct())
        metrics.gauge("audit_fpos_page_pct", track, self.fleet_fpos_pct())
        metrics.gauge("audit_fneg_bytes", track, self.fleet.missed * ps)
        metrics.gauge("audit_fpos_bytes", track, self.fleet.wrong * ps)
        metrics.gauge(
            "audit_template_drift_pp", track, self.fleet_drift_pp()
        )

    # -- reconciliation -----------------------------------------------------
    def reconcile_ledger(self, telemetry) -> dict:
        """Cross-check the under-fetch residue against the stall ledger's
        raw ``fault_service`` accumulators: for a predictive backend, every
        demand-paging stall the ledger attributes happened inside an audited
        quantum, so the totals must agree exactly. Returns both totals and
        their difference (µs) for the caller to assert on."""
        ledger_total = sum(
            telemetry.ledger.raw(tid).get("fault_service", 0.0)
            for tid in set(self.underfetch_stall_by_task)
            | set(telemetry.ledger._acc)
        )
        return {
            "audit_underfetch_stall_us": self.underfetch_stall_us,
            "ledger_fault_service_us": ledger_total,
            "diff_us": self.underfetch_stall_us - ledger_total,
        }

    # -- report -------------------------------------------------------------
    def summary(self) -> dict:
        """The ``audit`` section of a :class:`MetricsReport`."""
        ps = self.page_size
        fleet = self.fleet.to_json()
        fleet.update(
            missed_bytes=self.fleet.missed * ps,
            wrong_bytes=self.fleet.wrong * ps,
        )
        return {
            "fleet": fleet,
            "per_task": {
                str(tid): acc.to_json()
                for tid, acc in sorted(self.per_task.items())
            },
            "per_template": {
                name: dict(t.to_json(), drift_pp=t.drift_pp())
                for name, t in sorted(self.per_template.items())
            },
            "working_set": {
                "quanta": self.quanta,
                "touched_pages": self.ws_true_pages,
                "predicted_pages": self.ws_pred_pages,
                "missed_pages": self.ws_missed_pages,
                "wrong_pages": self.ws_wrong_pages,
                "overfetch_pages": self.overfetch_pages,
                "overfetch_bytes": self.overfetch_bytes,
            },
            "underfetch": {
                "faults": self.underfetch_faults,
                "stall_us": self.underfetch_stall_us,
            },
            "health": self.health(),
        }
