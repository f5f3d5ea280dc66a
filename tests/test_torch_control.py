"""The port's control plane against the JAX package's: the lifecycle state
machine (every kind from every state through ``apply_event``), the decision
journal (closed kinds, FIFO hold and release, the primitive-only JSON), and
``ControlPlane`` on the scenarios of ``tests/control/test_control_plane.py``:
the zero-impact observer, a coordinator crash recovered by journal replay
(with ``replay_check``) or by a cold restart, a coordinator that never comes
back, the crash's telemetry, an operator cancel, escalation to a shed, and
the wiring errors.

The control plane keys its bookkeeping on ``id()``, so plans are compared by
the decisions they take: the journal as ``DecisionJournal.to_json()`` text,
the run as ``ClusterReport.to_json()`` text, and every task's final state
and the plane's counters. Each side is built from its own package."""
import dataclasses
import importlib
import itertools
import json
import random
import types

import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        cluster=mod("cluster"),
        control=mod("control"),
        lifecycle=mod("control.lifecycle"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        invariants=mod("core.invariants"),
        serving=mod("serving"),
        telemetry=mod("telemetry"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)
ARCH = "qwen3-1.7b"
PAGE = 1 << 20


def same(ref, port):
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def both(fn):
    ref, port = (fn(P) for P in SIDES)
    same(ref, port)
    return port


# --------------------------------------------------------------------------
# Lifecycle and journal
# --------------------------------------------------------------------------


def test_state_machine_tables_match():
    L = [P.lifecycle for P in SIDES]
    for name in ("TASK_STATES", "TERMINAL_STATES"):
        same(*(sorted(getattr(m, name)) for m in L))
    same(*({k: sorted(v) for k, v in m.LEGAL_EDGES.items()} for m in L))
    same(*(sorted(m.JOURNAL_KINDS) for m in (P.control for P in SIDES)))
    assert issubclass(PORT.control.LifecycleError, PORT.invariants.InvariantViolation)


def _drive(P, seed):
    """Random journal kinds on a few tasks through ``apply_event``: each
    record's outcome (the state it leaves, or the error it raises)."""
    C = P.control
    kinds = sorted(C.JOURNAL_KINDS) + ["meteor"]
    rnd = random.Random(seed)
    lc, out = own(C.TaskLifecycle(), P), []
    for step in range(300):
        kind, tid = rnd.choice(kinds), rnd.choice([0, 1, 2, 3, None])
        try:
            C.apply_event(lc, kind, tid, float(step))
            out.append((kind, tid, lc.state(tid), lc.since(tid)))
        except C.LifecycleError as e:
            out.append((kind, tid, "error", str(e)))
        if rnd.random() < 0.05:
            lc.assume(rnd.choice([0, 1, 2, 3]), rnd.choice(sorted(C.TASK_STATES)), float(step))
    return out, lc.states(), [lc.count(s) for s in sorted(C.TASK_STATES)], len(lc)


@pytest.mark.parametrize("seed", range(4))
def test_apply_event_matches(seed):
    out = both(lambda P: _drive(P, seed))[0]
    assert {o[2] for o in out} >= {"error", "SUBMITTED", "ADMITTED"}


def test_every_edge_matches():
    """Each kind applied once from each state (reached by ``assume``)."""
    def story(P):
        C, out = P.control, []
        for state, kind in itertools.product(sorted(C.TASK_STATES), sorted(C.JOURNAL_KINDS)):
            lc = C.TaskLifecycle()
            lc.assume(7, state, 0.0)
            try:
                C.apply_event(lc, kind, 7, 1.0)
                out.append(lc.state(7))
            except C.LifecycleError as e:
                out.append(str(e))
        return out

    assert len(both(story)) == 9 * 19


def test_journal_matches():
    def story(P):
        C, out = P.control, []
        j = own(C.DecisionJournal(), P)
        with pytest.raises(ValueError) as e:
            j.append("meteor_strike", 0.0, 1)
        out.append(str(e.value))
        for k in ("submit", "place", "admit", "finish"):
            j.append(k, 0.0, 1)
        j.append("hold", 0.0, 1, ev="first")
        j.append("hold", 1.0, 1, ev="second")
        j.append("strand", 2.0, 2, prog=object(), completed=7, origin="gpu0")
        j.append("requeue", 3.0, 3)
        j.append("release", 4.0, 1, of="hold")
        j.append("release", 5.0, 2, of="hold")
        j.append("release", 6.0, 9, of="strand")
        out += [[dataclasses.asdict(r) | {"payload": sorted(r.payload)} for r in j.unreleased()], len(j),
                [r.seq for r in j], json.dumps(j.to_json())]
        return out

    both(story)


# --------------------------------------------------------------------------
# ControlPlane over simulate_cluster
# --------------------------------------------------------------------------


def _trace(P, rate=6.0, duration=1.2, seed=5, output_mean=120, rt_fraction=0.0):
    return P.serving.poisson_trace(rate, duration, seed=seed, tenants=(ARCH,), prompt_mean=64,
                                   output_mean=output_mean, max_output=2 * output_mean, rt_fraction=rt_fraction)


def _topo(P, n=2, cap=4 << 30):
    return P.cluster.homogeneous(n, P.hardware.RTX5080, capacity_bytes=cap, nvlink_gbps=P.hardware.NVLINK_A100_GBPS)


def _run(P, trace, topo, backend="msched", **kw):
    quantum = 2_000.0 if backend == "um" else 350_000.0
    args = dict(backend=backend, placement="leastloaded", page_size=PAGE, drain_factor=20.0,
                policy_factory=lambda i: P.scheduler.RoundRobinPolicy(quantum))
    if backend == "msched":
        args["admission_factory"] = lambda i: P.serving.MSchedAdmission(headroom=0.9)
    args.update(kw)
    return own(P.cluster.simulate_cluster(trace, topo, **args), P)


def _faults(P, *events):
    return P.cluster.FaultInjector([P.cluster.FaultEvent(t, kind, **kw) for t, kind, kw in events])


CRASH_CYCLE = ((300_000.0, "coordinator_crash", {}), (400_000.0, "gpu_fail", {"gpu": "gpu0"}),
               (600_000.0, "gpu_recover", {"gpu": "gpu0"}), (800_000.0, "coordinator_recover", {}))


def outcome(rep, cp):
    """What a controlled run decided: the report and the journal as text,
    every task's state, and the plane's counters."""
    return dict(report=json.dumps(rep.to_json(), sort_keys=True), journal=json.dumps(cp.journal.to_json()),
                states=sorted(cp.lifecycle.states().items()),
                counters=[cp.crashes, cp.replays, cp.preemptions, cp.deadline_sheds, cp.deadline_misses,
                          cp.rt_requests, cp.lost, cp.placed, cp.down],
                status=[cp.status(t) for t in range(-1, 40)])


@pytest.mark.parametrize("backend", ["um", "msched"])
def test_observer_run_matches(backend):
    def story(P):
        cp = own(P.control.ControlPlane(), P)
        return outcome(_run(P, _trace(P), _topo(P), backend=backend, faults=P.cluster.FaultInjector.none(),
                            control=cp), cp)

    assert json.loads(both(story)["journal"])


def test_generous_deadlines_match():
    def story(P):
        cp = P.control.ControlPlane(deadlines=P.control.DeadlineSpec(rt_ttft_us=9e9, rt_latency_us=9e9),
                                    deadline_period_us=50_000.0)
        return outcome(_run(P, _trace(P, rt_fraction=0.3), _topo(P), faults=P.cluster.FaultInjector.none(),
                            control=cp), cp)

    both(story)


@pytest.mark.parametrize("recovery", ["journal", "cold"])
def test_coordinator_crash_matches(recovery):
    """The crash cycle bracketing a GPU failure: journal replay (checked
    twice for idempotence at recovery) or a cold restart."""
    def story(P):
        cp = P.control.ControlPlane(recovery=recovery, replay_check=recovery == "journal")
        return outcome(_run(P, _trace(P), _topo(P), faults=_faults(P, *CRASH_CYCLE), recovery="auto",
                            checkpoint_period_us=250_000.0, control=cp, audit=True), cp)

    doc = json.loads(both(story)["report"])
    assert doc["coordinator_crashes"] == 1 and doc["journal_replays"] == (recovery == "journal")


def test_terminal_outage_matches():
    def story(P):
        cp = P.control.ControlPlane(recovery="journal")
        faults = _faults(P, (200_000.0, "coordinator_crash", {}), (250_000.0, "gpu_fail", {"gpu": "gpu0"}),
                         (280_000.0, "gpu_fail", {"gpu": "gpu1"}))
        return outcome(_run(P, _trace(P, rate=8.0, duration=0.8, output_mean=60), _topo(P), faults=faults,
                            recovery="auto", control=cp, audit=True), cp)

    assert json.loads(both(story)["report"])["lost_requests"] > 0


def test_crash_telemetry_matches():
    """The crash cycle traced: the hub's events and its Chrome trace."""
    def story(P):
        tel = own(P.telemetry.Telemetry(), P)
        cp = P.control.ControlPlane(recovery="journal")
        rep = _run(P, _trace(P), _topo(P), faults=_faults(P, *CRASH_CYCLE), recovery="auto", control=cp,
                   audit=True, telemetry=tel)
        return outcome(rep, cp), [dataclasses.asdict(e) for e in tel.events], json.dumps(tel.chrome_trace())

    _, events, chrome = both(story)
    assert {"coordinator_crash", "coordinator_recover", "journal_replay"} <= {e["name"] for e in events}
    assert PORT.telemetry.validate_trace(json.loads(chrome)) == []


def test_cancel_matches():
    def story(P):
        cp = P.control.ControlPlane()
        cp.cancel(1, 500_000.0)
        return outcome(_run(P, _trace(P), _topo(P), faults=P.cluster.FaultInjector.none(), control=cp), cp)

    assert dict(both(story)["states"])[1] == "CANCELLED"


def test_escalation_matches():
    """One RT task always at risk and one BE victim: the second pick past
    ``max_preemptions`` escalates to a journaled shed."""
    def story(P):
        S = P.serving
        tr = S.Trace([S.Request(0, ARCH, 0.0, prompt_tokens=64, output_tokens=800, slo_class="rt"),
                      S.Request(1, ARCH, 10_000.0, prompt_tokens=64, output_tokens=800, slo_class="be")])
        cp = P.control.ControlPlane(deadlines=P.control.DeadlineSpec(rt_ttft_us=100_000.0, rt_latency_us=1_000_000.0),
                                    deadline_period_us=40_000.0, max_preemptions=1)
        return outcome(_run(P, tr, _topo(P, n=1, cap=12 << 30), faults=P.cluster.FaultInjector.none(), control=cp,
                            placement="roundrobin", audit=True, sim_us=6_000_000.0), cp)

    doc = json.loads(both(story)["report"])
    assert doc["preemptions"] == 1 and doc["deadline_sheds"] == 1


def test_wiring_errors_match():
    def story(P):
        out = []
        with pytest.raises(ValueError) as e:
            P.control.ControlPlane(recovery="warmish")
        out.append(str(e.value))
        with pytest.raises(ValueError) as e:
            _run(P, _trace(P), _topo(P), faults=_faults(P, *CRASH_CYCLE))
        out.append(str(e.value))
        cp = P.control.ControlPlane()
        _run(P, _trace(P, rate=2.0, duration=0.4), _topo(P), faults=P.cluster.FaultInjector.none(), control=cp)
        with pytest.raises(ValueError) as e:
            _run(P, _trace(P, rate=2.0, duration=0.4), _topo(P), faults=P.cluster.FaultInjector.none(), control=cp)
        out.append(str(e.value))
        return out

    assert "control plane" in both(story)[1]
