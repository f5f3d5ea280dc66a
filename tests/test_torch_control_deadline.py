"""The port's deadline enforcement against the JAX package's, on
``tests/control/test_control_plane.py``'s overload: one RTX5080 with 2 GiB,
14 requests a second for 1.5 s (a quarter real-time) of 300 output tokens
on average, RT deadlines of 100 ms to the first token and 500 ms in all,
checked every 40 ms. Best-effort victims are preempted (ejected and
re-injected with a backoff) and every request still finishes.

The two runs must take the same decisions: the journal as
``DecisionJournal.to_json()`` text, the report as ``ClusterReport.to_json()``
text, every task's final state and the plane's counters. It is the
slowest of the reference's control tests, so it has a file of its own."""
import importlib
import json
import types

import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(root=root, cluster=mod("cluster"), control=mod("control"),
                                 hardware=mod("core.hardware"), scheduler=mod("core.scheduler"),
                                 serving=mod("serving"))


def own(obj, pkg):
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def _overload(P):
    S = P.serving
    cp = own(P.control.ControlPlane(deadlines=P.control.DeadlineSpec(rt_ttft_us=100_000.0, rt_latency_us=500_000.0),
                                    deadline_period_us=40_000.0), P)
    trace = S.poisson_trace(14.0, 1.5, seed=9, tenants=("qwen3-1.7b",), prompt_mean=64, output_mean=300,
                            max_output=600, rt_fraction=0.25)
    rep = own(P.cluster.simulate_cluster(
        trace, P.cluster.homogeneous(1, P.hardware.RTX5080, capacity_bytes=2 << 30,
                                     nvlink_gbps=P.hardware.NVLINK_A100_GBPS),
        backend="msched", placement="roundrobin", page_size=1 << 20, drain_factor=20.0,
        admission_factory=lambda i: S.MSchedAdmission(headroom=0.9),
        policy_factory=lambda i: P.scheduler.RoundRobinPolicy(350_000.0),
        faults=P.cluster.FaultInjector.none(), control=cp, audit=True), P)
    return dict(report=json.dumps(rep.to_json(), sort_keys=True), journal=json.dumps(cp.journal.to_json()),
                states=sorted(cp.lifecycle.states().items()),
                counters=[cp.preemptions, cp.deadline_sheds, cp.deadline_misses, cp.rt_requests, cp.lost])


def test_deadline_preemption_matches():
    ref, port = (_overload(_pkg(root)) for root in ("repro", "repro_torch"))
    for key in ref:
        assert ref[key] == port[key], key
    preemptions, _, misses, rt, _ = port["counters"]
    assert preemptions > 0 and misses > 0 and rt > 0
    doc = json.loads(port["report"])
    assert doc["stats"]["n_finished"] == doc["stats"]["n_requests"]
    assert any("preempted_us" in r["meta"] for r in doc["merged"]["requests"])
