"""The port's cluster telemetry against the JAX package's: the faulted
4-GPU traced run of ``tests/cluster/test_telemetry_cluster.py`` (a GPU
outage, a degraded link, checkpoints every 300 ms) with a full hub, event
for event: every event, counter series, the stall ledger and its breakdown,
the Chrome trace and JSONL, the metrics report and the prediction audit,
compared as JSON strings. The port's trace passes both packages'
``validate_trace`` and ``scripts/trace_report.py --validate``; tracing
changes no result of the port's run; the finish hook reaps an in-flight
linger copy alike; and where the reference's stall ledger refuses a traced
run, the port's refuses it with the same message."""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
PAGE = 1 << 20


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        cluster=mod("cluster"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        sim=mod("core.simulator"),
        serving=mod("serving"),
        telemetry=mod("telemetry"),
        hub=mod("telemetry.hub"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)


def same(ref, port):
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def _pin0(P):
    return type("Pin0", (P.cluster.PlacementPolicy,), {"name": "pin0", "place": lambda self, prog, t, cores: 0})()


def _faulted(P, telemetry=None, n=4):
    """The reference's faulted fleet (4 GPUs: its acceptance run; 2 GPUs:
    its tracing-unperturbed pin)."""
    C, S = P.cluster, P.serving
    if n == 4:
        events = [C.FaultEvent(700_000.0, "gpu_fail", gpu="gpu0"), C.FaultEvent(1_500_000.0, "gpu_recover", gpu="gpu0"),
                  C.FaultEvent(800_000.0, "link_degrade", link=("gpu0", "gpu2"), factor=0.25)]
        trace = S.poisson_trace(2.0, 1.5, seed=3, tenants=(ARCH,), prompt_mean=64, output_mean=200, max_output=400)
    else:
        events = [C.FaultEvent(500_000.0, "gpu_fail", gpu="gpu0"), C.FaultEvent(1_200_000.0, "gpu_recover", gpu="gpu0"),
                  C.FaultEvent(600_000.0, "link_degrade", link=("gpu0", "gpu1"), factor=0.5),
                  C.FaultEvent(900_000.0, "link_restore", link=("gpu0", "gpu1"))]
        trace = S.poisson_trace(6.0, 1.5, seed=3, tenants=(ARCH,), prompt_mean=64, output_mean=24, max_output=48)
    return own(C.simulate_cluster(
        trace, C.homogeneous(n, P.hardware.RTX5080, capacity_bytes=3 << 30, nvlink_gbps=P.hardware.NVLINK_A100_GBPS),
        backend="msched", placement=_pin0(P), admission_factory=lambda i: S.MSchedAdmission(headroom=0.9),
        policy_factory=lambda i: P.scheduler.RoundRobinPolicy(350_000.0), page_size=PAGE,
        slo=S.SLOSpec(ttft_us=3_000_000.0, tpot_us=100_000.0), faults=C.FaultInjector(events), telemetry=telemetry,
        rebalance_period_us=400_000.0, rebalance_threshold=0.4, checkpoint_period_us=300_000.0,
        drain_factor=20.0), P)


def _hub_state(hub, path):
    hub.write_jsonl(path)
    report = hub.metrics_report()
    return dict(
        events=[dataclasses.asdict(e) for e in hub.events],
        dropped=hub.dropped_events,
        series=hub.series,
        ledger={tid: hub.ledger.raw(tid) for tid in sorted({e.task_id for e in hub.events if e.task_id is not None})},
        breakdown=hub.stall_breakdown(),
        totals=hub.stall_totals(),
        summary=hub.summary,
        chrome=json.dumps(hub.chrome_trace()),
        jsonl=path.read_text(),
        metrics=json.dumps(report.to_json()),
        prometheus=report.to_prometheus(),
        audit=json.dumps(hub.audit.summary()),
    )


@pytest.fixture(scope="module")
def faulted_4gpu(tmp_path_factory):
    """Each package's faulted 4-GPU run with a full hub: (report, hub,
    everything the hub holds)."""
    out = {}
    for P in SIDES:
        hub = own(P.telemetry.Telemetry(sample_stride=1, metrics=True, audit=True), P)
        rep = _faulted(P, telemetry=hub)
        out[P.root] = (rep, hub, _hub_state(hub, tmp_path_factory.mktemp(P.root) / "run.jsonl"))
    return out


def test_faulted_4gpu_run_matches_event_for_event(faulted_4gpu):
    (ref_rep, _, ref), (port_rep, _, port) = faulted_4gpu["repro"], faulted_4gpu["repro_torch"]
    same(json.dumps(ref_rep.to_json(), sort_keys=True), json.dumps(port_rep.to_json(), sort_keys=True))
    assert port["events"], "the traced run emitted nothing"
    for key in ref:
        same(ref[key], port[key])
    names = {e["name"] for e in port["events"]}
    assert {"switch", "admission", "finish", "rebalance_tick", "gpu_fail", "gpu_recover", "checkpoint"} <= names


def test_faulted_4gpu_trace_validates(faulted_4gpu, tmp_path):
    """Both validators pass the port's trace; it has a track for each GPU,
    the cluster and a link, and the link and host probes."""
    _, hub, state = faulted_4gpu["repro_torch"]
    doc = json.loads(state["chrome"])
    assert PORT.telemetry.validate_trace(doc) == [] and REF.telemetry.validate_trace(doc) == []
    tracks = {ev["args"]["name"] for ev in doc["traceEvents"] if ev["ph"] == "M"}
    assert {"gpu0", "gpu1", "gpu2", "gpu3", PORT.telemetry.TRACK_CLUSTER} <= tracks
    assert any(t.startswith("link:") for t in tracks)
    assert "host/staged_bytes" in doc["probes"]
    paths = {}
    for root, (_, h, _) in faulted_4gpu.items():
        (tmp_path / root).mkdir()
        paths[root] = tmp_path / root / "f.trace"
        h.write_chrome(paths[root])
    assert paths["repro"].read_bytes() == paths["repro_torch"].read_bytes()
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def report(path, *flags):
        out = subprocess.run([sys.executable, str(ROOT / "scripts" / "trace_report.py"), path.name, *flags], env=env,
                             cwd=path.parent, capture_output=True, text=True, timeout=120)
        return out.returncode, out.stdout

    assert report(paths["repro_torch"], "--validate")[0] == 0
    same(report(paths["repro"]), report(paths["repro_torch"]))


def test_tracing_changes_no_result():
    """The port's counterpart of the reference's pin: the faulted 2-GPU
    fleet traced gives the untraced report."""
    off = _faulted(PORT, n=2)
    on = _faulted(PORT, telemetry=PORT.telemetry.Telemetry(sample_stride=1, metrics=True, audit=True), n=2)
    same(json.dumps(off.to_json(), sort_keys=True), json.dumps(on.to_json(), sort_keys=True))
    assert off.faults_applied == 4


def test_finish_hook_reap_matches():
    """A task finishing while its lazy-migration manifest is in flight has
    its linger copy reaped at retirement."""
    def story(P):
        topo = P.cluster.homogeneous(2, P.hardware.RTX5080, capacity_bytes=4 << 30,
                                     nvlink_gbps=P.hardware.NVLINK_A100_GBPS)
        cores = []
        for i in range(2):
            req = P.serving.Request(i, ARCH, 1_000.0, prompt_tokens=64, output_tokens=64, slo_class="be")
            cores.append(P.sim.SimCore(
                [], P.hardware.RTX5080, "msched", capacity_bytes=4 << 30,
                policy=P.scheduler.RoundRobinPolicy(350_000.0),
                task_events=[P.sim.TaskArrival(1_000.0, P.serving.ServedRequestTask(i, req, page_size=PAGE))],
                page_size=PAGE, prepopulate=False, name=f"gpu{i}",
                profile_set=[P.serving.ServedRequestTask(10_000_000 + i, req, page_size=PAGE)]))
        c0, c1 = cores
        fabric = P.cluster.PeerPrefetchFabric(topo, cores)
        fabric.wire()
        c0.pool.register_task(42, (0, 10))
        c0.pool.populate_runs([(0, 10)])
        c0.lingering.add(42)
        fabric.directory.record(42, "gpu0", "gpu1", [(0, 10)], arrival_us=1_000.0)
        out = [c0.pool.used]
        for t in (500.0, 600.0):
            c1.finish_hook(42, t)
            out.append((fabric.directory.get(42), fabric.finish_reaped, fabric.reclaimed_pages, c0.pool.used,
                        sorted(c0.lingering)))
        return out

    ref, port = (story(P) for P in SIDES)
    same(ref, port)
    assert port[1][1] == 10


def test_ledger_refusal_matches():
    """``examples/cluster_serve.py --migrate``'s round-robin run at 2 GPUs,
    traced: the reference's stall ledger attributes more stall to a
    migrated request than its wall leaves (the transit wait of a request
    moved at a rebalance tick) and raises ``LedgerConservationError``; the
    port, a copy, raises the same error with the same numbers."""
    def story(P):
        S = P.serving
        trace = S.bursty_trace(4.0, 4.0, seed=0, cv=4.0, tenants=(ARCH,), prompt_mean=128, output_mean=64,
                               max_output=128)
        cap = int(3 * S.ServedRequestTask(999, trace.requests[0], page_size=PAGE).footprint_bytes() / 1.5)
        topo = P.cluster.mixed([(P.hardware.A100_40G, cap // 2), (P.hardware.A100_80G, 3 * cap // 2)])
        with pytest.raises(P.hub.LedgerConservationError) as e:
            P.cluster.simulate_cluster(
                trace, topo, backend="msched", placement="roundrobin",
                admission_factory=lambda i: S.MSchedAdmission(headroom=0.9),
                policy_factory=lambda i: P.scheduler.RoundRobinPolicy(350_000.0), page_size=PAGE,
                slo=S.SLOSpec(ttft_us=3_000_000.0, tpot_us=100_000.0), rebalance_period_us=500_000.0,
                telemetry=P.telemetry.Telemetry())
        return str(e.value)

    ref, port = (story(P) for P in SIDES)
    same(ref, port)
    assert "task 8: attributed stall" in port
