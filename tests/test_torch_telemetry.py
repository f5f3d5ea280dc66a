"""The port's telemetry against the JAX package's: every event a traced run
emits, the counter series, the stall ledger, the exported Chrome trace and
JSONL, the metrics report and the prediction audit, on the same serving and
static runs. Traces are compared as JSON strings; the port's trace passes
both packages' ``validate_trace`` and ``scripts/trace_report.py
--validate``; and, as the reference pins for itself, tracing changes no
result of the port's simulator."""
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
BACKENDS = ("um", "msched", "ideal", "suv")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        telemetry=mod("telemetry"),
        serving=mod("serving"),
        sim=mod("core.simulator"),
        workloads=mod("core.workloads"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)


def same(ref, port):
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def _hub(pkg, **kw):
    kw = {"sample_stride": 1, "metrics": True, "audit": True, **kw}
    return own(pkg.telemetry.Telemetry(**kw), pkg)


def _serve(pkg, backend, telemetry=None):
    """tests/core/test_telemetry.py's serving run."""
    admission = pkg.serving.MSchedAdmission(headroom=0.9) if backend == "msched" else pkg.serving.AlwaysAdmit()
    trace = pkg.serving.poisson_trace(5.0, 1.2, seed=7, tenants=(ARCH,), prompt_mean=64, output_mean=16,
                                      max_output=32)
    q = 2_000.0 if backend in ("um", "suv") else 350_000.0
    return pkg.serving.serve_trace(
        trace, pkg.hardware.RTX5080, backend=backend, capacity_bytes=3 << 30, admission=admission,
        policy=pkg.scheduler.RoundRobinPolicy(q), page_size=PAGE,
        slo=pkg.serving.SLOSpec(ttft_us=3_000_000.0, tpot_us=100_000.0), telemetry=telemetry,
    )


def _static(pkg, backend, telemetry=None):
    """tests/core/test_telemetry.py's static run."""
    progs = [pkg.workloads.LLMDecodeTask(0, page_size=PAGE, max_context=512),
             pkg.workloads.MatMulTask(1, 2048, page_size=PAGE)]
    foot = sum(p.footprint_bytes() for p in progs)
    q = 2_000.0 if backend in ("um", "suv") else 350_000.0
    return pkg.sim.simulate(
        progs, pkg.hardware.RTX5080, backend, capacity_bytes=int(foot / 1.5), sim_us=1_000_000.0,
        policy=pkg.scheduler.RoundRobinPolicy(q), telemetry=telemetry,
    )


def _hub_state(hub, tmp_path, tag):
    """Everything a hub holds or exports, as plain values and strings."""
    jsonl = tmp_path / f"{tag}.jsonl"
    hub.write_jsonl(jsonl)
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
        jsonl=jsonl.read_text(),
        metrics=json.dumps(report.to_json()),
        prometheus=report.to_prometheus(),
        audit=json.dumps(hub.audit.summary()),
    )


def test_taxonomies_match():
    for name in ("EVENT_TYPES", "STALL_CATEGORIES", "SCHEMA", "METRIC_TYPES", "METRICS_SCHEMA", "TRACK_CLUSTER"):
        same(getattr(REF.telemetry, name), getattr(PORT.telemetry, name))


@pytest.mark.parametrize("run", ["serve", "static"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_traced_run_matches_event_for_event(run, backend, tmp_path):
    fn = {"serve": _serve, "static": _static}[run]
    got = []
    for pkg in SIDES:
        hub = _hub(pkg)
        out = fn(pkg, backend, telemetry=hub)
        result = out.result if run == "serve" else out
        got.append((dataclasses.asdict(own(result, pkg)), _hub_state(hub, tmp_path, f"{pkg.root}-{run}-{backend}")))
    (ref_result, ref), (port_result, port) = got
    same(ref_result, port_result)
    assert port["events"], "the traced run emitted nothing"
    for key in ref:
        same(ref[key], port[key])
    chrome = json.loads(port["chrome"])
    assert PORT.telemetry.validate_trace(chrome) == []
    assert REF.telemetry.validate_trace(chrome) == []
    assert PORT.telemetry.validate_trace(json.loads(ref["chrome"])) == []


def test_event_cap_matches(tmp_path):
    """A hub capped at 200 events drops the same events (ends paired with
    their dropped begins) and still exports a valid trace."""
    got = []
    for pkg in SIDES:
        hub = _hub(pkg, max_events=200)
        _serve(pkg, "um", telemetry=hub)
        got.append(_hub_state(hub, tmp_path, f"{pkg.root}-capped"))
    ref, port = got
    assert port["dropped"] > 0
    for key in ref:
        same(ref[key], port[key])
    assert PORT.telemetry.validate_trace(json.loads(port["chrome"])) == []


def test_trace_report_reads_the_ports_trace(tmp_path):
    """``scripts/trace_report.py`` (the reference's tool) validates the
    port's exported trace, and reports it as it reports the reference's."""
    paths = {}
    for pkg in SIDES:
        hub = _hub(pkg)
        _serve(pkg, "msched", telemetry=hub)
        (tmp_path / pkg.root).mkdir()
        paths[pkg.root] = tmp_path / pkg.root / "run.trace"
        hub.write_chrome(paths[pkg.root])
    assert paths["repro"].read_bytes() == paths["repro_torch"].read_bytes()
    script = ROOT / "scripts" / "trace_report.py"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def report(path, *flags):
        # run beside the file: the report's header names the path it was given
        out = subprocess.run([sys.executable, str(script), path.name, *flags], env=env, cwd=path.parent,
                             capture_output=True, text=True, timeout=120)
        return out.returncode, out.stdout

    rc, _ = report(paths["repro_torch"], "--validate")
    assert rc == 0
    for flags in ((), ("--json",)):
        same(report(paths["repro"], *flags), report(paths["repro_torch"], *flags))


@pytest.mark.parametrize("backend", BACKENDS)
def test_serving_run_unperturbed_by_tracing(backend):
    """The port's counterpart of tests/core/test_telemetry.py's pin: a run
    with a full hub gives the untraced run's result, bit for bit."""
    off = _serve(PORT, backend, telemetry=None)
    on = _serve(PORT, backend, telemetry=_hub(PORT))
    same(dataclasses.asdict(off), dataclasses.asdict(on))
    same(off.to_row(), on.to_row())


@pytest.mark.parametrize("backend", BACKENDS)
def test_static_run_unperturbed_by_tracing(backend):
    off = _static(PORT, backend, telemetry=None)
    on = _static(PORT, backend, telemetry=_hub(PORT))
    same(dataclasses.asdict(off), dataclasses.asdict(on))


def test_validator_flags_the_same_faults():
    """Both validators give the same errors on broken documents."""
    hub = _hub(PORT)
    _serve(PORT, "msched", telemetry=hub)
    good = hub.chrome_trace()
    events = good["traceEvents"]
    timed = [i for i, ev in enumerate(events) if ev["ph"] != "M"]
    broken = [
        [],
        {},
        {"traceEvents": [dict(events[timed[0]], ph="Q")]},
        {**good, "traceEvents": [events[i] for i in reversed(timed[:20])]},
        {**good, "traceEvents": [ev for ev in events if ev["ph"] != "E"]},
        {**good, "traceEvents": [dict(ev, dur=-1.0) if ev["ph"] == "X" else ev for ev in events]},
    ]
    for doc in broken:
        errors = PORT.telemetry.validate_trace(doc)
        assert errors
        same(REF.telemetry.validate_trace(doc), errors)
