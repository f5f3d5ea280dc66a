"""The port's serving layer against the JAX package's: request traces,
``serve_trace`` under both admission controllers, the SLO deadline policy
and the request statistics it reads, the example
(``examples/port_serve_trace.py``), and phase 10's table in
``chip_smoke.py``.

Exact equality throughout (``repr`` of ``dataclasses.asdict``: bit-equal
floats). Each side builds its trace, platform, policy and admission from its
own package."""
import dataclasses
import importlib
import importlib.util
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
        serving=mod("serving"),
        sim=mod("core.simulator"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        deadline=mod("control.deadline"),
        aggregate=mod("cluster.aggregate"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)


def same(ref, port):
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def _load(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


# (generator, args, kwargs): every arrival process, class-free and with
# real-time requests (rt_fraction > 0 draws each request's class)
TRACES = {
    "poisson": ("poisson_trace", (5.0, 1.2), dict(seed=7, prompt_mean=64, output_mean=16, max_output=32)),
    "bursty": ("bursty_trace", (4.0, 2.0), dict(seed=0, cv=3.0, prompt_mean=128, output_mean=16, max_output=32)),
    "diurnal": ("diurnal_trace", (5.0, 1.5), dict(seed=3, prompt_mean=64, output_mean=12, max_output=24)),
    "poisson_rt": ("poisson_trace", (30.0, 1.0), dict(seed=11, prompt_mean=64, output_mean=12, max_output=24,
                                                     rt_fraction=0.4)),
}


def _trace(pkg, name):
    gen, args, kw = TRACES[name]
    return own(getattr(pkg.serving, gen)(*args, tenants=(ARCH,), **kw), pkg)


@pytest.mark.parametrize("name", sorted(TRACES))
def test_traces_match(name):
    ref, port = (_trace(p, name) for p in SIDES)
    assert len(ref) > 3
    same(ref.to_json(), port.to_json())
    same([dataclasses.asdict(r) for r in ref], [dataclasses.asdict(r) for r in port])
    same((ref.duration_us(), ref.offered_rate_rps(), ref.total_output_tokens()),
         (port.duration_us(), port.offered_rate_rps(), port.total_output_tokens()))
    if name.endswith("_rt"):
        assert {r.slo_class for r in port} == {"rt", "be"}


def test_each_package_loads_the_others_trace(tmp_path):
    for name in TRACES:
        ref, port = (_trace(p, name) for p in SIDES)
        ref.save(tmp_path / f"{name}.ref.json")
        port.save(tmp_path / f"{name}.port.json")
        assert (tmp_path / f"{name}.ref.json").read_bytes() == (tmp_path / f"{name}.port.json").read_bytes()
        from_ref = own(PORT.serving.Trace.load(tmp_path / f"{name}.ref.json"), PORT)
        from_port = own(REF.serving.Trace.load(tmp_path / f"{name}.port.json"), REF)
        same(from_ref.to_json(), ref.to_json())
        same(from_port.to_json(), port.to_json())


def _admission(pkg, kind):
    if kind == "always":
        return "um", pkg.serving.AlwaysAdmit(), 2_000.0
    if kind == "msched":
        return "msched", pkg.serving.MSchedAdmission(headroom=0.9), 350_000.0
    # best-effort work held to a tighter budget and shed after 0.4 s queued:
    # slo_class_of decides which headroom a candidate gets
    return "msched", pkg.serving.MSchedAdmission(headroom=0.9, be_headroom=0.45, max_wait_us=400_000.0), 350_000.0


def _serve(pkg, trace_name, kind, telemetry=None):
    backend, admission, quantum = _admission(pkg, kind)
    rep = pkg.serving.serve_trace(
        _trace(pkg, trace_name), pkg.hardware.RTX5080, backend=backend, capacity_bytes=3 << 30,
        admission=own(admission, pkg), policy=pkg.scheduler.RoundRobinPolicy(quantum), page_size=PAGE,
        slo=pkg.serving.SLOSpec(ttft_us=2_000_000.0, tpot_us=50_000.0), telemetry=telemetry,
    )
    counts = (admission.admitted, admission.queued, admission.rejected) if kind != "always" else ()
    return own(rep, pkg), counts


SERVE_CASES = [(t, k) for t in ("poisson", "bursty", "diurnal") for k in ("always", "msched")]
SERVE_CASES += [("poisson_rt", "msched"), ("poisson_rt", "msched_be")]


@pytest.mark.parametrize("trace_name,kind", SERVE_CASES)
def test_serve_trace_matches(trace_name, kind):
    (ref, ref_counts), (port, port_counts) = (_serve(p, trace_name, kind) for p in SIDES)
    same(dataclasses.asdict(ref), dataclasses.asdict(port))
    same(ref.to_row(), port.to_row())
    same(ref_counts, port_counts)
    assert port.n_requests == len(_trace(PORT, trace_name)) and port.n_finished > 0
    if kind == "msched_be":
        assert port_counts[1] > 0, "no request was queued: be_headroom was never read"


def test_served_request_lifecycle_matches():
    progs = []
    for pkg in SIDES:
        req = pkg.serving.Request(5, ARCH, 1_000.0, prompt_tokens=300, output_tokens=7, slo_class="rt")
        task = own(pkg.serving.ServedRequestTask(5, req, page_size=PAGE), pkg)
        progs.append((task.footprint_bytes(), task.total_iterations, task.slo_class,
                      [[dataclasses.asdict(c) for c in task.iteration(it)] for it in range(task.total_iterations)],
                      [dataclasses.asdict(e.program.space.buffers[0]) for e in pkg.serving.build_events(
                          pkg.serving.Trace([req]), page_size=PAGE)]))
    same(*progs)


def _deadline_views(pkg):
    """At-risk and victim answers of each package's DeadlineMonitor on a core
    part-way through an rt/be trace, with each request's class."""
    events = pkg.serving.build_events(_trace(pkg, "poisson_rt"), page_size=PAGE)
    core = pkg.sim.SimCore(
        [], pkg.hardware.RTX5080, "msched", capacity_bytes=3 << 30,
        policy=pkg.scheduler.RoundRobinPolicy(350_000.0), task_events=events,
        admission=pkg.serving.MSchedAdmission(headroom=0.9), page_size=PAGE, prepopulate=False,
        profile_set=[ev.program for ev in events[:1]],
    )
    monitor = own(pkg.deadline.DeadlineMonitor(pkg.deadline.DeadlineSpec(rt_ttft_us=150_000.0)), pkg)
    out = [[pkg.deadline.slo_class_of(ev.meta, ev.program) for ev in events],
           pkg.deadline.slo_class_of(None, types.SimpleNamespace(slo_class="rt"))]
    for t in (200_000.0, 500_000.0, 900_000.0, 1_300_000.0):
        core.run(t, final=False)
        out.append((t, monitor.at_risk(core, t), monitor.pick_victim(core, t)))
    out.append([monitor.backoff_for(7) for _ in range(5)])
    return out


def test_deadline_monitor_matches():
    ref, port = (_deadline_views(p) for p in SIDES)
    same(ref, port)
    assert any(risky for _, risky, _ in port[2:-1]), "no rt request was ever at risk"


def test_request_stats_match():
    got = []
    for pkg in SIDES:
        rep, _ = _serve(pkg, "bursty", "always")
        recs = rep.result.requests
        foot = {r.task_id: 1000 + 17 * r.task_id for r in recs}
        stats = own(pkg.aggregate.RequestStats.from_records(recs, 2_000_000.0, 50_000.0, 2e6), pkg)
        got.append((dataclasses.asdict(stats), pkg.aggregate.peak_concurrent_bytes(foot, recs)))
    same(*got)


# --------------------------------------------------------------------------
# The example and phase 10's table
# --------------------------------------------------------------------------


def _reference_example_reports(monkeypatch, capsys):
    """The JAX package's ``examples/serve_trace.py`` run at its defaults; its
    ``serve_trace`` calls are recorded."""
    example = _load(ROOT / "examples" / "serve_trace.py", "reference_serve_trace")
    reports = {}
    serve = example.serve_trace

    def record(*args, **kw):
        rep = serve(*args, **kw)
        reports[rep.backend] = rep
        return rep

    monkeypatch.setattr(example, "serve_trace", record)
    monkeypatch.setattr(sys, "argv", ["serve_trace.py"])
    example.main()
    return reports, capsys.readouterr().out


def test_chip_smoke_table_is_the_reference(monkeypatch, capsys):
    """Phase 10 gates the card's run against ``SIM_REFERENCE``: it must be
    the reference's scoreboard, exactly, and the port's too on this CPU."""
    chip_smoke = _load(ROOT / "chip_smoke.py", "chip_smoke_table")
    reference, ref_out = _reference_example_reports(monkeypatch, capsys)
    assert set(reference) == set(chip_smoke.SIM_REFERENCE)
    for backend, rep in reference.items():
        same(chip_smoke.sim_scoreboard(rep), chip_smoke.SIM_REFERENCE[backend])
    example = _load(ROOT / "examples" / "port_serve_trace.py", "port_serve_trace_table")
    port = example.run()
    assert capsys.readouterr().out == ref_out
    for backend, rep in port.items():
        own(rep, PORT)
        same(chip_smoke.sim_scoreboard(rep), chip_smoke.SIM_REFERENCE[backend])
        same(dataclasses.asdict(reference[backend]), dataclasses.asdict(rep))


@pytest.mark.parametrize("args", [[], ["--arch", "mamba2-1.3b"], ["--arch", "llama3.2-3b", "--seed", "1"]],
                         ids=["defaults", "mamba2", "llama3.2"])
def test_example_prints_the_reference_lines(args):
    """``examples/port_serve_trace.py`` as a script prints the reference
    example's lines. mamba2-1.3b has no attention heads, and both examples
    stop alike with an AssertionError in ``LLMDecodeTask`` before printing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    ref, port = (
        subprocess.run([sys.executable, str(ROOT / "examples" / script), *args], env=env, cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
        for script in ("serve_trace.py", "port_serve_trace.py")
    )
    assert port.stdout == ref.stdout
    assert port.returncode == ref.returncode
    if args[1:2] == ["mamba2-1.3b"]:
        assert ref.returncode != 0 and port.stdout == ""
        assert port.stderr.strip().splitlines()[-1] == ref.stderr.strip().splitlines()[-1] == "AssertionError"
    else:
        assert port.returncode == 0 and len(port.stdout.splitlines()) == 3, port.stderr
