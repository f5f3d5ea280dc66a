"""The port's simulator layer against the JAX package's: the workload
generators, the demand pager, ``simulate`` over every backend, planning
engine, pool kind and predictor, and the invariant audits.

Both packages run the same Python on the same inputs, so the bar is exact
equality: integer counters equal, floats bit-equal (compared through
``repr`` of ``dataclasses.asdict``, which also tells ints from floats).
Each side is built entirely from its own package (platform, policy,
programs), so a module missing from the port cannot hide behind the
reference's objects."""
import dataclasses
import importlib
import random
import re
import types
from pathlib import Path

import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        configs=mod("configs"),
        workloads=mod("core.workloads"),
        pager=mod("core.demand_paging"),
        sim=mod("core.simulator"),
        hbm=mod("core.hbm"),
        pages=mod("core.pages"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        invariants=mod("core.invariants"),
        serving=mod("serving"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)


def same(ref, port):
    """Exact equality, and equal reprs (bit-equal floats, same types)."""
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    """``obj`` was built from ``pkg``'s own classes."""
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


# --------------------------------------------------------------------------
# The copies
# --------------------------------------------------------------------------

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = ("core/workloads.py", "core/demand_paging.py", "core/simulator.py", "core/invariants.py",
          "control/deadline.py", "cluster/aggregate.py", "serving/__init__.py", "serving/traces.py",
          "serving/lifecycle.py", "serving/admission.py", "serving/engine.py", "telemetry/__init__.py",
          "telemetry/hub.py", "telemetry/metrics.py", "telemetry/audit.py", "telemetry/export.py")


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_is_the_references(path):
    """Each module of the slice is the reference's text with ``repro.``
    rewritten to ``repro_torch.`` and one docstring paragraph added."""
    port = (SRC / "repro_torch" / path).read_text()
    note = re.compile(r"\n\nCopied from the JAX package's ``" + re.escape(path) + r"``[^\n]*(\n[^\n]+)*(?=\n\"\"\")")
    assert len(note.findall(port)) == 1, path
    assert note.sub("", port).replace("repro_torch.", "repro.") == (SRC / "repro" / path).read_text()


# --------------------------------------------------------------------------
# Workloads
# --------------------------------------------------------------------------

# (class, kwargs) at small sizes; every generator class of core/workloads.py
WORKLOADS = [
    ("VecAddTask", dict(n_bytes=2 << 20, kernels_per_iter=3)),
    ("MatMulTask", dict(dim=512, n_matrices=6)),
    ("Dwt2dTask", dict(side=512)),
    ("HotspotTask", dict(cells=1 << 16)),
    ("CfdTask", dict(elems=1 << 16)),
    ("NnTask", dict(records=1 << 20)),
    *[("DNNInferTask", dict(model=m, batch=4)) for m in ("resnet152", "vgg19", "inceptionv3", "densenet201")],
    ("DNNTrainTask", dict(model="resnet152", batch=4)),
]


def _program_state(pkg, prog, page_size, iters=3):
    space = prog.space
    return dict(
        name=prog.name,
        buffers=[dataclasses.asdict(b) for b in space.buffers.values()],
        span=space.page_span(),
        footprint_bytes=prog.footprint_bytes(),
        footprint_pages=pkg.workloads.footprint_pages(prog, page_size),
        total_iterations=prog.total_iterations,
        commands=[[dataclasses.asdict(c) for c in prog.iteration(it)] for it in range(iters)],
    )


@pytest.mark.parametrize("page_size", [4096, 1 << 20])
@pytest.mark.parametrize("cls,kw", WORKLOADS, ids=[f"{c}-{kw.get('model', '')}" for c, kw in WORKLOADS])
def test_workload_generators_match(cls, kw, page_size):
    ref, port = (_program_state(p, own(getattr(p.workloads, cls)(3, page_size=page_size, **kw), p), page_size)
                 for p in SIDES)
    same(ref, port)


@pytest.mark.parametrize("arch", sorted(REF.configs.ARCHS))
def test_llm_decode_task_matches_every_arch(arch):
    assert sorted(REF.configs.ARCHS) == sorted(PORT.configs.ARCHS)
    made = []
    for pkg in SIDES:
        try:
            made.append(own(pkg.workloads.LLMDecodeTask(1, arch=arch, page_size=1 << 20, max_context=512), pkg))
        except Exception as e:  # noqa: BLE001  (an arch with no attention heads)
            made.append(e)
    ref, port = made
    if isinstance(ref, Exception):
        # the SSM config has no heads: both packages refuse it alike
        assert type(port) is type(ref) and str(port) == str(ref)
        return
    same(_program_state(REF, ref, 1 << 20, iters=2), _program_state(PORT, port, 1 << 20, iters=2))
    same((ref.layer_bytes, ref.embed_bytes, ref.kv_token_bytes, ref.seq_len(700)),
         (port.layer_bytes, port.embed_bytes, port.kv_token_bytes, port.seq_len(700)))


@pytest.mark.parametrize("name,scale", [("A", 0.05), ("B", 0.5), ("C", 0.5), ("D", 1.0)])
def test_combos_match(name, scale):
    ref, port = (p.workloads.combo(name, page_size=256 << 10, scale=scale) for p in SIDES)
    assert [type(t).__name__ for t in ref] == [type(t).__name__ for t in port]
    for r, t in zip(ref, port):
        own(t, PORT)
        same(_program_state(REF, r, 256 << 10, iters=1), _program_state(PORT, t, 256 << 10, iters=1))


# --------------------------------------------------------------------------
# DemandPager
# --------------------------------------------------------------------------


def _drive_pager(pkg, kind, seed, page_size, capacity, n_pages, max_touch):
    """A seeded access stream through one package's pager; returns every
    stall and the pool's state after each access."""
    rnd = random.Random(seed)
    pool = pkg.hbm.make_pool(kind, capacity)
    pager = own(pkg.pager.DemandPager(pkg.hardware.RTX5080, pool, page_size), pkg)
    out = []
    for _ in range(10):
        pages = sorted(set(rnd.sample(range(n_pages), rnd.randrange(1, max_touch))))
        if kind == "run":
            stall = pager.access_runs(pkg.pages.pages_to_runs(pages))
        else:
            stall = pager.access(pages)
        out.append((stall, dataclasses.asdict(pager.stats), pool.eviction_order(),
                    pool.resident_count(), pool.evictions, pool.populations))
    return out


@pytest.mark.parametrize("kind", ["run", "paged"])
@pytest.mark.parametrize("page_size", [4096, 64 << 10, 1 << 20])
@pytest.mark.parametrize("seed,capacity,n_pages,max_touch", [
    (0, 40, 160, 60),
    (1, 100, 160, 60),
    (2, 300, 2000, 700),  # above the vectorised path's 256-page threshold
])
def test_demand_pager_matches(kind, page_size, seed, capacity, n_pages, max_touch):
    same(*(_drive_pager(p, kind, seed, page_size, capacity, n_pages, max_touch) for p in SIDES))


# --------------------------------------------------------------------------
# simulate: the static combo of tests/core/test_run_native_pool.py
# --------------------------------------------------------------------------

def _sim_cases():
    # legacy planning and the per-page pool are the slow references: shorter horizons
    cases = []
    for pool, planning, sim_us in (("run", "incremental", 100_000.0), ("run", "legacy", 20_000.0),
                                   ("paged", "incremental", 20_000.0), ("paged", "legacy", 10_000.0)):
        for backend in ("um", "msched", "ideal", "suv"):
            kinds = ("oracle", "template", "allocation") if backend == "msched" and pool == "run" else ("oracle",)
            cases += [(backend, planning, pool, kind, sim_us) for kind in kinds]
    return cases


def _static_combo(pkg, backend, planning, pool, predictor_kind, sim_us):
    progs = pkg.workloads.combo("A", page_size=256 << 10, scale=0.05)
    foot = sum(p.footprint_bytes() for p in progs)
    res = pkg.sim.simulate(
        progs, pkg.hardware.RTX5080, backend, capacity_bytes=int(foot / 1.5),
        sim_us=sim_us, policy=pkg.scheduler.RoundRobinPolicy(10_000.0),
        predictor_kind=predictor_kind, planning=planning, pool=pool,
    )
    return own(res, pkg)


@pytest.mark.parametrize("backend,planning,pool,predictor_kind,sim_us", _sim_cases())
def test_simulate_static_combo_matches(backend, planning, pool, predictor_kind, sim_us):
    ref, port = (_static_combo(p, backend, planning, pool, predictor_kind, sim_us) for p in SIDES)
    same(dataclasses.asdict(ref), dataclasses.asdict(port))
    assert port.total_completions() > 0


def test_pool_kind_and_percentile_match():
    for pkg in SIDES:
        with pytest.raises(ValueError, match="pool kind"):
            pkg.sim.simulate([], pkg.hardware.RTX5080, "um", sim_us=1.0, pool="nope")
    xs = sorted(random.Random(3).random() for _ in range(101))
    for pct in (0.0, 1.0, 50.0, 99.0, 99.9, 100.0):
        same(REF.sim.percentile(xs, pct), PORT.sim.percentile(xs, pct))
    same(REF.sim.percentile([], 50.0), PORT.sim.percentile([], 50.0))


# --------------------------------------------------------------------------
# Invariants: the corrupted pools and cores of tests/core/test_invariants.py
# --------------------------------------------------------------------------

PAGE = 1 << 20


def _pool(pkg, kind, cap=64):
    pool = pkg.hbm.make_pool(kind, cap)
    pool.register_task(1, (0, 32))
    pool.populate_runs([(0, 8), (12, 20)])
    return pool


def _serving_core(pkg, req_id=0, output_tokens=40, cap=4 << 30):
    req = pkg.serving.Request(req_id, "qwen3-1.7b", 1_000.0, prompt_tokens=64, output_tokens=output_tokens)
    events = [pkg.sim.TaskArrival(req.arrival_us, pkg.serving.ServedRequestTask(req_id, req, page_size=PAGE))]
    core = pkg.sim.SimCore(
        [], pkg.hardware.RTX5080, "msched", capacity_bytes=cap,
        policy=pkg.scheduler.RoundRobinPolicy(350_000.0), task_events=events,
        page_size=PAGE, prepopulate=False, name="gpu0",
        profile_set=[pkg.serving.ServedRequestTask(10_000_000 + req_id, req, page_size=PAGE)],
    )
    core.run(50_000.0, final=False)
    return own(core, pkg)


def _count_drift(pkg):
    pool = _pool(pkg, "run")
    pool._count += 3
    return pkg.invariants.audit_pool(pool)


def _chain_index_divergence(pkg):
    pool = _pool(pkg, "run")
    pool._unlink(pool._h.nxt)
    return pkg.invariants.audit_pool(pool)


def _orphan_pages(pkg):
    out = []
    for kind in ("run", "paged"):
        pool = _pool(pkg, kind)
        pool.populate_runs([(40, 44)])
        out.append(pkg.invariants.audit_pool(pool, name=kind))
    return out


def _over_capacity(pkg):
    pool = _pool(pkg, "paged")
    pool.register_task(2, (0, 1 << 12))
    for p in range(pool.capacity + 4):
        pool._list[p] = None
    return pkg.invariants.audit_pool(pool)


def _failed_core_residue(pkg):
    core = _serving_core(pkg)
    core.fail(60_000.0)
    clean = pkg.invariants.audit_core(core)
    core.pool.register_task(9, (0, 16))
    core.pool.populate_runs([(0, 4)])
    return clean, pkg.invariants.audit_core(core)


def _orphaned_linger_flag(pkg):
    core = _serving_core(pkg)
    core.lingering.add(999)
    return pkg.invariants.audit_core(core)


def _stale_warm_runs(pkg):
    core = _serving_core(pkg)
    core._warm_runs[12345] = [(0, 4)]
    return pkg.invariants.audit_core(core)


def _auditor_raises(pkg):
    core = _serving_core(pkg)
    auditor = pkg.invariants.InvariantAuditor([core])
    clean = auditor.check(50_000.0, "mid")
    core.lingering.add(999)
    with pytest.raises(pkg.invariants.InvariantViolation) as ei:
        auditor.check(51_000.0, "fault")
    assert isinstance(ei.value, AssertionError)
    return clean, str(ei.value), auditor.checks


def _auditor_accumulates(pkg):
    core = _serving_core(pkg)
    core.lingering.add(999)
    auditor = pkg.invariants.InvariantAuditor([core], raise_on_violation=False)
    bad = auditor.check(51_000.0, "tick")
    return bad, list(auditor.violations), auditor.checks


CORRUPTIONS = {
    "healthy_pools": lambda pkg: [pkg.invariants.audit_pool(_pool(pkg, k)) for k in ("run", "paged")],
    "count_drift": _count_drift,
    "chain_index_divergence": _chain_index_divergence,
    "orphan_pages": _orphan_pages,
    "over_capacity": _over_capacity,
    "healthy_core": lambda pkg: pkg.invariants.audit_core(_serving_core(pkg)),
    "failed_core_residue": _failed_core_residue,
    "orphaned_linger_flag": _orphaned_linger_flag,
    "stale_warm_runs": _stale_warm_runs,
    "auditor_raises": _auditor_raises,
    "auditor_accumulates": _auditor_accumulates,
}


@pytest.mark.parametrize("case", sorted(CORRUPTIONS))
def test_invariant_audits_match(case):
    ref, port = (CORRUPTIONS[case](p) for p in SIDES)
    same(ref, port)
    flat = repr(port)
    if case.startswith("healthy"):
        assert flat in ("[[], []]", "[]"), flat
    elif case == "failed_core_residue":
        assert port[0] == [] and port[1], port
    else:
        assert "'" in flat, f"{case}: the audit found nothing: {flat}"


def test_clean_run_audits_clean():
    """A serving core audited every 100 ms of a run: no violation in either
    package, and the same number of checks."""
    got = []
    for pkg in SIDES:
        core = _serving_core(pkg, output_tokens=24, cap=2 << 30)
        auditor = pkg.invariants.InvariantAuditor([core])
        t = core.t
        for _ in range(20):
            t += 100_000.0
            core.run(t, final=False)
            assert auditor.check(t, "tick") == []
        got.append((auditor.checks, auditor.violations, core.t, len(core.records)))
    same(*got)
