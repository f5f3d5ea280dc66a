"""The port's cluster layer against the JAX package's, module by module: the
copied texts, the link graph (fluid sharing, host staging, degrade and
restore), the three placement policies, the transfer planner's schedules,
and the rebalancer's moves, retries and checkpointed working sets.

Both packages run the same Python on the same inputs, so the bar is exact
equality: every result is turned into plain values (``dataclasses.asdict``)
and compared with ``==`` and by ``repr`` (bit-equal floats, ints not floats).
Each side is built from its own package (platform, topology, policies,
programs, cores), so a module missing from the port cannot hide behind the
reference's objects."""
import dataclasses
import importlib
import random
import re
import types
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        cluster=mod("cluster"),
        topology=mod("cluster.topology"),
        placement=mod("cluster.placement"),
        planner=mod("cluster.transfer_plan"),
        migration=mod("cluster.migration"),
        control=mod("control"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        sim=mod("core.simulator"),
        hbm=mod("core.hbm"),
        workloads=mod("core.workloads"),
        serving=mod("serving"),
    )


REF, PORT = _pkg("repro"), _pkg("repro_torch")
SIDES = (REF, PORT)
ARCH = "qwen3-1.7b"
PAGE = 1 << 20
GB = 1 << 30
MB = 1 << 20


def same(ref, port):
    """Exact equality, and equal reprs (bit-equal floats, same types)."""
    assert ref == port
    assert repr(ref) == repr(port)


def own(obj, pkg):
    """``obj`` was built from ``pkg``'s own classes."""
    assert type(obj).__module__.split(".")[0] == pkg.root, (type(obj), pkg.root)
    return obj


def plain(x):
    """Dataclasses as dicts, containers walked, sets and frozensets sorted."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {plain(k) if not isinstance(k, frozenset) else tuple(sorted(k)): plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return sorted(plain(v) for v in x)
    return x


def both(fn):
    """``fn`` run on each package; the two results compared exactly."""
    ref, port = (fn(pkg) for pkg in SIDES)
    same(ref, port)
    return port


def _raises(fn):
    try:
        fn()
    except (ValueError, KeyError) as e:
        return f"{type(e).__name__}: {e}"
    return None


# --------------------------------------------------------------------------
# The copies
# --------------------------------------------------------------------------

SRC = Path(__file__).resolve().parents[1] / "src"
COPIED = ("cluster/__init__.py", "cluster/topology.py", "cluster/placement.py", "cluster/transfer_plan.py",
          "cluster/migration.py", "cluster/prefetch.py", "cluster/faults.py", "cluster/engine.py",
          "control/journal.py", "control/lifecycle.py", "control/plane.py")
NOTE = r"\n\nCopied from the JAX package's ``{}``[^\n]*(\n[^\n]+)*(?=\n\"\"\")"


@pytest.mark.parametrize("path", COPIED)
def test_copied_module_is_the_references(path):
    """Each copied module is the reference's text with ``repro.`` rewritten
    to ``repro_torch.`` and one docstring paragraph added."""
    port = (SRC / "repro_torch" / path).read_text()
    note = re.compile(NOTE.format(re.escape(path)))
    assert len(note.findall(port)) == 1, path
    assert note.sub("", port).replace("repro_torch.", "repro.") == (SRC / "repro" / path).read_text()


def test_control_package_re_exports_the_references():
    """``control/__init__.py``: the reference's code after its docstring,
    the same ``__all__``, and each name from the port's own modules."""
    port = (SRC / "repro_torch" / "control" / "__init__.py").read_text()
    ref = (SRC / "repro" / "control" / "__init__.py").read_text()
    assert port.split('"""', 2)[2].replace("repro_torch.", "repro.") == ref.split('"""', 2)[2]
    same(REF.control.__all__, PORT.control.__all__)
    for name in PORT.control.__all__:
        obj = getattr(PORT.control, name)
        if isinstance(obj, type) or callable(obj):
            assert obj.__module__.startswith("repro_torch."), name
    public = lambda m: sorted(n for n in dir(m) if not n.startswith("_"))  # noqa: E731
    same(public(REF.cluster), public(PORT.cluster))


# --------------------------------------------------------------------------
# Topology: the link graph
# --------------------------------------------------------------------------


def _topology_story(P):
    """tests/cluster/test_topology.py's and the link-fault tests' calls, in
    one sequence; every answer kept."""
    T, hw = P.topology, P.hardware
    HOST, nb, out = T.HOST, GB, []
    topo = own(T.homogeneous(3, hw.RTX5080), P)
    out += [plain(topo.links()), plain(topo.path("gpu0", "gpu2")), topo.link("gpu0", "gpu1"), topo.has_nvlink()]
    a = topo.plan_transfer("gpu0", "gpu1", nb, now=0.0)
    b = topo.plan_transfer("gpu0", "gpu2", nb, now=0.0)
    out += [plain(a), plain(b), topo.active_on("gpu0", HOST, 1.0), topo.inflight_bytes("gpu0", HOST, 1.0),
            topo.host_staged_bytes(a.start_us), topo.host_staged_bytes(b.arrival_us + 1.0),
            topo.solo_transfer_us("gpu0", "gpu2", nb)]
    out.append(plain(topo.plan_transfer("gpu0", "gpu1", nb, now=b.arrival_us + 1.0)))
    # cancel accounting at completion boundaries
    c = T.homogeneous(2, hw.A100_40G)
    p1 = c.plan_transfer("gpu0", "gpu1", nb, 0.0)
    out += [c.cancel_staging(p1, 5_000.0), plain(c.plan_transfer("gpu0", "gpu1", nb, 5_000.0)),
            c.inflight_bytes("gpu0", HOST, 5_000.0), c.inflight_bytes("gpu0", HOST, 4_999.0),
            c.host_staged_bytes(5_000.0)]
    legacy = c.plan_transfer("gpu1", HOST, nb, 1e7)
    out += [c.cancel_staging(legacy), plain(legacy), c.inflight_bytes("gpu1", HOST, 1e7 + 1.0)]
    # NVLink: direct path, host budget skipped, degrade and restore
    nv = T.homogeneous(2, hw.RTX5080, capacity_bytes=4 << 30, host_dram_bytes=1 << 20,
                       nvlink_gbps=hw.NVLINK_A100_GBPS)
    out += [plain(nv.path("gpu0", "gpu1")), plain(nv.plan_transfer("gpu0", "gpu1", nb, now=0.0)), nv.deferred]
    nv.reset_transfers()
    nv.degrade("gpu0", "gpu1", 0.25)
    out += [plain(nv.plan_transfer("gpu0", "gpu1", nb, 0.0)), nv.link_factor(frozenset(("gpu0", "gpu1")))]
    nv.degrade("gpu0", "gpu1", 0.0)
    out += [nv.nvlink_peer("gpu0", "gpu1"), plain(nv.path("gpu0", "gpu1"))]
    nv.restore("gpu0", "gpu1")
    nv.reset_transfers()
    out += [plain(nv.nvlink_peer("gpu0", "gpu1")), plain(nv.plan_transfer("gpu0", "gpu1", nb, 0.0))]
    # the host DRAM budget defers, then admits once the staging drains
    hb = T.homogeneous(2, hw.RTX5080, host_dram_bytes=1 << 30)
    ok = hb.plan_transfer("gpu0", "gpu1", 800 << 20, now=0.0)
    out += [plain(ok), hb.plan_transfer("gpu1", "gpu0", 800 << 20, now=0.0), hb.deferred,
            plain(hb.plan_transfer("gpu1", "gpu0", 800 << 20, now=ok.arrival_us + 1.0)),
            plain(hb.plan_restore("gpu0", 64 << 20, ok.arrival_us + 2.0))]
    # mixed fleets and the rejected constructions
    mx = T.mixed([(hw.A100_40G, 10 << 30), (hw.A100_80G, None)])
    out += [plain(mx.gpus), [g.hbm_bytes for g in mx.gpus], plain(mx.links())]
    out += [_raises(fn) for fn in (
        lambda: T.ClusterTopology([T.GPUNode("g", hw.RTX5080), T.GPUNode("g", hw.RTX5080)]),
        lambda: T.ClusterTopology([T.GPUNode("g", hw.RTX5080)], nvlinks=[("g", "nope", 10.0)]),
        lambda: nv.plan_transfer("gpu0", "gpu0", MB, now=0.0),
        lambda: nv.degrade("gpu0", HOST, 0.0),
    )]
    # the page directory
    d = T.PageDirectory()
    d.record(7, "gpu0", "gpu1", [(0, 10), (20, 30)], arrival_us=5.0)
    d.record(8, "gpu1", "gpu0", [(3, 4)], arrival_us=6.0)
    out += [d.get(7).pages(), plain(list(d.on_gpu("gpu0"))), plain(d.entries())]
    d.retarget(7, "gpu2")
    d.consume(7, [(0, 10)])
    out += [plain(d.get(7)), plain(d.forget(8)), len(d)]
    d.consume(7, [(20, 30)])
    out += [d.get(7), len(d)]
    return out


def test_topology_matches():
    out = both(_topology_story)
    assert len(out) > 40


# --------------------------------------------------------------------------
# Placement
# --------------------------------------------------------------------------


def _fake_core(P, name, capacity_pages, progs=(), platform=None, waiting_pages=0):
    """tests/cluster/test_placement.py's FakeCore: a load view only."""
    state = P.sim.SimState(
        now=0.0, platform=platform or P.hardware.RTX5080, pool=P.hbm.HBMPool(capacity_pages),
        policy=P.scheduler.RoundRobinPolicy(5_000.0), page_size=4096,
        active={p.task_id: p for p in progs}, helpers={}, waiting=0, waiting_pages=waiting_pages,
    )
    return types.SimpleNamespace(name=name, state_view=lambda: state)


def _prog(P, task_id, pages):
    class Prog(P.workloads.TaskProgram):
        def iteration(self, it):
            return []

    prog = Prog(task_id, page_size=4096)
    prog.space.malloc(pages * 4096, "buf")
    return prog


def _placement_story(P):
    pl, hw = P.placement, P.hardware
    out = []
    rr = own(pl.make_placement("roundrobin"), P)
    cores = [_fake_core(P, f"g{i}", 100) for i in range(3)]
    out.append([rr.place(_prog(P, 99, 10), 0.0, cores) for _ in range(5)])
    # the reference test's views
    big = _fake_core(P, "g0", 1000, [_prog(P, 0, 800)])
    small = _fake_core(P, "g1", 1000, [_prog(P, 1, 10), _prog(P, 2, 10)])
    ms = own(pl.MSchedPlacement(headroom=0.9), P)
    out += [own(pl.make_placement("leastloaded"), P).place(_prog(P, 99, 10), 0.0, [big, small]),
            ms.place(_prog(P, 99, 200), 0.0, [big, small])]
    a = _fake_core(P, "g0", 1000, [_prog(P, 0, 100)])
    b = _fake_core(P, "g1", 1000, [_prog(P, 1, 600)])
    out.append(ms.place(_prog(P, 99, 200), 0.0, [a, b]))
    out.append(ms.place(_prog(P, 99, 200), 0.0, [_fake_core(P, "g0", 1000), _fake_core(P, "g1", 1000, waiting_pages=850)]))
    spill = [_fake_core(P, "g0", 1000, [_prog(P, 0, 900)], platform=hw.A100_40G),
             _fake_core(P, "g1", 2000, [_prog(P, 1, 1800)])]
    out.append(ms.place(_prog(P, 99, 500), 0.0, spill))
    out += [sorted(pl.PLACEMENTS), _raises(lambda: pl.make_placement("nope"))]
    # a seeded sweep of load views: every policy's pick on each
    rnd = random.Random(5)
    policies = [pl.make_placement(n) for n in ("roundrobin", "leastloaded", "msched")] + [
        pl.MSchedPlacement(headroom=0.5)]
    for _ in range(60):
        views = []
        for g in range(rnd.randint(1, 5)):
            progs = [_prog(P, 10 * g + i, rnd.randint(1, 400)) for i in range(rnd.randint(0, 4))]
            views.append(_fake_core(P, f"g{g}", rnd.choice([500, 1000, 2000]), progs,
                                    platform=rnd.choice([hw.RTX5080, hw.A100_40G, hw.A100_80G]),
                                    waiting_pages=rnd.choice([0, 0, 300, 900])))
        cand = _prog(P, 999, rnd.randint(1, 700))
        out.append([pol.place(cand, 0.0, views) for pol in policies])
    return out


def test_placement_matches():
    out = both(_placement_story)
    assert any(len(set(picks)) > 1 for picks in out[-60:])  # the policies disagree somewhere


# --------------------------------------------------------------------------
# Transfer planner
# --------------------------------------------------------------------------


def _planner_state(planner):
    flights = [(f.fid, plain(f.req), f.leg_names, f.caps, f.staged, f.detour, f.start_us, f.leg_ends, f.landed_us,
                plain(f.plan), f.solo_us) for f in planner.log]
    history = sorted((tuple(sorted(k)), plain(v)) for k, v in planner.history.items())
    return [flights, history, planner.landed, planner.detours, planner.urgency_deferred]


def _storm(P, seed):
    """tests/cluster/test_transfer_plan.py's random storm: 2-5 GPUs, random
    NVLink edges, 1-3 windows of restores, snapshots and moves."""
    T, TP, hw = P.topology, P.planner, P.hardware
    rnd = random.Random(seed)
    n = rnd.randint(2, 5)
    names = [f"gpu{i}" for i in range(n)]
    nvlinks = [(names[i], names[j], hw.NVLINK_A100_GBPS) for i in range(n) for j in range(i + 1, n)
               if rnd.random() < 0.45]
    topo = T.ClusterTopology([T.GPUNode(nm, hw.A100_40G) for nm in names], host_dram_bytes=512 << 30,
                             nvlinks=nvlinks)
    planner = own(TP.TransferPlanner(topo), P)
    topo.planner = planner
    t, plans = 0.0, []
    for _ in range(rnd.randint(1, 3)):
        reqs = []
        for _ in range(rnd.randint(2, 8)):
            shape = rnd.random()
            if shape < 0.15:
                src, dst, kind = T.HOST, rnd.choice(names), "restore"
            elif shape < 0.3:
                src, dst, kind = rnd.choice(names), T.HOST, "snapshot"
            else:
                src, dst = rnd.sample(names, 2)
                kind = rnd.choice(["checkpoint", "p2p", "peer_fetch", "bulk"])
            urgency = rnd.choice([None, TP.URGENCY_RT, TP.URGENCY_RESTORE])
            reqs.append(TP.TransferRequest(src, dst, rnd.randint(1 * MB, 2 * GB), kind, urgency,
                                           task_id=rnd.randrange(1000)))
        plans.append(plain(planner.submit(reqs, t)))
        t += rnd.uniform(1_000.0, 300_000.0)
    planner._advance(t + 1e9)
    return [plans, _planner_state(planner), topo.replans, topo.host_staged_bytes(1e15)]


@pytest.mark.parametrize("seed", range(12))
def test_planner_storm_matches(seed):
    both(lambda P: _storm(P, 7919 * seed + 13))


def _planner_scenarios(P):
    """The named planner regressions: two sharers, a rebook, a cancel, the
    NVLink detour, urgency deferral and window order."""
    T, TP, hw = P.topology, P.planner, P.hardware
    HOST, R = T.HOST, TP.TransferRequest
    out = []

    def fresh(topo=None, **kw):
        topo = topo or T.homogeneous(2, hw.A100_40G)
        planner = TP.TransferPlanner(topo, **kw)
        topo.planner = planner
        return topo, planner

    topo, planner = fresh()
    out.append(plain(planner.submit([R("gpu0", HOST, 2 * GB, "snapshot"), R("gpu0", HOST, GB // 2, "snapshot")], 0.0)))
    topo, planner = fresh()
    retimed = []
    topo.replan_hook = lambda plan, old: retimed.append((plain(plan), old))
    p1 = planner.submit_one(R("gpu0", HOST, GB, "snapshot", task_id=1), 0.0)
    planner.submit_one(R("gpu0", HOST, GB, "snapshot", task_id=2, urgency=TP.URGENCY_RT), 0.0)
    out += [plain(p1), topo.replans, retimed, topo.active_on("gpu0", HOST, p1.arrival_us - 1.0)]
    topo, planner = fresh()
    plans = planner.submit([R("gpu0", "gpu1", GB, "checkpoint", TP.URGENCY_RT, 1),
                            R("gpu0", "gpu1", GB, "checkpoint", TP.URGENCY_RT, 2)], 0.0)
    topo.cancel_staging(plans[1], 1_000.0)
    out += [plain(plans), _planner_state(planner)]
    topo, planner = fresh(T.ClusterTopology(
        [T.GPUNode(nm, hw.A100_40G) for nm in ("gpu0", "gpu1", "gpu2")],
        nvlinks=[("gpu0", "gpu2", hw.NVLINK_A100_GBPS), ("gpu2", "gpu1", hw.NVLINK_A100_GBPS)]),
        saturation_depth=2)
    planner.submit([R("gpu0", HOST, GB, "snapshot", TP.URGENCY_RT), R(HOST, "gpu0", GB, "restore", TP.URGENCY_RT),
                    R("gpu1", HOST, GB, "snapshot", TP.URGENCY_RT), R(HOST, "gpu1", GB, "restore", TP.URGENCY_RT)], 0.0)
    out += [plain(planner.submit_one(R("gpu0", "gpu1", GB, "checkpoint", TP.URGENCY_RT), 0.0)), planner.detours,
            topo.host_staged_bytes(0.0), plain(planner.link_queue_depths(0.0))]
    topo, planner = fresh(defer_stretch=3.0)
    planner.submit([R("gpu0", HOST, GB, "snapshot", TP.URGENCY_RT) for _ in range(6)], 0.0)
    out += [planner.submit_one(R("gpu0", HOST, GB, "checkpoint"), 0.0), planner.urgency_deferred,
            plain(planner.submit_one(R("gpu0", HOST, GB, "checkpoint", TP.URGENCY_RESTORE), 0.0))]
    topo, planner = fresh()
    out.append(plain(planner.submit([R("gpu0", "gpu1", GB, "checkpoint"), R(HOST, "gpu1", GB, "restore", TP.URGENCY_RT)],
                                    0.0)))
    # linger retention: zero headroom, a downed edge, a free retention
    nv = T.homogeneous(2, hw.A100_40G, nvlink_gbps=hw.NVLINK_A100_GBPS)
    planner = TP.TransferPlanner(nv)
    entry = T.LingerEntry(1, "gpu0", "gpu1", [(0, 8)], 0.0)
    full = types.SimpleNamespace(pool=types.SimpleNamespace(capacity=64, used=70), page_size=PAGE)
    roomy = types.SimpleNamespace(
        pool=types.SimpleNamespace(capacity=1024, used=100), page_size=PAGE,
        state_view=lambda: types.SimpleNamespace(policy=P.scheduler.RoundRobinPolicy(5_000.0), waiting_pages=0,
                                                 active={}, helpers={}, page_size=PAGE))
    out += [planner.linger_retention_ok(entry, full, 10.0), planner.linger_retention_ok(entry, roomy, 0.0)]
    nv.degrade("gpu0", "gpu1", 0.0)
    out += [planner.linger_retention_ok(entry, roomy, 0.0), planner.pressure_scavenged, sorted(planner._scavenged)]
    return out


def test_planner_scenarios_match():
    both(_planner_scenarios)


# --------------------------------------------------------------------------
# Rebalancer: moves, retries, checkpointed working sets
# --------------------------------------------------------------------------


def _serving_core(P, name, req_id=0, output_tokens=400, cap=4 << 30):
    """One msched core with a single long-decoding request."""
    S = P.serving
    req = S.Request(req_id, ARCH, 1_000.0, prompt_tokens=64, output_tokens=output_tokens)
    events = [P.sim.TaskArrival(req.arrival_us, S.ServedRequestTask(req_id, req, page_size=PAGE))]
    return own(P.sim.SimCore(
        [], P.hardware.RTX5080, "msched", capacity_bytes=cap, policy=P.scheduler.RoundRobinPolicy(350_000.0),
        task_events=events, page_size=PAGE, prepopulate=False, name=name,
        profile_set=[S.ServedRequestTask(10_000_000 + req_id, req, page_size=PAGE)]), P)


def _reject_all(P):
    return type("RejectAll", (P.sim.AdmissionController,), {"decide": lambda self, prog, t, state: "reject"})()


def _cores_state(cores):
    return [(c.name, c.t, c.pool.used, [plain(r) for r in c.records]) for c in cores]


def _rebalancer_story(P, kind, stage_dir=None):
    """tests/cluster/test_p2p_prefetch.py's and test_faults.py's retry
    scenarios: a checkpointed move out of gpu0, then the target (or both
    GPUs) rejecting the continuation."""
    topo = P.topology.homogeneous(2, P.hardware.RTX5080, capacity_bytes=4 << 30)
    src = _serving_core(P, "gpu0", req_id=0, output_tokens=300)
    dst = _serving_core(P, "gpu1", req_id=1, output_tokens=2)
    kw = {"returns": {}, "budget": {"max_retries": 2}, "exhausted": {"max_retries": 2},
          "backoff": {"max_retries": 3, "retry_backoff_us": 50_000.0, "retry_backoff_cap_us": 80_000.0},
          "staged": {}}[kind]
    rb = own(P.migration.Rebalancer(topo, stage_dir=stage_dir, **kw), P)
    rb.attach([src, dst])
    if kind == "returns":
        dst.admission = _reject_all(P)
    src.run(200_000.0, final=False)
    mv = own(rb._move_one(src, dst, 200_000.0), P)
    out = [plain(mv), topo.host_staged_bytes(200_001.0)]
    if kind == "returns":
        dst.run(10_000_000.0, final=True)
        src.run(20_000_000.0, final=True)
    elif kind == "staged":
        dst.run(10_000_000.0, final=True)
        src.run(10_000_000.0, final=True)
    else:
        src.admission, dst.admission = _reject_all(P), _reject_all(P)
        for _ in range(8):
            dst.run(dst.t + 1_000_000.0, final=False)
            src.run(src.t + 1_000_000.0, final=False)
    out += [plain(rb.events), rb.exhausted, topo.host_staged_bytes(200_001.0), _cores_state([src, dst])]
    return out


@pytest.mark.parametrize("kind", ["returns", "budget", "exhausted", "backoff"])
def test_rebalancer_retries_match(kind):
    out = both(lambda P: _rebalancer_story(P, kind))
    assert any(e["kind"] in ("retry", "exhausted") for e in out[2])


def test_rebalancer_stage_dir_matches(tmp_path):
    """A checkpointed move through a stage dir: the working-set manifest is
    saved and restored into a numpy host target by each package's own
    ``checkpoint`` (the port's keeps the int64 leaves, as the reference's
    does)."""
    out = [_rebalancer_story(pkg, "staged", stage_dir=str(tmp_path / pkg.root)) for pkg in SIDES]
    same(*out)
    assert out[1][0]["kind"] == "checkpoint"
    for pkg in SIDES:
        assert any(p.name.startswith("step_") for p in (tmp_path / pkg.root).iterdir())


def test_checkpoint_roundtrip_matches(tmp_path):
    """``pack_working_set`` / ``checkpoint_roundtrip`` on the same ejected
    task; each package also restores the other's staged manifest."""
    got = []
    for pkg in SIDES:
        core = _serving_core(pkg, "gpu0", output_tokens=300)
        core.run(200_000.0, final=False)
        ej = core.eject(0)
        packed = pkg.migration.pack_working_set(ej, PAGE)
        runs = pkg.migration.checkpoint_roundtrip(str(tmp_path / pkg.root), 3, ej, PAGE)
        got.append(([(k, v.dtype.str, v.tolist()) for k, v in sorted(packed.items())], runs, ej.resident_runs))
    same(*got)
    assert got[1][1] == got[1][2] and got[1][1]
    from repro.checkpointing import checkpoint as ref_ckpt
    from repro_torch.checkpointing import checkpoint as port_ckpt

    n = len(got[0][1])
    target = {k: np.zeros(s, np.int64) for k, s in (("task_id", ()), ("completed", ()), ("page_size", ()),
                                                     ("resident_starts", (n,)), ("resident_stops", (n,)))}
    crossed = [ref_ckpt.restore(str(tmp_path / "repro_torch"), 3, target),
               port_ckpt.restore(str(tmp_path / "repro"), 3, target)]
    for tree in crossed:
        assert {k: (v.dtype, v.tolist()) for k, v in tree.items()} == {
            k: (np.dtype(np.int64), v.tolist()) for k, v in crossed[0].items()}
