"""The port's fault injection and recovery against the JAX package's, on the
scenarios of ``tests/cluster/test_faults.py``: GPU fail and recover, the
whole fleet down (held, then flushed, or lost), checkpoint, linger and cold
recovery, denied restores backing off, task crashes, graceful degradation
(best-effort before real-time, the strict thresholds), retry exhaustion
releasing linger copies, and seeded chaos schedules under the inline
auditor.

Every ``FaultEvent``, ``RecoveryEvent`` and ``MigrationEvent`` must be equal:
whole runs are compared as the text of ``ClusterReport.to_json()``, runs of
the fault runtime alone by its events, shed decisions and every core's
request records (``dataclasses.asdict``, compared with ``==`` and by
``repr``). Each side is built from its own package."""
import dataclasses
import importlib
import json
import math
import types

import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        cluster=mod("cluster"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        sim=mod("core.simulator"),
        invariants=mod("core.invariants"),
        serving=mod("serving"),
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


def plain(x):
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(plain(v) for v in x)
    return x


def both(fn):
    ref, port = (fn(P) for P in SIDES)
    same(ref, port)
    return port


def report(P, rep):
    own(rep, P)
    return json.dumps(rep.to_json(), sort_keys=True)


def _trace(P, rate=6.0, duration=1.5, seed=3, output_mean=24):
    return P.serving.poisson_trace(rate, duration, seed=seed, tenants=(ARCH,), prompt_mean=64,
                                   output_mean=output_mean, max_output=2 * output_mean)


def _pin0(P):
    return type("Pin0", (P.cluster.PlacementPolicy,), {"name": "pin0", "place": lambda self, prog, t, cores: 0})()


def _topo(P, n=2, cap=4 << 30, nvlink=False, **kw):
    nv = P.hardware.NVLINK_A100_GBPS if nvlink else None
    return P.cluster.homogeneous(n, P.hardware.RTX5080, capacity_bytes=cap, nvlink_gbps=nv, **kw)


def _faults(P, *events):
    return P.cluster.FaultInjector([P.cluster.FaultEvent(*a, **kw) for a, kw in events])


def _run(P, trace, topo, placement="leastloaded", admission=True, **kw):
    if admission:
        kw["admission_factory"] = lambda i: P.serving.MSchedAdmission(headroom=0.9)
    return P.cluster.simulate_cluster(
        trace, topo, backend="msched", placement=placement,
        policy_factory=lambda i: P.scheduler.RoundRobinPolicy(350_000.0), page_size=PAGE, **kw)


def _serving_core(P, name, req_id=0, output_tokens=400, cap=4 << 30, slo_class="be"):
    S = P.serving
    req = S.Request(req_id, ARCH, 1_000.0, prompt_tokens=64, output_tokens=output_tokens, slo_class=slo_class)
    events = [P.sim.TaskArrival(req.arrival_us, S.ServedRequestTask(req_id, req, page_size=PAGE))]
    return own(P.sim.SimCore(
        [], P.hardware.RTX5080, "msched", capacity_bytes=cap, policy=P.scheduler.RoundRobinPolicy(350_000.0),
        task_events=events, page_size=PAGE, prepopulate=False, name=name,
        profile_set=[S.ServedRequestTask(10_000_000 + req_id, req, page_size=PAGE)]), P)


def _runtime(P, events, topo, cores, **kw):
    return own(P.cluster.FaultRuntime(P.cluster.FaultInjector(events), topo, cores, _pin0(P), **kw), P)


def _runtime_state(frt, cores):
    return dict(applied=plain(frt.applied), recoveries=plain(frt.recoveries), shed=plain(frt.shed_events),
                crashes=frt.crashes, retryq=len(frt._retryq),
                cores=[(c.name, c.t, c.pool.used, [plain(r) for r in c.records]) for c in cores])


# --------------------------------------------------------------------------
# Events and schedules
# --------------------------------------------------------------------------


def test_fault_events_and_random_schedules_match():
    def story(P):
        C, out = P.cluster, []
        for args, kw in (((0.0, "meteor_strike"), {}), ((0.0, "gpu_fail"), {}), ((0.0, "link_degrade"), {}),
                         ((0.0, "link_degrade"), {"link": ("a", "b"), "factor": 1.5})):
            with pytest.raises(ValueError) as e:
                C.FaultEvent(*args, **kw)
            out.append(str(e.value))
        out.append(plain(own(C.FaultEvent(0.0, "link_degrade", link=("a", "b"), factor=0.0), P)))
        topo = _topo(P, 3, nvlink=True)
        for seed in range(8):
            inj = C.FaultInjector.random(topo, 3_000_000.0, seed=seed, gpu_mtbf_us=500_000.0,
                                         link_mtbf_us=700_000.0, crash_mtbf_us=900_000.0)
            out.append(plain(inj.events))
        out.append([C.FaultInjector.random(topo, 3_000_000.0, seed=7).empty, C.FaultInjector.none().empty])
        return out

    out = both(story)
    assert sum(len(evs) for evs in out[5:13]) > 20


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["um", "msched"])
def test_empty_injector_run_matches(backend):
    def run(P):
        return report(P, P.cluster.simulate_cluster(
            _trace(P, rate=3.0, duration=0.8), _topo(P, cap=3 << 30), backend=backend, placement="roundrobin",
            policy_factory=lambda i: P.scheduler.RoundRobinPolicy(2_000.0 if backend == "um" else 350_000.0),
            page_size=PAGE, faults=P.cluster.FaultInjector.none()))

    both(run)


def test_gpu_failure_and_recovery_match():
    def run(P):
        inj = _faults(P, ((700_000.0, "gpu_fail"), {"gpu": "gpu0"}), ((1_500_000.0, "gpu_recover"), {"gpu": "gpu0"}))
        return report(P, _run(P, _trace(P, rate=2.0, duration=1.5, output_mean=200), _topo(P, nvlink=True),
                              placement=_pin0(P), faults=inj, audit=True, drain_factor=20.0))

    doc = json.loads(both(run))
    assert doc["faults_applied"] == 2 and doc["recoveries"]


@pytest.mark.parametrize("recovers", [True, False], ids=["held-then-flushed", "never-recovers"])
def test_whole_fleet_down_matches(recovers):
    def run(P):
        events = [((100_000.0, "gpu_fail"), {"gpu": "gpu0"}), ((100_000.0, "gpu_fail"), {"gpu": "gpu1"})]
        if recovers:
            events.append(((700_000.0, "gpu_recover"), {"gpu": "gpu1"}))
        tr = _trace(P, rate=6.0, duration=0.6, output_mean=64 if recovers else 16)
        return report(P, _run(P, tr, _topo(P), admission=False, faults=_faults(P, *events), audit=True,
                              **({"drain_factor": 30.0} if recovers else {})))

    doc = json.loads(both(run))
    assert (doc["lost_requests"] > 0) != recovers


def test_checkpoint_recovery_matches():
    def run(P):
        tr = P.serving.Trace([P.serving.Request(0, ARCH, 50_000.0, prompt_tokens=64, output_tokens=600)])
        return report(P, _run(P, tr, _topo(P, nvlink=True), placement=_pin0(P), admission=False,
                              faults=_faults(P, ((600_000.0, "gpu_fail"), {"gpu": "gpu0"})), recovery="checkpoint",
                              checkpoint_period_us=100_000.0, audit=True, drain_factor=80.0))

    doc = json.loads(both(run))
    assert doc["checkpoints"] > 0 and [r for r in doc["recoveries"] if r["kind"] == "checkpoint"]


def test_task_crash_matches():
    def run(P):
        tr = P.serving.Trace([P.serving.Request(0, ARCH, 1_000.0, prompt_tokens=64, output_tokens=400)])
        return report(P, _run(P, tr, _topo(P), admission=False, faults=_faults(P, ((300_000.0, "task_crash"),
                                                                                   {"task_id": 0})),
                              audit=True, sim_us=8_000_000.0))

    assert len(json.loads(both(run))["recoveries"]) == 1


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_chaos_schedule_matches(seed):
    def run(P):
        topo = _topo(P, cap=3 << 30, nvlink=True)
        inj = P.cluster.FaultInjector.random(topo, 1_500_000.0, seed=seed, gpu_mtbf_us=700_000.0,
                                             gpu_mttr_us=300_000.0, link_mtbf_us=900_000.0,
                                             crash_mtbf_us=1_200_000.0)
        return plain(inj.events), report(P, _run(P, _trace(P, rate=5.0, duration=0.8, seed=seed, output_mean=12),
                                                 topo, faults=inj, audit=True, checkpoint_period_us=200_000.0,
                                                 drain_factor=25.0))

    events, _ = both(run)
    assert events


# --------------------------------------------------------------------------
# The fault runtime alone
# --------------------------------------------------------------------------


def test_linger_recovery_matches():
    """A lazily migrated task dies on its target while its working set
    lingers on the source: recovery harvests the copy on the holder."""
    def story(P):
        C = P.cluster
        topo = _topo(P, nvlink=True)
        g0, g1 = _serving_core(P, "gpu0", 0, 300), _serving_core(P, "gpu1", 1, 2)
        fabric = own(C.PeerPrefetchFabric(topo, [g0, g1]), P)
        fabric.wire()
        rb = C.Rebalancer(topo, prefetch=fabric)
        rb.attach([g0, g1])
        g0.run(200_000.0, final=False)
        mv = rb._move_one(g0, g1, 200_000.0)
        topo.degrade("gpu0", "gpu1", 0.0)
        g1.run(mv.arrival_us + 50_000.0, final=False)
        frt = _runtime(P, [C.FaultEvent(g1.t, "gpu_fail", gpu="gpu1")], topo, [g0, g1], fabric=fabric,
                       recovery="linger")
        frt.apply_due(g1.t)
        P.invariants.InvariantAuditor([g0, g1], topology=topo, fabric=fabric).check(g1.t, "post-fail")
        g0.run(60_000_000.0, final=True)
        return plain(mv), plain(rb.events), plain(fabric.fetches), _runtime_state(frt, [g0, g1])

    state = both(story)[3]
    assert [r for r in state["recoveries"] if r["kind"] == "linger"]


def test_cold_restart_matches():
    def story(P):
        topo = _topo(P)
        g0, g1 = _serving_core(P, "gpu0", 0, 200), _serving_core(P, "gpu1", 1, 2)
        g0.run(300_000.0, final=False)
        frt = _runtime(P, [P.cluster.FaultEvent(g0.t, "gpu_fail", gpu="gpu0")], topo, [g0, g1], recovery="cold")
        frt.apply_due(g0.t)
        g1.run(60_000_000.0, final=True)
        return _runtime_state(frt, [g0, g1])

    assert both(story)["recoveries"][0]["kind"] == "cold"


def test_denied_restore_backs_off_matches():
    def story(P):
        C = P.cluster
        topo = _topo(P, host_dram_bytes=PAGE // 2)
        g0, g1 = _serving_core(P, "gpu0", 0, 300), _serving_core(P, "gpu1", 1, 2)
        vault = own(C.CheckpointVault(topo, PAGE), P)
        g0.run(250_000.0, final=False)
        vault.snapshot([g0, g1], g0.t)
        t = vault._by_task[0][-1].ready_us + 1_000.0
        frt = _runtime(P, [C.FaultEvent(t, "gpu_fail", gpu="gpu0")], topo, [g0, g1], vault=vault,
                       recovery="checkpoint", backoff_us=10_000.0, backoff_cap_us=40_000.0, max_recovery_retries=3)
        while frt.next_time() < float("inf"):
            t = max(t, frt.next_time())
            frt.apply_due(t)
        # a checkpoint pins its program: kept as the program's task id and name
        snaps = {tid: [dict(plain(c), program=(c.program.task_id, c.program.name)) for c in cks]
                 for tid, cks in vault._by_task.items()}
        return vault.taken, vault.bytes, snaps, _runtime_state(frt, [g0, g1])

    state = both(story)[3]
    assert [r["kind"] for r in state["recoveries"]] == ["requeue"] * 3 + ["cold"]


def _queue_all(P, gated=True):
    if gated:
        decide = lambda self, prog, t, state: "queue" if state.active else "admit"  # noqa: E731
    else:
        decide = lambda self, prog, t, state: "queue"  # noqa: E731
    return type("QueueAll", (P.sim.AdmissionController,), {"decide": decide})()


def _queued_core(P, classes, cap=1 << 30):
    g0 = _serving_core(P, "gpu0", 0, 200, cap=cap)
    for i, klass in enumerate(classes):
        req = P.serving.Request(100 + i, ARCH, 10_000.0 + i, prompt_tokens=512, output_tokens=64, slo_class=klass)
        g0.inject(P.sim.TaskArrival(req.arrival_us, P.serving.ServedRequestTask(100 + i, req, page_size=PAGE),
                                    meta={"slo_class": klass}))
    g0.admission = _queue_all(P)
    g0.run(400_000.0, final=False)
    return g0


def test_shedding_best_effort_first_matches():
    """Half the fleet dies under a queued mixed-class load."""
    def story(P):
        topo = _topo(P, cap=1 << 30)
        g0 = _queued_core(P, ["be", "rt", "be", "rt", "be", "be"])
        g1 = _serving_core(P, "gpu1", 1, 200)
        frt = _runtime(P, [P.cluster.FaultEvent(g0.t, "gpu_fail", gpu="gpu1")], topo, [g0, g1], shed_threshold=0.5)
        frt.apply_due(g0.t)
        return _runtime_state(frt, [g0, g1]), sorted(ev.program.task_id for ev, _r, _p in g0.waiting)

    state, waiting = both(story)
    assert state["shed"] and {101, 103} <= set(waiting)


@pytest.mark.parametrize("classes,rt", [(["be"] * 4, False), (["rt"] * 3, True), (["be", "rt", "be", "rt", "be"], None)],
                         ids=["be", "rt", "mixed"])
def test_shed_thresholds_match(classes, rt):
    """At the measured pressure nothing is shed; one ulp below, work is
    (with the RT rung too where ``rt``); the mixed queue at 0.1 sheds every
    best-effort candidate before the first real-time one."""
    def story(P):
        topo = _topo(P, 1, cap=1 << 30)
        g0 = _queued_core(P, classes)
        pressure = _runtime(P, [], topo, [g0], shed_threshold=None).fleet_pressure()
        out = [pressure]
        if rt is None:
            cuts = [0.1]
        else:
            cuts = [pressure, math.nextafter(pressure, 0.0)]
        for cut in cuts:
            frt = _runtime(P, [], topo, [g0], shed_threshold=cut, shed_rt_threshold=cut if rt is not False else None)
            frt._shed_pressure(g0.t)
            out.append(_runtime_state(frt, [g0]))
        return out

    out = both(story)
    assert out[-1]["shed"]
    if rt is not None:
        assert not out[1]["shed"]


def test_rt_threshold_below_be_threshold_raises_alike():
    def story(P):
        with pytest.raises(ValueError) as e:
            _runtime(P, [], _topo(P, 1, cap=1 << 30), [_serving_core(P, "gpu0")], shed_threshold=0.5,
                     shed_rt_threshold=0.4)
        return str(e.value)

    assert "shed_rt_threshold" in both(story)


@pytest.mark.parametrize("how", ["exhausted", "shed"])
def test_linger_copy_released_matches(how):
    """A lazily migrated continuation whose retries run out, or which is
    shed while queued: the source's linger copy is reclaimed."""
    def story(P):
        C = P.cluster
        topo = _topo(P, nvlink=True)
        g0, g1 = _serving_core(P, "gpu0", 0, 300), _serving_core(P, "gpu1", 1, 2)
        fabric = C.PeerPrefetchFabric(topo, [g0, g1])
        fabric.wire()
        rb = C.Rebalancer(topo, prefetch=fabric, max_retries=0 if how == "exhausted" else 3)
        rb.attach([g0, g1])
        g0.run(200_000.0, final=False)
        mv = rb._move_one(g0, g1, 200_000.0)
        out = [plain(mv), g0.pool.used]
        if how == "exhausted":
            g1.admission = type("RejectAll", (P.sim.AdmissionController,),
                                {"decide": lambda self, prog, t, state: "reject"})()
            g1.run(mv.arrival_us + 1_000_000.0, final=False)
            out.append(fabric.reap(final=True))
        else:
            g1.admission = _queue_all(P, gated=False)
            g1.run(mv.arrival_us + 1_000.0, final=False)
            frt = _runtime(P, [], topo, [g0, g1], fabric=fabric, shed_threshold=0.0)
            frt._shed_pressure(g1.t)
            out.append(_runtime_state(frt, [g0, g1]))
        P.invariants.InvariantAuditor([g0, g1], topology=topo, fabric=fabric).check(g1.t, "post")
        out += [plain(rb.events), rb.exhausted, fabric.directory.get(0), sorted(g0.lingering), g0.pool.used,
                fabric.reclaimed_pages]
        return out

    out = both(story)
    assert out[0]["kind"] == "p2p" and out[-2] == 0
