"""The port's ``simulate_cluster`` against the JAX package's: the same trace
over the same fleet gives the same ``ClusterReport``, compared as the text
of ``ClusterReport.to_json()`` (every per-GPU result, request record,
migration and peer fetch in it; the report holds no wall clock). Covered:
the three placements under the msched, ideal and um backends with
``transfer_plan`` greedy and auto, the 1-GPU fleet against ``serve_trace``,
the paged pool, the steal and the checkpointed move through a stage dir
(``tests/cluster/test_cluster_engine.py``'s scenarios), and each package
reading the other's report documents, schemas v1 and v2."""
import dataclasses
import importlib
import json
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


def text(rep):
    return json.dumps(rep.to_json(), sort_keys=True)


def _trace(P, rate=6.0, duration=1.5, seed=3, output_mean=24):
    return P.serving.poisson_trace(rate, duration, seed=seed, tenants=(ARCH,), prompt_mean=64,
                                   output_mean=output_mean, max_output=2 * output_mean)


def _pin0(P):
    return type("Pin0", (P.cluster.PlacementPolicy,), {"name": "pin0", "place": lambda self, prog, t, cores: 0})()


def _factories(P, backend):
    quantum = 2_000.0 if backend in ("um", "suv") else 350_000.0
    if backend in ("msched", "ideal"):
        admission = lambda i: P.serving.MSchedAdmission(headroom=0.9)  # noqa: E731
    else:
        admission = lambda i: P.serving.AlwaysAdmit()  # noqa: E731
    return dict(admission_factory=admission, policy_factory=lambda i: P.scheduler.RoundRobinPolicy(quantum))


def both(run):
    """``run(P)`` on each package; the reports' texts equal. Returns the
    port's report."""
    reps = [own(run(P), P) for P in SIDES]
    same(text(reps[0]), text(reps[1]))
    same(reps[0].to_row(), reps[1].to_row())
    return reps[1]


@pytest.mark.parametrize("plan", ["greedy", "auto"])
@pytest.mark.parametrize("placement", ["roundrobin", "leastloaded", "msched"])
@pytest.mark.parametrize("backend", ["msched", "ideal", "um"])
def test_fleet_matches(backend, placement, plan):
    """Two RTX5080s on PCIe, 3 GiB each, rebalancing every 200 ms."""
    rep = both(lambda P: P.cluster.simulate_cluster(
        _trace(P), P.cluster.homogeneous(2, P.hardware.RTX5080, capacity_bytes=3 << 30), backend=backend,
        placement=placement, page_size=PAGE, rebalance_period_us=200_000.0, rebalance_threshold=0.3,
        transfer_plan=plan, **_factories(P, backend)))
    assert rep.stats.n_finished == rep.stats.n_requests == 10
    assert (rep.planned_transfers > 0) == (plan == "auto" and bool(rep.migrations))


@pytest.mark.parametrize("pool", ["run", "paged"])
@pytest.mark.parametrize("backend", ["um", "msched", "ideal", "suv"])
def test_one_gpu_fleet_matches_and_is_serve_trace(backend, pool):
    """A 1-GPU fleet in each package, and in each the same run as its own
    ``serve_trace`` (the reference's pinned equivalence)."""
    cap = 4 << 30

    def run(P):
        f = _factories(P, backend)
        rep = P.cluster.simulate_cluster(_trace(P, rate=4.0, duration=1.2, seed=11, output_mean=8),
                                         P.cluster.homogeneous(1, P.hardware.RTX5080, capacity_bytes=cap),
                                         backend=backend, placement="roundrobin", page_size=PAGE, pool=pool, **f)
        single = P.serving.serve_trace(_trace(P, rate=4.0, duration=1.2, seed=11, output_mean=8),
                                       P.hardware.RTX5080, backend=backend, capacity_bytes=cap,
                                       admission=f["admission_factory"](0), policy=f["policy_factory"](0),
                                       page_size=PAGE, pool=pool)
        assert rep.merged.sim_us == single.result.sim_us and rep.stats.ttft_p99_us == single.ttft_p99_us
        return rep

    both(run)


def test_skewed_fleet_steals_match():
    """Every arrival pinned to gpu0 with room for about one request: the
    rebalancer reroutes queued candidates to gpu1."""
    rep = both(lambda P: P.cluster.simulate_cluster(
        _trace(P, rate=10.0, duration=1.0, seed=9, output_mean=32),
        P.cluster.homogeneous(2, P.hardware.RTX5080, capacity_bytes=2 << 30), backend="msched",
        placement=_pin0(P), page_size=PAGE, rebalance_period_us=300_000.0, rebalance_threshold=0.3,
        **_factories(P, "msched")))
    assert "steal" in [m.kind for m in rep.migrations]


def test_stage_dir_run_matches(tmp_path):
    """tests/cluster/test_cluster_engine.py's checkpointed migration: each
    move's working set is saved and restored through each package's own
    checkpoint format in a stage dir."""
    def run(P):
        return P.cluster.simulate_cluster(
            _trace(P), P.cluster.homogeneous(2, P.hardware.RTX5080, capacity_bytes=4 << 30), backend="msched",
            placement=_pin0(P), page_size=PAGE, rebalance_period_us=200_000.0, rebalance_threshold=0.3,
            stage_dir=str(tmp_path / P.root), **_factories(P, "msched"))

    rep = both(run)
    assert [m for m in rep.migrations if m.kind == "checkpoint"]
    names = [sorted(p.name for p in (tmp_path / P.root).iterdir()) for P in SIDES]
    assert names[0] == names[1] and any(n.startswith("step_") for n in names[1])


def test_reports_cross_between_packages():
    """Each package's ``ClusterReport.from_json`` reads the other's
    document, schema v2 as written and v1 with the control counters
    removed; what comes back is written out again as the same text."""
    reps = {P.root: own(P.cluster.simulate_cluster(
        _trace(P), P.cluster.homogeneous(2, P.hardware.RTX5080, capacity_bytes=3 << 30,
                                         nvlink_gbps=P.hardware.NVLINK_A100_GBPS),
        backend="msched", placement=_pin0(P), page_size=PAGE, rebalance_period_us=400_000.0,
        rebalance_threshold=0.4, slo=P.serving.SLOSpec(ttft_us=3_000_000.0, tpot_us=100_000.0),
        **_factories(P, "msched")), P) for P in SIDES}
    same(text(reps["repro"]), text(reps["repro_torch"]))
    assert reps["repro_torch"].migrations
    v2 = json.loads(json.dumps(reps["repro"].to_json()))
    v2.update(journal_len=41, journal_replays=2, coordinator_crashes=2, deadline_misses=3, preemptions=5,
              deadline_sheds=1)
    v1 = json.loads(json.dumps(reps["repro_torch"].to_json()))
    v1["schema"] = "cluster-report-v1"
    for k in ("journal_len", "journal_replays", "coordinator_crashes", "deadline_misses", "preemptions",
              "deadline_sheds", "planned_transfers", "planner_replans", "planner_deferred"):
        del v1[k]
    for doc in (v2, v1):
        back = [own(P.cluster.ClusterReport.from_json(json.loads(json.dumps(doc))), P) for P in SIDES]
        same(text(back[0]), text(back[1]))
        same(dataclasses.asdict(back[0].stats), dataclasses.asdict(back[1].stats))
        assert back[1].to_json()["schema"] == "cluster-report-v2"
    assert PORT.cluster.ClusterReport.from_json(v2).preemptions == 5
    for bad in ({"schema": "cluster-report-v99"}, {}):
        errors = []
        for P in SIDES:
            with pytest.raises(ValueError) as e:
                P.cluster.ClusterReport.from_json(bad)
            errors.append(str(e.value))
        same(*errors)
