"""The port's NVLink peer-to-peer prefetch against the JAX package's, on the
scenarios of ``tests/cluster/test_p2p_prefetch.py``: a lingering working
set fetched over NVLink (priced at the edge's fluid share, sharing it with
a migration, falling back to host for what the source evicted), the lazy
p2p migration end to end, the peer-less and prefetch-off fleets, steals
that harvest linger copies, and the retry protocol under deadline
admission.

Every ``PeerFetchEvent`` and ``MigrationEvent`` must be equal: whole runs
are compared as the text of ``ClusterReport.to_json()``, the fabric's
stories by their events, plans and every core's request records. Each side
is built from its own package."""
import dataclasses
import importlib
import json
import types

import numpy as np
import pytest

pytest.importorskip("torch")


def _pkg(root):
    mod = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return types.SimpleNamespace(
        root=root,
        cluster=mod("cluster"),
        topology=mod("cluster.topology"),
        hardware=mod("core.hardware"),
        scheduler=mod("core.scheduler"),
        sim=mod("core.simulator"),
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
    if isinstance(x, np.ndarray):
        return (x.dtype.str, x.tolist())
    return x


def both(fn):
    ref, port = (fn(P) for P in SIDES)
    same(ref, port)
    return port


def _trace(P, rate=6.0, duration=1.5, seed=3, output_mean=24):
    return P.serving.poisson_trace(rate, duration, seed=seed, tenants=(ARCH,), prompt_mean=64,
                                   output_mean=output_mean, max_output=2 * output_mean)


def _pin0(P):
    return type("Pin0", (P.cluster.PlacementPolicy,), {"name": "pin0", "place": lambda self, prog, t, cores: 0})()


def _admission(P, kind):
    return type(kind, (P.sim.AdmissionController,),
                {"decide": lambda self, prog, t, state: {"RejectAll": "reject", "QueueAll": "queue"}[kind]})()


def _topo(P, n=2, cap=4 << 30, nvlink=True):
    return P.cluster.homogeneous(n, P.hardware.RTX5080, capacity_bytes=cap,
                                 nvlink_gbps=P.hardware.NVLINK_A100_GBPS if nvlink else None)


def _serving_core(P, name, req_id=0, output_tokens=400, cap=4 << 30):
    S = P.serving
    req = S.Request(req_id, ARCH, 1_000.0, prompt_tokens=64, output_tokens=output_tokens)
    events = [P.sim.TaskArrival(req.arrival_us, S.ServedRequestTask(req_id, req, page_size=PAGE))]
    return own(P.sim.SimCore(
        [], P.hardware.RTX5080, "msched", capacity_bytes=cap, policy=P.scheduler.RoundRobinPolicy(350_000.0),
        task_events=events, page_size=PAGE, prepopulate=False, name=name,
        profile_set=[S.ServedRequestTask(10_000_000 + req_id, req, page_size=PAGE)]), P)


def _cores(cores):
    return [(c.name, c.t, c.pool.used, sorted(c.lingering), [plain(r) for r in c.records]) for c in cores]


def _fabric(fabric):
    return dict(fetches=plain(fabric.fetches), directory=plain(fabric.directory.entries()),
                fallback=fabric.fallback_pages, fresh=fabric.fresh_pages, reclaimed=fabric.reclaimed_pages,
                reaped=fabric.finish_reaped)


def _tiered(plan):
    """A ``TieredMigration`` as plain values (its host plan is a
    ``MigrationPlan`` dataclass; its peers ``PeerGroup``s)."""
    if plan is None:
        return None
    return dict(peers=plain(plan.peers), host=plain(plan.host), populate=plan.populate_bytes, peer=plan.peer_bytes,
                total_us=plan.total_us)


# --------------------------------------------------------------------------
# The fabric over a lingering working set
# --------------------------------------------------------------------------


def _linger_pair(P):
    topo = _topo(P)
    src = _serving_core(P, "gpu0", req_id=0)
    dst = _serving_core(P, "gpu1", req_id=1, output_tokens=4)
    src.run(200_000.0, final=False)
    tid = next(iter(src.tasks))
    ej = src.eject(tid, linger=True)
    fabric = own(P.cluster.PeerPrefetchFabric(topo, [src, dst]), P)
    fabric.wire()
    fabric.directory.record(tid, "gpu0", "gpu1", ej.resident_runs, 200_000.0)
    return topo, src, dst, fabric, tid, ej


@pytest.mark.parametrize("story", ["fetch", "shared-edge", "fallback", "reclaim"])
def test_peer_fetch_matches(story):
    def run(P):
        topo, src, dst, fabric, tid, ej = _linger_pair(P)
        ws = list(ej.resident_runs)
        out = [ws, src.pool.used, src.pool.eviction_runs()[:3]]
        if story == "fetch":
            out.append(_tiered(fabric._plan_fetch(dst, tid, ws, 0, now=1_000.0)))
        elif story == "shared-edge":
            out.append(plain(topo.plan_transfer("gpu0", "gpu1", 1 << 30, now=1_000.0)))
            out.append(_tiered(fabric._plan_fetch(dst, tid, ws, 0, now=1_000.0)))
            out.append(plain(topo.plan_transfer("gpu0", "gpu1", 1 << 30, now=1_000.0)))
        elif story == "fallback":
            src.pool.drop_runs(ws[: len(ws) // 2] or [ws[0]])
            out.append(_tiered(fabric._plan_fetch(dst, tid, ws, 0, now=1_000.0)))
            fabric.directory.record(tid, "gpu0", "gpu1", ws, 0.0)
            src.pool.drop_runs(ws)
            out += [_tiered(fabric._plan_fetch(dst, tid, ws, 0, now=2_000.0)),
                    _tiered(fabric._plan_fetch(dst, tid, ws, 0, now=3_000.0))]
        else:
            out += [src.reclaim_linger(tid), src.reclaim_linger(tid), fabric.reap(final=True)]
        out += [_fabric(fabric), _cores([src, dst])]
        return out

    out = both(run)
    assert out[0]


# --------------------------------------------------------------------------
# Whole runs
# --------------------------------------------------------------------------


def _run(P, trace, topo, **kw):
    kw.setdefault("admission_factory", lambda i: P.serving.MSchedAdmission(headroom=0.9))
    return json.dumps(own(P.cluster.simulate_cluster(
        trace, topo, backend="msched", placement=_pin0(P), page_size=PAGE,
        policy_factory=lambda i: P.scheduler.RoundRobinPolicy(350_000.0), **kw), P).to_json(), sort_keys=True)


@pytest.mark.parametrize("prefetch", ["auto", "off"])
def test_nvlink_fleet_matches(prefetch):
    """Skewed load on an NVLink pair: lazy p2p moves and peer fetches with
    the fabric on, bulk moves with it off."""
    doc = json.loads(both(lambda P: _run(P, _trace(P, rate=8.0, duration=2.0, output_mean=64), _topo(P, cap=3 << 30),
                                         rebalance_period_us=250_000.0, rebalance_threshold=0.3,
                                         peer_prefetch=prefetch)))
    kinds = {m["kind"] for m in doc["migrations"]}
    if prefetch == "auto":
        assert "p2p" in kinds and doc["peer_fetches"]
    else:
        assert kinds <= {"steal", "checkpoint"} and not doc["peer_fetches"]


def test_peerless_fleet_matches():
    both(lambda P: _run(P, _trace(P), _topo(P, nvlink=False), rebalance_period_us=200_000.0,
                        rebalance_threshold=0.3, peer_prefetch="auto"))


def test_deadline_rejections_match():
    doc = json.loads(both(lambda P: _run(
        P, _trace(P, rate=8.0, duration=2.0, output_mean=48), _topo(P, cap=3 << 30),
        admission_factory=lambda i: P.serving.MSchedAdmission(headroom=0.9, max_wait_us=600_000.0),
        rebalance_period_us=250_000.0, rebalance_threshold=0.3, drain_factor=12.0)))
    assert doc["stats"]["n_finished"] + doc["stats"]["n_rejected"] == doc["stats"]["n_requests"]


# --------------------------------------------------------------------------
# Steals and rejections around linger copies
# --------------------------------------------------------------------------


@pytest.mark.parametrize("onward", [True, False], ids=["beyond-nvlink-reach", "back-to-holder"])
def test_steal_harvests_linger_copy_matches(onward):
    def story(P):
        T = P.topology
        if onward:
            topo = T.ClusterTopology([T.GPUNode(f"gpu{i}", P.hardware.RTX5080, 4 << 30) for i in range(3)],
                                     nvlinks=[("gpu0", "gpu1", P.hardware.NVLINK_A100_GBPS)])
        else:
            topo = _topo(P)
        cores = [_serving_core(P, f"gpu{i}", req_id=i, output_tokens=300 if i == 0 else 2)
                 for i in range(3 if onward else 2)]
        g0, g1 = cores[0], cores[1]
        g1.admission = _admission(P, "QueueAll")
        fabric = P.cluster.PeerPrefetchFabric(topo, cores)
        fabric.wire()
        rb = P.cluster.Rebalancer(topo, prefetch=fabric)
        rb.attach(cores)
        g0.run(200_000.0, final=False)
        mv = rb._move_one(g0, g1, 200_000.0)
        g1.run(mv.arrival_us + 1_000.0, final=False)
        mv2 = rb._move_one(g1, cores[2] if onward else g0, mv.arrival_us + 2_000.0)
        out = [plain(mv), plain(mv2), _fabric(fabric)]
        for c in reversed(cores) if onward else (g0,):
            c.run(30_000_000.0, final=True)
        out += [plain(rb.events), fabric._make_cluster_view(g0)(g0.t), _fabric(fabric), _cores(cores)]
        return out

    out = both(story)
    assert out[0]["kind"] == "p2p" and out[1]["kind"] == "steal"


def test_fresh_arrival_rejections_match():
    """Fresh and rerouted arrivals that admission rejects stay rejected:
    only continuations get the retry protocol."""
    def story(P):
        topo = _topo(P, nvlink=False)
        src, dst = _serving_core(P, "gpu0", 0, 4), _serving_core(P, "gpu1", 1, 4)
        src.admission = _admission(P, "RejectAll")
        rb = P.cluster.Rebalancer(topo)
        rb.attach([src, dst])
        src.run(10_000_000.0, final=True)
        req = P.serving.Request(5, ARCH, 1_000.0, prompt_tokens=64, output_tokens=4)
        dst.admission = _admission(P, "RejectAll")
        dst.inject(P.sim.TaskArrival(dst.t + 1_000.0, P.serving.ServedRequestTask(5, req, page_size=PAGE),
                                     meta={"rerouted_from": "gpu0"}))
        dst.run(dst.t + 10_000_000.0, final=True)
        return plain(rb.events), _cores([src, dst])

    events, cores = both(story)
    assert not events and any(r["rejected"] for r in cores[0][4])
