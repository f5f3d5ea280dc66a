"""The slice as a whole: the port's live runtime and serving loop on the CPU
against the JAX package's, on the dense pair with the reference's own
parameters. Segments and MSched's decisions (steps, migrated bytes, demand
faults) must be equal exactly; outputs bit-identical to the port's own
all-resident run and within rtol = atol = 5e-2 of the reference's (bf16
rounds at other places in the two frameworks)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

from repro.configs import get_config  # noqa: E402
from repro.core.runtime import LiveModelTask as RefTask  # noqa: E402
from repro.core.runtime import LiveRuntime as RefRuntime  # noqa: E402
from repro.models.model import build_model  # noqa: E402
from repro.runtime.serve_loop import MultiModelServer as RefServer  # noqa: E402
from repro_torch.core.runtime import LiveModelTask, LiveRuntime  # noqa: E402
from repro_torch.runtime.serve_loop import MultiModelServer, Request  # noqa: E402

RTOL = ATOL = 5e-2
ARCHS = ["qwen3-1.7b", "llama3.2-3b"]
BUDGETS = [
    # (page size, budget as a share of what, share, steps per slice, slices)
    (4096, "footprint", 0.5, 4, 6),  # tests/core/test_live_runtime.py, first case
    (4096, "params", 0.6, 2, 6),  # its second case
    # the full-width run's 2 MiB pages, where every reduced segment is one
    # page: the budget counts pages so that each task still fits alone
    (1 << 21, "pages", 1 / 1.5, 2, 6),
]


def _ref_params(arch, seed):
    fns = build_model(get_config(arch).reduced())
    return jax.tree.map(np.asarray, fns.init(jax.random.PRNGKey(seed)))


def _pairs(page_size):
    ref = [RefTask(i, a, page_size=page_size, seed=i) for i, a in enumerate(ARCHS)]
    ours = [
        LiveModelTask(i, a, page_size=page_size, seed=i, device="cpu", params=_ref_params(a, i))
        for i, a in enumerate(ARCHS)
    ]
    return ref, ours


@pytest.fixture(scope="module")
def tasks():
    return {ps: _pairs(ps) for ps in sorted({b[0] for b in BUDGETS})}


def _evict_all(tasks):
    for t in tasks:
        for s in t.segments:
            s.device = None


def _all_resident(task):
    for s in task.segments:
        if s.device is None:
            s.device = s.host.to(task.device) if isinstance(s.host, torch.Tensor) else jax.device_put(s.host)


def _budget(tasks, what, share):
    if what == "footprint":
        total = sum(t.footprint_bytes() for t in tasks)
    elif what == "pages":
        spans = [t.space.page_span() for t in tasks]
        total = sum(stop - first for first, stop in spans) * tasks[0].space.page_size
    else:
        total = sum(s.nbytes for t in tasks for s in t.segments)
    return int(total * share)


@pytest.mark.parametrize("page_size", sorted({b[0] for b in BUDGETS}))
def test_segments_match_reference(tasks, page_size):
    ref, ours = tasks[page_size]
    for r, o in zip(ref, ours):
        ref_segs = [(s.path.replace("['", "").replace("']", ""), s.base, s.nbytes) for s in r.segments]
        assert [(s.path, s.base, s.nbytes) for s in o.segments] == ref_segs
        assert o.kv_buf.base == r.kv_buf.base
        assert o.footprint_bytes() == r.footprint_bytes()
    assert len(ours[0].segments) == 14  # qwen3: q/k norms on top of llama's 12


@pytest.mark.parametrize("page_size,what,share,sps,slices", BUDGETS)
def test_stats_equal_reference(tasks, page_size, what, share, sps, slices):
    ref, ours = tasks[page_size]
    _evict_all(ref + ours)
    budget = _budget(ref, what, share)
    a = RefRuntime(ref, budget, steps_per_slice=sps, page_size=page_size).run(slices)
    b = LiveRuntime(ours, budget, steps_per_slice=sps, page_size=page_size).run(slices)
    assert b.steps == a.steps
    assert b.migrated_in_bytes == a.migrated_in_bytes > 0
    assert b.migrated_out_bytes == a.migrated_out_bytes
    assert b.demand_faults == a.demand_faults
    assert len(b.switch_wall_s) == len(b.coordinator_wall_s) == slices
    if what != "footprint":
        assert b.migrated_out_bytes > 0


@pytest.mark.parametrize("page_size,what,share,sps,slices", BUDGETS[:2])
def test_oversubscribed_outputs_bit_identical(tasks, page_size, what, share, sps, slices):
    _, ours = tasks[page_size]
    baseline = {}
    for t in ours:
        _evict_all([t])
        _all_resident(t)
        baseline[t.task_id] = [t.run_step(i) for i in range(slices * sps)]
    _evict_all(ours)
    seen = {t.task_id: [] for t in ours}
    for t in ours:  # record what each step returns inside the multitasked run
        t.run_step = lambda i, t=t, f=t.run_step: seen[t.task_id].append(f(i)) or seen[t.task_id][-1]
    try:
        stats = LiveRuntime(ours, _budget(ours, what, share), steps_per_slice=sps).run(slices)
    finally:
        for t in ours:
            del t.run_step
    assert stats.migrated_in_bytes > 0
    for t in ours:
        assert len(seen[t.task_id]) == stats.steps[t.task_id] > 0
        for a, b in zip(seen[t.task_id], baseline[t.task_id]):
            assert torch.equal(a, b)


def test_outputs_match_reference(tasks):
    ref, ours = tasks[4096]
    for r, o in zip(ref, ours):
        _all_resident(r)
        _all_resident(o)
        for i in range(3):
            got = o.run_step(i)
            want = r.run_step(i)
            assert tuple(got.shape) == want.shape
            np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), rtol=RTOL, atol=ATOL)


# -- serving loop: the cases of tests/core/test_serve_loop.py on the dense pair --


@pytest.fixture(scope="module")
def servers():
    return RefServer(ARCHS, steps_per_slice=2), MultiModelServer(ARCHS, steps_per_slice=2, device="cpu")


def _submit_3_and_3(server):
    for i in range(3):
        server.submit(Request(model=0, arrival_s=0.1 * i))
        server.submit(Request(model=1, arrival_s=0.05 + 0.1 * i))


def test_server_setup_oversubscribed(servers):
    ref, ours = servers
    rt = ours.runtime
    total = sum(t.footprint_bytes() for t in rt.tasks.values())
    assert rt.pool.capacity * rt.page_size < total
    assert rt.pool.capacity == ref.runtime.pool.capacity
    assert set(ours.queues) == {0, 1}


def test_serve_drains_queues_fifo(servers):
    ref, ours = servers
    _submit_3_and_3(ref)
    want = ref.serve(wall_budget_s=60.0)
    _submit_3_and_3(ours)
    got = ours.serve(wall_budget_s=60.0)
    assert got.served == want.served == {0: 3, 1: 3}
    assert not any(ours.queues.values())
    for m in (0, 1):
        assert len(got.latencies_s[m]) == 3
        assert got.p99(m) >= max(0.0, min(got.latencies_s[m]))
    assert got.migrated_in_bytes == want.migrated_in_bytes > 0
    assert got.demand_faults == want.demand_faults
    assert ours.runtime.stats.steps == ref.runtime.stats.steps


def test_serve_empty_queue_returns_immediately(servers):
    stats = servers[1].serve(wall_budget_s=5.0)
    assert sum(stats.served.values()) == 0
    assert all(not q for q in servers[1].queues.values())


def test_p99_empty_model_is_zero(servers):
    assert servers[1].serve(wall_budget_s=0.01).p99(0) == 0.0


def test_server_full_configs_and_page_size(monkeypatch):
    # full=True takes the published configs; shrink them to keep the CPU run small
    import repro_torch.runtime.serve_loop as serve_loop

    monkeypatch.setattr(serve_loop, "get_config", lambda a: get_config(a).reduced())
    server = MultiModelServer(ARCHS, device="cpu", full=True, page_size=1 << 16)
    assert server.runtime.page_size == 1 << 16
    assert all(t.space.page_size == 1 << 16 for t in server.runtime.tasks.values())
    for i in range(4):
        server.submit(Request(model=i % 2, arrival_s=float(i)))
    assert server.serve(wall_budget_s=60.0).served == {0: 2, 1: 2}
