"""MoE under the sharded step's batch split, and microbatches under it, on
8 gloo ranks on the CPU (``run_ranks`` of ``tests/test_torch_distributed.py``).

The reference's ``moe_apply`` routes all tokens of its call: under GSPMD the
global batch. A rank of the port holds its rows only, so its dispatch
all-gathers the dp group's (k, E) count table and places each of its
assignments among the group's (``models/layers.moe_dispatch``), and the
load-balance term sums its statistics over the group. Held on (2, 2, 2)
(the batch over pod x data, one row a rank) and (2, 4) (over data), for
grok-1-314b and arctic-480b reduced, in f32, at capacity factors 2.0 and
0.5 (0.5 drops tokens): every global assignment's place and ``keep``
exactly the unsharded dispatch's; the load-balance term within 1e-6; the
losses and parameters of 3 steps within 1e-5 of the unsharded step.

With microbatches, each rank takes its rows of each of the reference's
microbatches (global rows j mb .. (j + 1) mb), so that each microbatch's
token-mean and MoE dispatch see the reference's tokens: the dense model and
grok-1-314b at microbatches = 2 equal ``make_train_step``'s microbatched
step within 1e-5.
"""
import pytest

torch = pytest.importorskip("torch")

from test_torch_distributed import _RANK, run_ranks  # noqa: E402

_CASES = _RANK.split('\nif __name__ == "__main__":')[0] + r'''
from repro_torch.models.layers import moe_dispatch
from repro_torch.sharding import fsdp

ARCHS = ("grok-1-314b", "arctic-480b")


def steps(cfg, mesh, n, **kw):
    sched = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 30}
    step = make_train_step(cfg, **sched, **kw) if mesh is None else make_sharded_train_step(cfg, mesh, **sched, **kw)
    state, losses = fresh(cfg, mesh), []
    for b in batches(cfg, n):
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def case_moe(mesh, out):
    """Each arch at each capacity factor: the dispatch of one set of router
    logits (each rank its rows), the load-balance term at the initial
    parameters, and 3 steps, sharded and not."""
    axes = fsdp.mesh_axes(mesh, dp_axes(mesh))
    n_dp, r = fsdp.batch_size(axes), fsdp.batch_index(axes)
    for arch in ARCHS:
        for cf in (2.0, 0.5):
            base = get_config(arch).reduced()
            cfg = dataclasses.replace(base, dtype="float32",
                                      moe=dataclasses.replace(base.moe, capacity_factor=cf))
            m = cfg.moe
            logits = torch.randn((n_dp * 96, m.num_experts), generator=torch.Generator().manual_seed(3))
            want = moe_dispatch(logits, m)
            got = moe_dispatch(logits[r * 96:(r + 1) * 96], m, axes)

            def whole(t):  # (k * 96,) on each rank -> the global choice-major order
                return fsdp.batch_all_gather(t.view(m.top_k, 96), axes).transpose(0, 1).reshape(-1)

            rows = fsdp.batch_all_gather(got.rows, axes).sum(dim=0)
            placed = place(fresh(cfg)["params"], state_shardings(cfg, fresh(cfg), mesh)["params"])
            batch = batches(cfg, 1)[0]
            _, aux, _ = value_and_grad(build_model(cfg), tree_map(local, placed), batch,
                                       sharded_split(cfg, mesh, placed, batch))
            _, want_aux, _ = value_and_grad(build_model(cfg), fresh(cfg)["params"], batch)
            st, got_losses = steps(cfg, mesh, 3)
            ref, want_losses = steps(cfg, None, 3)
            out[f"{arch} {cf}"] = {
                "posn": torch.equal(whole(got.posn), want.posn), "keep": torch.equal(whole(got.keep), want.keep),
                "dropped": int((~want.keep).sum()), "rows": torch.equal(rows, want.rows),
                "cap": [got.cap, want.cap], "aux": abs(float(aux["aux"]) - float(want_aux["aux"])),
                "aux_value": float(want_aux["aux"]), "loss_rel": rel(got_losses, want_losses),
                "params_rel": max_rel_leaf(st["params"], ref["params"])}


def case_micro(mesh, out):
    """(2, 4), microbatches = 2: 3 steps, sharded and not."""
    for arch in ("qwen3-1.7b", "grok-1-314b"):
        cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32")
        st, got = steps(cfg, mesh, 3, microbatches=2)
        ref, want = steps(cfg, None, 3, microbatches=2)
        out[arch] = {"loss_rel": rel(got, want), "params_rel": max_rel_leaf(st["params"], ref["params"])}
''' + '\nif __name__ == "__main__":' + _RANK.split('\nif __name__ == "__main__":')[1]


@pytest.fixture(scope="module", params=["2x2x2", "2x4"])
def moe(request, tmp_path_factory):
    return request.param, run_ranks(tmp_path_factory.mktemp("moe"), "moe", request.param, script_text=_CASES,
                                    timeout=400)


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_routes_over_the_dp_group(moe, arch, cf):
    mesh, results = moe
    out = results[f"{arch} {cf}"]
    assert out["posn"] and out["keep"] and out["rows"], out
    assert (out["dropped"] > 0) == (cf < 1), out
    # 96 tokens a rank, k = 2 of E = 4: a rank's buffer holds min(capacity, 96) slots an expert
    assert out["cap"] == [min(out["cap"][1], 96), out["cap"][1]], out
    assert out["aux"] <= 1e-6, out
    assert out["loss_rel"] <= 1e-5 and out["params_rel"] <= 1e-5, out


@pytest.fixture(scope="module")
def micro(tmp_path_factory):
    return run_ranks(tmp_path_factory.mktemp("micro"), "micro", "2x4", script_text=_CASES)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "grok-1-314b"])
def test_microbatches_take_each_ranks_rows_of_each_microbatch(micro, arch):
    out = micro[arch]
    assert out["loss_rel"] <= 1e-5 and out["params_rel"] <= 1e-5, out
