"""The port's dry-run (``repro_torch.launch.dryrun``, ``roofline/costs.py``)
on the CPU.

Its products' FLOPs for a reduced train cell of each family (dense, MoE,
SSM, hybrid, VLM, audio) on one device agree with
``analyze_hlo(jit(make_train_step).lower(...).compile().as_text()).dot_flops``
of the JAX package within 2%. They are equal for five families. The SSM's
differ by 1.55% (1.30% with remat): the chunked scan's three- and four-operand einsums
(``bijh,bjh,bjhp->bihp``, ``bis,bih,bhps->bihp``,
``bjs,bjh,bjh,bjhp->bhps``) contract in another order under
``torch.einsum`` than under XLA, which moves an elementwise factor into or
out of a product; that is the only difference allowed. Each cell runs with
remat off (the reduced configs') and on (the published configs'): with
remat, both replay a layer's forward in its backward but for the last
product, whose output the backward does not need (XLA removes it as dead
code; PyTorch's checkpoint stops its replay once every saved tensor is
back).

Also: the depth extrapolation equals a direct count, the per-device bytes
are those of the real state, the collective plan is the sharded step's
(one layer gathered at a time, its gradients reduce-scattered or
all-reduced as its backward ends), and ``main`` writes every cell of an
arch on the three meshes. ``temp_bytes`` against what the step holds on
gloo ranks: ``tests/test_torch_fsdp.py``."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as ref_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShape  # noqa: E402
from repro.launch import steps as ref_steps  # noqa: E402
from repro.launch.specs import batch_spec as ref_batch_spec  # noqa: E402
from repro.roofline.hlo_costs import analyze_hlo  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.steps import make_train_state  # noqa: E402
from repro_torch.roofline.costs import depth_flops  # noqa: E402
from repro_torch.sharding.specs import state_shardings  # noqa: E402
from repro_torch.tree import flatten  # noqa: E402

S, B = 64, 2
# family -> (arch, the largest relative difference allowed, its cause)
FAMILIES = {
    "dense": ("qwen3-1.7b", 0.0, None),
    "moe": ("grok-1-314b", 0.0, None),
    "ssm": ("mamba2-1.3b", 0.02, "multi-operand einsums contracted in another order"),
    "hybrid": ("recurrentgemma-9b", 0.0, None),
    "vlm": ("qwen2-vl-7b", 0.0, None),
    "audio": ("hubert-xlarge", 0.0, None),
}


def port_flops(cfg, shape, mesh="1x1"):
    return depth_flops(cfg, dryrun.build_cell(cfg, shape, mesh).count)


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_dot_flops_match_the_reference_hlo(family, remat):
    arch, allowed, _cause = FAMILIES[family]
    rcfg = dataclasses.replace(ref_config(arch).reduced(), remat=remat)
    state = ref_steps.abstract_train_state(rcfg)
    batch = ref_batch_spec(rcfg, RefShape("t", S, B, "train"))
    hlo = jax.jit(ref_steps.make_train_step(rcfg)).lower(state, batch).compile().as_text()
    want = analyze_hlo(hlo).dot_flops
    got = port_flops(dataclasses.replace(get_config(arch).reduced(), remat=remat), ShapeSpec("t", S, B, "train"))
    assert want > 0
    assert abs(got - want) <= allowed * want, (got, want, got / want)


@pytest.mark.parametrize("arch, layers", [("qwen3-1.7b", 5), ("recurrentgemma-9b", 8), ("mamba2-1.3b", 3)])
def test_depth_extrapolation_equals_a_direct_count(arch, layers):
    cfg = dataclasses.replace(get_config(arch).reduced(), num_layers=layers)
    shape = ShapeSpec("t", 32, 2, "train")
    cell = dryrun.build_cell(cfg, shape, "1x1")
    assert depth_flops(cfg, cell.count) == cell.count(cfg)


def test_state_bytes_are_the_real_state_and_the_plan_the_sharded_step():
    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeSpec("t", 64, 4, "train")
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    whole = sum(t.numel() * t.element_size() for _, t in flatten(state))
    assert dryrun.build_cell(cfg, shape, "1x1").mem["state_bytes"] == whole

    cell = dryrun.build_cell(cfg, shape, "2x4")
    specs = dict(flatten(state_shardings(cfg, state, cell.mesh)))
    shard = sum(torch.Size(specs[p].shard_shape(tuple(t.shape))).numel() * t.element_size()
                for p, t in flatten(state))
    assert cell.mem["state_bytes"] == shard < whole
    params = [(specs["params/" + p], t) for p, t in flatten(state["params"])]
    param_shard = sum(torch.Size(s.shard_shape(tuple(t.shape))).numel() * t.element_size() for s, t in params)
    costs = cell.plan.costs(0)
    # each split leaf gathered once a layer (remat off, embeddings untied), the
    # optimizer's state never: the whole size less the shard
    assert costs.collective_bytes["all-gather"] == sum(t.numel() * t.element_size() for _, t in params) - param_shard
    # the batch of 4 splits over data = 2. Each gradient is sliced over model
    # first, where model splits it; then a leaf split over data is
    # reduce-scattered (the slice less its half), any other all-reduced
    # (twice the slice); grad_norm all-reduces a 4-byte sum over each axis
    # that splits a leaf, and the label count, loss and ce one over data
    rs = ar = 0
    for s, t in params:
        axes = [a for d in range(t.dim()) for a in s.axes(d)]
        sliced = t.numel() * t.element_size() // (4 if "model" in axes else 1)
        if "data" in axes:
            rs += sliced - sliced // 2
        else:
            ar += 2 * sliced
        ar += 2 * 4 * len(axes)
    assert costs.collective_bytes["reduce-scatter"] == rs > 0
    assert costs.collective_bytes["all-reduce"] == ar + 2 * 3 * 4
    assert cell.rows == 2


def test_main_writes_every_cell_on_the_three_meshes(tmp_path):
    out = tmp_path / "dry.jsonl"
    records = dryrun.main(["--arch", "hubert-xlarge", "--meshes", ",".join(dryrun.MESHES), "--out", str(out)])
    lines = [json.loads(line) for line in out.read_text().splitlines()]
    assert lines == json.loads(json.dumps(records)) and len(lines) == 12
    ok = [r for r in lines if r["status"] == "ok"]
    assert {(r["shape"], r["mesh"]) for r in ok} == {(s, m) for s in ("train_4k", "prefill_32k")
                                                      for m in dryrun.MESHES}
    assert all(r["status"] == "skipped" for r in lines if r not in ok)
    for r in ok:
        assert {"mem", "cost_analysis", "hlo_costs", "model", "fits_h100"} <= set(r)
        assert r["hlo_costs"]["dot_flops"] > 0 and r["mem"]["argument_bytes"] > 0
    by_mesh = {r["mesh"]: r for r in ok if r["shape"] == "train_4k"}
    # 256 rows: 16 a device on 16x16, 8 on 2x16x16, all on the one card
    assert [by_mesh[m]["rows_per_device"] for m in dryrun.MESHES] == [16, 8, 256]
    assert by_mesh["1x1"]["hlo_costs"]["dot_flops"] == 16 * by_mesh["16x16"]["hlo_costs"]["dot_flops"]
    assert sum(by_mesh["1x1"]["hlo_costs"]["collective_bytes"].values()) == 0
