"""The port's meshes, sharded train state and dry-run on the CPU: one
counterpart for each test of the JAX package's ``tests/test_distributed.py``.

Where the reference forks 8 fake host devices, the port starts 8 gloo ranks,
one process each, joined through a ``FileStore`` in the test's directory
(``_RANK`` below runs as each of them). The sharded step must compute the
unsharded step's function: in f32 its losses and parameters agree within
1e-5 relative (the gradients are summed over the ranks in another order),
Adafactor's update within 1e-6, and where nothing splits the batch (MoE on
a mesh whose dp axes have size 1) bit for bit."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

_RANK = r'''
import dataclasses, json, math, sys, tempfile
import torch
import torch.distributed as dist
torch.set_num_threads(1)
from repro_torch.checkpointing.checkpoint import restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeSpec
from repro_torch.data.pipeline import pipeline_for
from repro_torch.launch.mesh import dp_axes, init_ranks, make_mesh, mesh_shape
from repro_torch.launch.steps import (
    batch_split_axes, make_sharded_train_step, make_train_state, make_train_step, sharded_split, split_batch,
    value_and_grad)
from repro_torch.models.model import build_model
from repro_torch.sharding.act import axis_size, use_activation_mesh
from repro_torch.optim.optimizers import adafactor, adamw, sgd
from repro_torch.sharding.specs import (
    LeafSharding, gather, leaf_split, local, opt_state_shardings, param_shardings, place, state_shardings)
from repro_torch.tree import flatten, leaves, tree_map

SHAPE = ShapeSpec("t", 64, 4, "train")


def batches(cfg, n, start=0):
    pipe = pipeline_for(cfg, SHAPE)
    return [{k: torch.from_numpy(v) for k, v in pipe.batch(i).items()} for i in range(start, start + n)]


def fresh(cfg, mesh=None, seed=0):
    state = make_train_state(cfg, torch.Generator().manual_seed(seed))
    return state if mesh is None else place(state, state_shardings(cfg, state, mesh))


def run(cfg, mesh, n, state=None, start=0):
    """n steps from ``start``, at the quickstart's schedule (the default
    warmup of 100 steps leaves the loss flat over a few)."""
    sched = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 30}
    step = make_train_step(cfg, **sched) if mesh is None else make_sharded_train_step(cfg, mesh, **sched)
    state = fresh(cfg, mesh) if state is None else state
    losses = []
    for b in batches(cfg, n, start):
        if mesh is None:
            state, m = step(state, b)
        else:
            with use_activation_mesh(mesh):
                state, m = step(state, b)
        losses.append(float(m["loss"]))
    return state, losses


def rel(a, b):
    return max(abs(x - y) / max(abs(y), 1e-30) for x, y in zip(a, b))


def max_rel_leaf(placed, plain):
    out = 0.0
    for (_, a), (_, b) in zip(flatten(placed), flatten(plain)):
        a, b = gather(a).double(), b.double()
        out = max(out, float((a - b).abs().max() / b.abs().max().clamp(min=1e-30)))
    return out


def grads_rel(cfg, mesh, params, batch, got):
    """For each leaf, by path, the relative difference (max |a - b| over
    max |b|) between the sharded step's gradient ``got`` at ``params``
    (placed on ``mesh``; this rank's shards, in flatten order) and the
    unsharded step's at their whole values, over this rank's shards; the
    largest over the ranks."""
    shardings = param_shardings(cfg, params, mesh)
    _, _, want = value_and_grad(build_model(cfg), tree_map(gather, params), batch)
    want = [place(w, s).to_local() for w, s in zip(want, leaves(shardings))]
    worst = torch.tensor([float((g - w).abs().max() / w.abs().max().clamp(min=1e-30)) for g, w in zip(got, want)])
    dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    return dict(zip((p for p, _ in flatten(params)), worst.tolist()))


def checked_steps(cfg, mesh, data, grads=True):
    """The sharded step over ``data`` from ``fresh``: (state, losses, grad
    norms, for each leaf the largest :func:`grads_rel` at the state each
    step starts from ({} without ``grads``), the largest relative
    difference, leaf by leaf, between the state each step leaves and the
    unsharded step's optimizer applied to the whole state it started from
    with the sharded step's own gradients, gathered). Where ``model``
    splits products their gradients differ from the unsharded ones in the
    order of the sums; fed the same gradients, the optimizer on the shards
    is held to the whole update alone."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch.steps import _train_step_parts, grad_norm

    sched = {"peak_lr": 1e-3, "warmup": 5, "total_steps": 30}
    step = make_sharded_train_step(cfg, mesh, **sched)
    _, apply = _train_step_parts(cfg, sched["peak_lr"], sched["warmup"], sched["total_steps"], 0)
    fns, state = build_model(cfg), fresh(cfg, mesh)
    shardings = leaves(param_shardings(cfg, state["params"], mesh))
    losses, norms, worst_grads, worst = [], [], {}, 0.0
    for b in data:
        whole = tree_map(lambda t: gather(t).clone(), state)
        loss, aux, g = value_and_grad(fns, tree_map(local, state["params"]), b,
                                      sharded_split(cfg, mesh, state["params"], b))
        if grads:
            for p, r in grads_rel(cfg, mesh, state["params"], b, g).items():
                worst_grads[p] = max(worst_grads.get(p, 0.0), r)
        g = [DTensor.from_local(x, s.mesh, s.placements()).full_tensor() for x, s in zip(g, shardings)]
        want, _ = apply(whole, loss, aux, g, grad_norm(g))
        state, m = step(state, b)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        worst = max(worst, max_rel_leaf(state, want))
    return state, losses, norms, worst_grads, worst


def case_sharded_step(mesh, out):
    """(2, 4): bf16 losses fall; f32 AdamW and Adafactor equal the unsharded step."""
    base = get_config("qwen3-1.7b").reduced()
    _, bf16 = run(base, mesh, 8)
    f32 = dataclasses.replace(base, dtype="float32")
    st, got = run(f32, mesh, 8)
    ref_st, want = run(f32, None, 8)
    ada = dataclasses.replace(f32, optimizer="adafactor")
    _, got_a, _, _, state_rel = checked_steps(ada, mesh, batches(ada, 2), grads=False)
    _, want_a = run(ada, None, 2)
    out.update(bf16=bf16, f32=got, f32_ref=want, f32_rel=rel(got, want),
               params_rel=max_rel_leaf(st["params"], ref_st["params"]),
               adafactor_rel=max(rel(got_a, want_a), state_rel),
               local_shapes={p: list(t.to_local().shape) for p, t in flatten(st["params"])
                             if p in ("head/embed", "layers/attn/wq")})


def case_sharded_optim(mesh, out):
    """(2, 4): each optimizer (SGD with momentum) updates this rank's shards
    of the params and of its state, with the leaves' splits, and gives the
    whole update's values: a leaf split over model, one over data and model, a stack of
    experts over model and one with its last two dims split."""
    specs = {"norm": ("model",), "w": ("data", "model"), "experts": ("model", "data", None),
             "stack": (None, "data", "model")}
    shapes = {"norm": (64,), "w": (32, 48), "experts": (4, 32, 16), "stack": (3, 16, 24)}
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(shapes[k], generator=gen) for k in sorted(shapes)}
    grads = [{k: torch.randn(shapes[k], generator=gen) for k in sorted(shapes)} for _ in range(3)]
    pspecs = {k: LeafSharding(mesh, specs[k]) for k in specs}
    for name, opt in (("adamw", adamw()), ("adafactor", adafactor()), ("sgd", sgd(momentum=0.9))):
        whole = tree_map(torch.clone, params)
        whole_state = opt.init(whole)
        placed = place(tree_map(torch.clone, params), pspecs)
        state = place(opt.init(tree_map(torch.clone, params)), opt_state_shardings(None, whole_state, pspecs, mesh))
        splits = [leaf_split(t) for t in leaves(placed)]
        for g in grads:
            opt.update(g, whole_state, whole, torch.tensor(1e-2))
            cut = {k: place(g[k], pspecs[k]).to_local() for k in g}
            opt.update(cut, tree_map(local, state), tree_map(local, placed), torch.tensor(1e-2), splits)
        out[name] = max_rel_leaf(placed, whole)
    out["split_dims"] = {p: [len(g) for g in s.groups] for (p, _), s in zip(flatten(placed), splits)}


def case_remesh(mesh, out, ckpt):
    """Phase 1 on (2, 4): 3 steps, then a checkpoint at step 3."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    st, losses = run(cfg, mesh, 3)
    save(ckpt, 3, st)
    out.update(losses=losses)


def case_resume(mesh, out, ckpt):
    """Phase 2 on (1, 2): restore step 3 into a fresh placed state, step 4;
    the same without a mesh for comparison."""
    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32")
    st = restore(ckpt, 3, fresh(cfg, mesh, seed=5))
    st, got = run(cfg, mesh, 1, state=st, start=3)
    plain = restore(ckpt, 3, fresh(cfg, seed=5))
    _, want = run(cfg, None, 1, state=plain, start=3)
    out.update(loss=got[0], loss_plain=want[0], step=int(gather(st["step"])))


def case_pod(mesh, out):
    """(2, 2, 2): dp_axes, and the sharded step's gradients (its rows of the
    batch, weighted by its share of the labels, summed over pod x data and
    cut to its shards) equal the full batch's; MoE under that split equals
    the unsharded step, and so does it on (1, 8), the batch unsplit."""
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(), dtype="float32")
    ms = mesh_shape(mesh)
    coords = dict(zip(ms.axis_names, mesh.get_coordinate()))
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    placed = place(state["params"], state_shardings(cfg, state, mesh)["params"])
    batch = batches(cfg, 1)[0]
    axes = batch_split_axes(cfg, batch, ms)
    fns = build_model(cfg)
    loss, _, grads = value_and_grad(fns, tree_map(local, placed), batch, sharded_split(cfg, mesh, placed, batch))
    want_loss, _, want = value_and_grad(fns, state["params"], batch)
    want = [place(w, s).to_local() for w, s in zip(want, leaves(state_shardings(cfg, state, mesh)["params"]))]
    with use_activation_mesh(mesh):
        tp, dp = axis_size("tp"), axis_size("dp")
    rows = int(split_batch(batch, axes, ms, coords)["tokens"].shape[0])
    out.update(dp_axes=list(dp_axes(mesh)), axes=list(axes), rows=rows, tp=tp, dp=dp,
               loss_rel=rel([float(loss)], [float(want_loss)]),
               grad_rel=max(float((g - w).abs().max() / w.abs().max().clamp(min=1e-30))
                            for g, w in zip(grads, want)))
    moe = dataclasses.replace(get_config("grok-1-314b").reduced(), dtype="float32")
    st, got = run(moe, mesh, 2)
    ref, want = run(moe, None, 2)
    out.update(moe_split=rel(got, want), moe_split_params=max_rel_leaf(st["params"], ref["params"]))
    flat = make_mesh((1, 8), ("data", "model"), "cpu")
    _, got = run(moe, flat, 2)
    _, want = run(moe, None, 2)
    out.update(moe_unsplit=got, moe_unsplit_ref=want, moe_unsplit_rel=rel(got, want))


if __name__ == "__main__":
    rank, world, store, case, mesh_dims, result = sys.argv[1:7]
    init_ranks(int(rank), int(world), store, "cpu")
    dims = tuple(int(x) for x in mesh_dims.split("x"))
    mesh = make_mesh(dims, ("data", "model") if len(dims) == 2 else ("pod", "data", "model"), "cpu")
    out = {}
    fn = globals()["case_" + case]
    fn(mesh, out, *sys.argv[7:])
    if int(rank) == 0:
        with open(result, "w") as f:
            json.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()
'''


def run_ranks(tmp_path, case, mesh, *extra, timeout=240, script_text=_RANK):
    """Runs ``case`` of ``script_text`` on one gloo rank a process over
    ``mesh`` ("2x4"); returns rank 0's results."""
    script = tmp_path / f"rank_{case}.py"
    script.write_text(script_text)
    world = 1
    for n in mesh.split("x"):
        world *= int(n)
    store, result = tmp_path / f"store_{case}", tmp_path / f"result_{case}.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, str(script), str(r), str(world), str(store), case, mesh,
                               str(result), *extra], env=env, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(world)]
    errs = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=timeout)
            if p.returncode != 0:
                errs.append(err[-3000:])
    finally:
        for p in procs:
            p.kill()
    assert not errs, errs[0]
    return json.loads(result.read_text())


def test_sharded_train_step_runs(tmp_path):
    """8 ranks over (data=2, model=4): each holds the reference's shard, the
    bf16 loss falls, and in f32 the step is the unsharded step's. Adafactor:
    the losses within 1e-6, and each step's update on the shards within
    1e-6 of the whole update from the same state and gradients (the
    products split over ``model`` sum their gradients in another order, so
    the two runs' gradients are not the same bits)."""
    out = run_ranks(tmp_path, "sharded_step", "2x4")
    assert out["bf16"][-1] < out["bf16"][0], out["bf16"]
    assert out["f32"][-1] < out["f32"][0]
    assert out["f32_rel"] <= 1e-5, (out["f32"], out["f32_ref"])
    assert out["params_rel"] <= 1e-5
    assert out["adafactor_rel"] <= 1e-6
    # reduced qwen3: embed (512, 128) over model, wq (L, 128, 128) over data x model
    assert out["local_shapes"] == {"head/embed": [128, 128], "layers/attn/wq": [2, 64, 32]}


def test_optimizers_update_shards(tmp_path):
    """8 ranks over (data=2, model=4): AdamW and SGD update each rank's
    shards elementwise and equal the whole update exactly; Adafactor sums
    its row and column statistics and its RMS over the ranks that split a
    leaf and equals it within 1e-6."""
    out = run_ranks(tmp_path, "sharded_optim", "2x4")
    assert out["adamw"] == 0.0 and out["sgd"] == 0.0, out
    assert out["adafactor"] <= 1e-6, out
    assert out["split_dims"] == {"experts": [1, 1, 0], "norm": [1], "stack": [0, 1, 1], "w": [1, 1]}


def test_elastic_remesh_resumes(tmp_path):
    """Save on (2, 4) with 8 ranks, restore on (1, 2) with 2: step 4 follows,
    its loss finite and the unsharded continuation's."""
    ckpt = str(tmp_path / "ckpt")
    first = run_ranks(tmp_path, "remesh", "2x4", ckpt)
    out = run_ranks(tmp_path, "resume", "1x2", ckpt)
    assert out["step"] == 4 and len(first["losses"]) == 3
    assert abs(out["loss"] - out["loss_plain"]) <= 1e-5 * abs(out["loss_plain"]), out


def test_multipod_gradient_reduction_over_pod_axis(tmp_path):
    """(pod=2, data=2, model=2): the batch splits over pod x data, one row a
    rank, and the reduced gradients are the full batch's. MoE under that
    split gives the unsharded step's losses and parameters within 1e-5, and
    so does it on (1, 8), where nothing splits the batch and each expert's
    hidden is cut over ``model`` (bit for bit on one rank:
    ``tests/test_torch_fsdp.py``)."""
    out = run_ranks(tmp_path, "pod", "2x2x2")
    assert out["dp_axes"] == ["pod", "data"] == out["axes"] and out["rows"] == 1
    assert out["tp"] == 2 and out["dp"] == 4
    assert out["loss_rel"] <= 1e-5 and out["grad_rel"] <= 1e-5, out
    assert out["moe_split"] <= 1e-5 and out["moe_split_params"] <= 1e-5, out
    assert out["moe_unsplit_rel"] <= 1e-5, out


def test_launcher_trains_on_a_mesh_and_re_meshes(tmp_path):
    """The CLI's ``--devices 8 --mesh 2x4`` on gloo ranks, then ``--devices 2
    --mesh 1x2`` resuming from its checkpoint (elastic re-mesh)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    base = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-1.7b", "--reduced", "--device",
            "cpu", "--seq-len", "32", "--global-batch", "4", "--ckpt-every", "2", "--ckpt-dir",
            str(tmp_path / "ckpt")]
    first = subprocess.run(base + ["--steps", "3", "--devices", "8", "--mesh", "2x4"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr[-3000:]
    assert "final_step=3" in first.stdout and "mesh=2x4" in first.stdout
    again = subprocess.run(base + ["--steps", "4", "--devices", "2", "--mesh", "1x2"], env=env, cwd=ROOT,
                           capture_output=True, text=True, timeout=300)
    assert again.returncode == 0, again.stderr[-3000:]
    assert "final_step=4" in again.stdout and "mesh=1x2" in again.stdout


def test_dryrun_cell_smoke():
    """The dry-run on small mesh descriptions at published width: every
    record ok, with dot FLOPs, collective bytes and per-device bytes."""
    for mesh in ("2x4", "2x2x2"):
        rec = dryrun.run_cell("qwen3-1.7b", "train_4k", mesh)
        assert rec["status"] == "ok", rec.get("error")
        assert rec["hlo_costs"]["dot_flops"] > 0
        assert sum(rec["hlo_costs"]["collective_bytes"].values()) > 0
        assert rec["mem"]["argument_bytes"] > 0 and rec["n_devices"] == 8
