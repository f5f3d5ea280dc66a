"""Multi-pod dry-run on the meta device, the counterpart of the JAX package's
``launch/dryrun.py``: every (arch x shape) cell on the production meshes,
with per-device bytes, products and collectives, nothing allocated.

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch llama3.2-3b] \\
        [--shapes train_4k,...] [--multi-pod | --both-meshes | --meshes 16x16,2x16x16,1x1] \\
        [--out dryrun.jsonl] [--list]

A cell's state or parameters, cache and batch are built on the meta device
(shapes and dtypes only) and placed by ``sharding.specs`` over a mesh
description (``launch.mesh.MeshShape``): no process group, no device. The
meshes are the reference's ``16x16`` and ``2x16x16`` and one more, ``1x1``,
the single H100 the port runs on. A record keeps the reference's fields:

* ``mem``: per device. ``argument_bytes`` the shards of the step's
  arguments (``state_bytes`` or ``param_bytes``, ``cache_bytes``,
  ``batch_bytes``); ``output_bytes`` its outputs and ``alias_bytes`` those
  updated in place (the train state, the decode cache); ``temp_bytes`` what
  the port's sharded scheme holds beside them as far as it can be stated.
  For training, the most the per-layer gathers hold at once
  (:func:`_fsdp_temp`): one layer's gathered leaves (one hybrid group's;
  outside remat, every layer's so far), the whole gradients one gather's
  backward receives, the gradient shards made so far, and the head's
  gathered leaves and whole gradients in their turn; the optimizer updates
  its state on the shards. MoE's dispatch buffer (under a batch split E x
  min(capacity, the rank's tokens) x d a layer) is an activation. For
  serving, the gathered copies of split leaves. Activations are not
  counted, so ``fits_h100`` (argument + temp + output - alias within 80
  GiB) is a necessary condition, not a sufficient one.
* ``hlo_costs``: the port's counts (``roofline/costs.py``): the products'
  FLOPs of one device's step (the rank's rows of the batch; ranks along
  ``model`` compute the same products) and the collectives of the port's
  scheme, not XLA's. ``cost_analysis.flops_raw`` repeats the products'
  FLOPs; ``bytes_raw`` is null (nothing is compiled to report them).
* ``model``: the config's parameter counts.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import SHAPE_ORDER, SHAPES, ModelConfig, ShapeSpec, cell_applicable
from repro_torch.launch.mesh import MeshShape, parse_mesh
from repro_torch.launch.specs import batch_spec
from repro_torch.launch.steps import abstract_train_state, make_prefill_step, make_serve_step, value_and_grad
from repro_torch.models import common
from repro_torch.models.common import SHAPES_ONLY
from repro_torch.models.model import build_model
from repro_torch.roofline.costs import Plan, depth_flops, dot_flops
from repro_torch.sharding import specs as sh
from repro_torch.tree import flatten

MESHES = ("16x16", "2x16x16", "1x1")
H100_BYTES = 80 * 2**30  # the card's 80 GB of HBM


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell on one mesh: per-device bytes by kind, the
    collective plan, and ``count(cfg)``, the products' FLOPs of one
    device's step for ``cfg`` at any depth."""

    mesh: MeshShape
    rows: int  # the batch rows of one device's step
    mem: Dict[str, int]
    plan: Plan
    count: Callable[[ModelConfig], int]


def _shard_bytes(tree, shardings) -> int:
    specs = dict(flatten(shardings))
    return sum(math.prod(specs[p].shard_shape(tuple(t.shape))) * t.element_size()
               for p, t in flatten(tree) if isinstance(t, torch.Tensor))


def _whole_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for _, t in flatten(tree) if isinstance(t, torch.Tensor))


def _local_batch(cfg: ModelConfig, shape: ShapeSpec, mesh: MeshShape):
    """(rows of one device's step, its batch on meta, the global batch's
    shard bytes, the axes that split it): the rows ``batch_shardings`` gives
    the first input, every input cut to them (``positions3`` along its dim
    1, as the sharded step cuts it)."""
    spec = batch_spec(cfg, shape)
    shardings = sh.batch_shardings(cfg, spec, mesh)
    first = next(iter(spec))
    n = shape.global_batch // shardings[first].shard_shape(spec[first][0])[0]
    local = {}
    for name, (shp, dtype) in spec.items():
        dim = 1 if name == "positions3" else 0
        shp = tuple(s // n if d == dim else s for d, s in enumerate(shp))
        local[name] = torch.empty(shp, dtype=dtype, device="meta")
    batch_bytes = sum(math.prod(shardings[k].shard_shape(shp)) * torch.empty((), dtype=dt).element_size()
                      for k, (shp, dt) in spec.items())
    axes = shardings[first].axes(0)
    return shape.global_batch // n, local, batch_bytes, axes


def _adafactor_reductions(plan: Plan, shape, sharding) -> None:
    """The all-reduces of Adafactor's update on the shards of one leaf
    (``optim.optimizers.adafactor`` with its ``LeafSplit``): for each (K, N)
    slice the row sums over the axes that split N, the column sums and the
    row statistic's mean over those that split K (the mean twice for a
    leaf of three or more axes, whose update takes u again), and the RMS
    over every axis that splits the leaf."""
    local = sharding.shard_shape(shape)
    every = [a for d in range(len(shape)) for a in sharding.axes(d)]
    if len(shape) >= 2:
        lead = math.prod(local[:-2])
        for _ in range(lead):
            plan.all_reduce(4 * local[-2], sharding.axes(len(shape) - 1))
            plan.all_reduce(4 * local[-1], sharding.axes(len(shape) - 2))
            for _ in range(2 if len(shape) >= 3 else 1):
                plan.all_reduce(4, sharding.axes(len(shape) - 2))
    plan.all_reduce(4, every)


@dataclasses.dataclass(frozen=True)
class _Leaf:
    """One leaf as one gather sees it (a layer of a stacked leaf): its shape,
    dtype and placement, whether the gather handles it (split, or the batch
    split), and ``key``, the local shard whose gradient it makes."""

    shape: tuple
    dtype: torch.dtype
    sharding: Any
    split: bool
    handled: bool
    key: tuple

    @property
    def whole(self) -> int:
        return math.prod(self.shape) * torch.empty((), dtype=self.dtype).element_size()

    @property
    def shard(self) -> int:
        return math.prod(self.sharding.shard_shape(self.shape)) * torch.empty((), dtype=self.dtype).element_size()


@dataclasses.dataclass(frozen=True)
class _Group:
    """One call of ``sharding.fsdp.gather`` in the sharded step's forward:
    ``kind`` "head" (the embedding, the LM head) or "layer" (a layer, a
    hybrid group or trailing layer), ``remat`` whether it runs under remat
    (its gathered leaves die with the call and the replay gathers them
    again), else kept for the backward."""

    kind: str
    remat: bool
    leaves: Tuple[_Leaf, ...]

    def total(self, what: str, only=None) -> int:
        return sum(getattr(leaf, what) for leaf in self.leaves if only is None or getattr(leaf, only))


def _gather_groups(cfg: ModelConfig, params, specs, ms: MeshShape, batch_axes, batch) -> list:
    """The sharded step's gathers in the order of the forward (``models/model.py``):
    the embedding where the inputs use it, each layer (a hybrid group of
    (rec, rec, attn), then its trailing recurrent layers outside remat),
    then the LM head's final norm with ``lm_head`` or, tied, ``embed`` again."""
    names = dict(flatten(params))

    def leaf(path, layer=None):
        t, s = names[path], specs["params/" + path]
        shape, spec = (tuple(t.shape), s.spec) if layer is None else (tuple(t.shape[1:]), s.spec[1:])
        sharding = sh.LeafSharding(ms, spec)
        split = any(ms.shape[a] > 1 for d in range(len(shape)) for a in sharding.axes(d))
        return _Leaf(shape, t.dtype, sharding, split, split or bool(batch_axes), (path, layer))

    def stack(prefix, i):
        return [leaf(p, i) for p in names if p.startswith(prefix + "/")]

    groups = []
    if cfg.family != "audio" or "frame_mask" in batch:
        groups.append(_Group("head", False, (leaf("head/embed"),)))
    if cfg.family == "hybrid":
        n_groups = cfg.num_layers // len(cfg.rglru.pattern)
        n_rec = sum(1 for k in cfg.layer_kinds() if k == "rec")
        for g in range(n_groups):
            groups.append(_Group("layer", cfg.remat, tuple(
                stack("rec_layers", 2 * g) + stack("rec_layers", 2 * g + 1) + stack("attn_layers", g))))
        for i in range(2 * n_groups, n_rec):
            groups.append(_Group("layer", False, tuple(stack("rec_layers", i))))
    else:
        for layer in range(cfg.num_layers):
            groups.append(_Group("layer", cfg.remat, tuple(stack("layers", layer))))
    head = "head/embed" if cfg.tie_embeddings else "head/lm_head"
    groups.append(_Group("head", False, (leaf("head/final_norm"), leaf(head))))
    return groups


def _fsdp_temp(groups) -> int:
    """The most the sharded step holds beside its arguments, by
    ``sharding.fsdp``'s gathers, at each gather's end and each gather
    backward's start and end: the gathered leaves (a group under remat only
    during its call and its replay; one outside remat until its backward),
    the whole gradients a gather backward receives, and the gradient shards
    made so far (a shard a local tensor: the tied head's two gathers of
    ``embed`` make one). The backward runs the groups in reverse; a group's
    gathered leaves are gone when its backward starts (their last user has
    run). Not counted: activations; the shards stacked into a stacked
    leaf's gradient beside themselves for a moment; within a layer's
    backward, a leaf both gathered and whole for the op that computes its
    gradient; and, outside remat, that leaves no op saves (norms, biases)
    die before the backward: so trailing layers are counted whole."""
    peak = kept = 0
    for g in groups:
        if g.kind == "layer" and not g.remat:
            kept += g.total("whole", "split")
            peak = max(peak, kept)
        else:
            peak = max(peak, kept + g.total("whole", "split"))
    held, seen = 0, set()
    for g in reversed(groups):
        if g.kind == "layer":
            if g.remat:
                peak = max(peak, g.total("whole", "split") + held)
            else:
                kept -= g.total("whole", "split")
        whole = g.total("whole", "handled")
        peak = max(peak, kept + whole + held)
        for leaf in g.leaves:
            if leaf.key not in seen:
                seen.add(leaf.key)
                held += leaf.shard
        peak = max(peak, kept + whole + held)
    return peak


def _gradient_reduction(plan: Plan, leaf: _Leaf, batch_axes) -> None:
    """The collectives of ``sharding.fsdp.reduce_leaf`` on one leaf's whole
    gradient: the slices over axes that split only the leaf first, a
    reduce-scatter over each batch axis that splits it, an all-reduce of
    the shard over each that does not."""
    sizes = plan.sizes
    dims = [[a for a in leaf.sharding.axes(d) if sizes[a] > 1] for d in range(len(leaf.shape))]
    itemsize = torch.empty((), dtype=leaf.dtype).element_size()
    cur = list(leaf.shape)
    for d in sorted(range(len(cur)), key=lambda d: any(a in batch_axes for a in dims[d])):
        for a in dims[d]:
            before = math.prod(cur) * itemsize
            cur[d] //= sizes[a]
            if a in batch_axes:
                plan.reduce_scatter(before, math.prod(cur) * itemsize)
    own = {a for on in dims for a in on}
    plan.all_reduce(math.prod(cur) * itemsize, [a for a in batch_axes if a not in own])


def _moe_collectives(plan: Plan, cfg: ModelConfig, batch_axes) -> None:
    """MoE under a batch split, each layer: the (k, E) int32 count table
    all-gathered over the dp group (``layers.moe_dispatch``) and the
    load-balance term's two (E,) f32 sums all-reduced, each again in
    remat's replay, and the gradient of the router probabilities' sum
    all-reduced in the backward."""
    m = cfg.moe
    runs = 1 + cfg.remat
    for _ in range(cfg.num_layers):
        for _ in range(runs):
            held = 4 * m.top_k * m.num_experts
            for a in reversed(batch_axes):  # minor first
                plan.all_gather((plan.sizes[a] - 1) * held)
                held *= plan.sizes[a]
            for _ in range(2):
                plan.all_reduce(4 * m.num_experts, batch_axes)
        plan.all_reduce(4 * m.num_experts, batch_axes)


def build_cell(arch, shape, mesh) -> Cell:
    """The cell of ``arch`` (a name or a ``ModelConfig``) at ``shape`` (a
    name in ``SHAPES`` or a ``ShapeSpec``) on ``mesh`` (a name such as
    ``"2x4"`` or a MeshShape)."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    ms = mesh if isinstance(mesh, MeshShape) else parse_mesh(mesh)
    rows, batch, batch_bytes, axes = _local_batch(cfg, shape, ms)
    plan = Plan(ms)
    itemsize = torch.empty((), dtype=common.dtype_of(cfg)).element_size()
    logits_bytes = rows * cfg.vocab_size * itemsize  # (rows, 1, V) for prefill and decode

    if shape.kind == "train":
        state = abstract_train_state(cfg)
        shardings = sh.state_shardings(cfg, state, ms)
        state_bytes = _shard_bytes(state, shardings)
        specs = dict(flatten(shardings))
        batch_axes = tuple(a for a in axes if ms.shape[a] > 1)
        groups = _gather_groups(cfg, state["params"], specs, ms, batch_axes, batch)
        for g in groups:
            for leaf in g.leaves:
                if leaf.handled:
                    for _ in range(2 if g.remat else 1):  # remat's replay gathers the layer again
                        plan.gather(leaf.shape, leaf.dtype, leaf.sharding)
                    _gradient_reduction(plan, leaf, batch_axes)
        for path, p in flatten(state["params"]):
            split = [a for d in range(p.dim()) for a in specs["params/" + path].axes(d) if ms.shape[a] > 1]
            for a in split:  # grad_norm: the shard's sum of squares over the ranks that split it
                plan.all_reduce(4, (a,))
            if cfg.optimizer == "adafactor":
                _adafactor_reductions(plan, tuple(p.shape), specs["params/" + path])
        if cfg.moe is not None and batch_axes:
            _moe_collectives(plan, cfg, batch_axes)
        for _ in range(3):  # the label count, the loss and ce
            plan.all_reduce(4, axes)
        mem = {"state_bytes": state_bytes, "batch_bytes": batch_bytes, "argument_bytes": state_bytes + batch_bytes,
               "output_bytes": state_bytes + 16, "alias_bytes": state_bytes, "temp_bytes": _fsdp_temp(groups)}

        def count(c):
            return dot_flops(value_and_grad, build_model(c), abstract_train_state(c)["params"], batch)

        return Cell(ms, rows, mem, plan, count)

    params = build_model(cfg).init(SHAPES_ONLY)
    pspecs = sh.param_shardings(cfg, params, ms)
    param_bytes = _shard_bytes(params, pspecs)
    specs = dict(flatten(pspecs))
    temp = sum(plan.gather(tuple(t.shape), t.dtype, specs[p]) for p, t in flatten(params))
    mem = {"param_bytes": param_bytes, "batch_bytes": batch_bytes}

    if shape.kind == "prefill":
        cache_bytes = _whole_bytes(build_model(cfg).init_cache(rows, shape.seq_len, device="meta"))
        mem.update(argument_bytes=param_bytes + batch_bytes, output_bytes=logits_bytes + cache_bytes,
                   alias_bytes=0, temp_bytes=temp)

        def count(c):
            return dot_flops(make_prefill_step(c), build_model(c).init(SHAPES_ONLY), batch)

        return Cell(ms, rows, mem, plan, count)

    # decode: one token against a seq_len-sized cache
    cache = build_model(cfg).init_cache(shape.global_batch, shape.seq_len, device="meta")
    cspecs = dict(flatten(sh.cache_shardings(cfg, cache, ms, shape.global_batch)))
    cache_bytes = _shard_bytes(cache, sh.cache_shardings(cfg, cache, ms, shape.global_batch))
    for p, t in flatten(cache):
        if isinstance(t, torch.Tensor):
            temp += plan.gather(tuple(t.shape), t.dtype, cspecs[p], keep_dims=(1,))  # this rank's rows
    mem.update(cache_bytes=cache_bytes, argument_bytes=param_bytes + cache_bytes + batch_bytes,
               output_bytes=logits_bytes + cache_bytes, alias_bytes=cache_bytes, temp_bytes=temp)

    def count(c):
        fns = build_model(c)
        return dot_flops(make_serve_step(c), fns.init(SHAPES_ONLY), fns.init_cache(rows, shape.seq_len, "meta"),
                         batch)

    return Cell(ms, rows, mem, plan, count)


def run_cell(arch: str, shape_name: str, mesh="16x16") -> dict:
    """The record of one cell on ``mesh`` (a name such as ``"2x4"``, a
    ``MeshShape``, or a bool: the reference's ``multi_pod``)."""
    if isinstance(mesh, bool):
        mesh = "2x16x16" if mesh else "16x16"
    ms = mesh if isinstance(mesh, MeshShape) else parse_mesh(mesh)
    rec: Dict[str, Any] = {"arch": arch, "shape": shape_name, "mesh": ms.name,
                           "multi_pod": "pod" in ms.axis_names}
    cfg = get_config(arch)
    ok, reason = cell_applicable(cfg, SHAPES[shape_name])
    if not ok:
        rec.update(status="skipped", skip_reason=reason)
        return rec
    try:
        t0 = time.perf_counter()
        cell = build_cell(arch, shape_name, ms)
        t_build = time.perf_counter() - t0
        t0 = time.perf_counter()
        flops = depth_flops(cfg, cell.count)
        t_count = time.perf_counter() - t0
        costs = cell.plan.costs(flops)
        mem = cell.mem
        rec.update(
            status="ok",
            build_s=round(t_build, 2),
            count_s=round(t_count, 2),
            n_devices=ms.size,
            rows_per_device=cell.rows,
            mem=mem,
            fits_h100=mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
            <= H100_BYTES,
            cost_analysis={"flops_raw": float(flops), "bytes_raw": None},
            hlo_costs={
                "dot_flops": costs.dot_flops,
                "collective_bytes": costs.collective_bytes,
                "collective_counts": costs.collective_counts,
                "while_loops": costs.while_loops,
            },
            model={"param_count": cfg.param_count(), "active_param_count": cfg.active_param_count()},
        )
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id (default: all assigned)")
    ap.add_argument("--shapes", default=None, help="comma-separated shape names")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--meshes", default=None, help=f"comma-separated mesh names, e.g. {','.join(MESHES)}")
    ap.add_argument("--out", default=None, help="append JSONL here")
    ap.add_argument("--list", action="store_true")
    args = ap.parse_args(argv)

    if args.list:
        for a in ASSIGNED:
            print(a)
        return []

    archs = [args.arch] if args.arch else list(ASSIGNED)
    shapes = args.shapes.split(",") if args.shapes else list(SHAPE_ORDER)
    if args.meshes:
        meshes = args.meshes.split(",")
    else:
        meshes = ["16x16", "2x16x16"] if args.both_meshes else ["2x16x16" if args.multi_pod else "16x16"]

    records = []
    for arch in archs:
        for mesh in meshes:
            for shape_name in shapes:
                rec = run_cell(arch, shape_name, mesh)
                records.append(rec)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(json.dumps(rec) + "\n")
                brief = {k: rec.get(k) for k in ("arch", "shape", "mesh", "status", "count_s")}
                if rec.get("status") == "ok":
                    brief["temp_GiB"] = round(rec["mem"]["temp_bytes"] / 2**30, 2)
                    brief["arg_GiB"] = round(rec["mem"]["argument_bytes"] / 2**30, 2)
                    brief["fits_h100"] = rec["fits_h100"]
                if rec.get("status") == "error":
                    brief["error"] = rec["error"][:200]
                print(json.dumps(brief), flush=True)
    return records


if __name__ == "__main__":
    main()
