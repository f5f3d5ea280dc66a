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
  the port's sharded scheme holds beside them as far as it can be stated:
  the gathered copies of leaves split over some axis (for training the
  parameters: the optimizer updates its state on the shards) and, for
  training, the whole gradients. Activations are not counted, so ``fits_h100``
  (argument + temp + output - alias within 80 GiB) is a necessary
  condition, not a sufficient one.
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
from typing import Any, Callable, Dict

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
        temp = 0
        for path, p in flatten(state["params"]):
            temp += plan.gather(tuple(p.shape), p.dtype, specs["params/" + path])
            temp += p.numel() * p.element_size()  # the whole gradient
            plan.all_reduce(4 * p.numel(), axes)  # reduced in f32
            if cfg.optimizer == "adafactor":
                _adafactor_reductions(plan, tuple(p.shape), specs["params/" + path])
        for _ in range(3):  # the label count, the loss and ce
            plan.all_reduce(4, axes)
        mem = {"state_bytes": state_bytes, "batch_bytes": batch_bytes, "argument_bytes": state_bytes + batch_bytes,
               "output_bytes": state_bytes + 16, "alias_bytes": state_bytes, "temp_bytes": temp}

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
