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
  updated in place (the train state, the decode cache); ``temp_bytes`` the
  most the step holds at once beside them, as the reference's
  ``temp_size_in_bytes``, and ``temp_breakdown`` those bytes by kind.
  The memory pass (``roofline/memory.py``) runs the step itself on meta
  over one rank's rows and counts each storage an op makes while it
  lives: for training ``make_sharded_train_step``'s step on rank 0
  (gradients, the clip norm, the optimizer; ``REPRO_MICROBATCH`` as the
  step reads it), its per-layer gathers, its parts of the products split
  over ``model`` and MoE's dispatch buffer included; for serving
  ``prefill`` and ``decode_step`` on the whole parameters (and, for
  decode, the rank's rows of the whole cache), whose gathered copies the
  ``gathers`` kind adds. The kernels count what their CUDA path allocates
  (outputs, flash attention's saved statistics, split-K workspaces), by
  their route rules at the H100's 132 SMs, not their plain versions'
  intermediates. ``fits_h100`` is argument + temp + output - alias within
  80 GiB. Not counted: what a kernel or library call allocates inside
  itself (a sort's scratch, NCCL's buffers) and the caching allocator's
  rounding (512 B a block, up to 1 MiB more for a large one).
* ``hlo_costs``: the port's counts (``roofline/costs.py``): the products'
  FLOPs of one device's step (rank 0's rows of the batch and its part of
  each product that ``model`` splits) and the collectives that step
  issues, the port's scheme, not XLA's. ``cost_analysis.flops_raw`` repeats the products'
  FLOPs; ``bytes_raw`` is null (nothing is compiled to report them).
* ``model``: the config's parameter counts.
"""
from __future__ import annotations

import argparse
import contextlib
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
from repro_torch.launch.steps import (
    _Split,
    abstract_train_state,
    make_prefill_step,
    make_serve_step,
    make_train_step,
    shard_step,
    value_and_grad,
)
from repro_torch.models import common
from repro_torch.models.common import SHAPES_ONLY
from repro_torch.models.model import build_model
from repro_torch.roofline import memory
from repro_torch.roofline.costs import Plan, depth_flops, dot_flops
from repro_torch.sharding import fsdp
from repro_torch.sharding import specs as sh
from repro_torch.tree import flatten, leaves, tree_map

MESHES = ("16x16", "2x16x16", "1x1")
H100_BYTES = 80 * 2**30  # the card's 80 GB of HBM


@dataclasses.dataclass
class Cell:
    """One (arch x shape) cell on one mesh: per-device bytes by kind, the
    collective plan, and ``count(cfg)``, the products' FLOPs of one
    device's step for ``cfg`` at any depth."""

    mesh: MeshShape
    rows: int  # the batch rows of one device's step
    mem: Dict[str, Any]
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


def _meta_axes(ms: MeshShape, sharding, ndim: int) -> fsdp.LeafAxes:
    """A leaf's cut as the sharded step sees it on rank 0 of ``ms``, with
    no process group: the memory pass's (``sharding.fsdp`` runs no
    collective on meta)."""
    return fsdp.LeafAxes(tuple(tuple(fsdp.Axis(a, None, ms.shape[a], 0) for a in sharding.axes(d)
                                     if ms.shape[a] > 1) for d in range(ndim)))


def _meta_split(cfg: ModelConfig, ms: MeshShape, batch_axes=()):
    """(the train state's shards on rank 0 of ``ms``, on meta; the
    ``_Split`` of its step, with no process group; the optimizer's
    ``LeafSplit`` a leaf, with axis names for groups), or None for the
    last two where nothing splits a leaf, the batch or ``model``."""
    state = abstract_train_state(cfg)
    shardings = sh.state_shardings(cfg, state, ms)
    shards = tree_map(lambda t, s: torch.empty(s.shard_shape(tuple(t.shape)), dtype=t.dtype, device="meta"),
                      state, shardings)
    cuts = [_meta_axes(ms, s, t.dim()) for t, s in zip(leaves(state["params"]), leaves(shardings["params"]))]
    axes = tuple(fsdp.Axis(a, None, ms.shape[a], 0) for a in batch_axes)
    if not axes and not any(c.split for c in cuts):
        return shards, None, None
    tp = fsdp.Axis("model", None, ms.shape["model"], 0) if ms.shape["model"] > 1 else None
    splits = [sh.LeafSplit(tuple(t.shape), tuple(tuple(a.name for a in d) for d in c.dims)) if c.split else None
              for t, c in zip(leaves(state["params"]), cuts)]
    return shards, _Split(tuple(cuts), axes, lambda b: b, tp), splits


def train_memory(cfg: ModelConfig, ms: MeshShape, batch, batch_axes=(), card: bool = True,
                 plan: "Plan | None" = None) -> memory.Count:
    """The memory pass of one rank's train step on ``ms`` over its ``batch``
    (on meta): ``make_sharded_train_step``'s step (``shard_step``;
    ``make_train_step``'s where nothing is split), under
    ``roofline.memory.count``, the kernels on their CUDA paths (``card``)
    or their plain versions. The state's shards and the batch are its
    arguments; the metrics (and the new ``step``) its outputs. With
    ``plan``, every collective the step issues is noted in it
    (``sharding.fsdp.recording``)."""
    shards, split, splits = _meta_split(cfg, ms, batch_axes)
    with fsdp.recording(plan) if plan is not None else contextlib.nullcontext():
        if split is None:
            return memory.count(make_train_step(cfg), shards, batch, card=card)[1]
        return memory.count(shard_step(cfg), shards, batch, split, splits, card=card)[1]


def build_cell(arch, shape, mesh, card: bool = True) -> Cell:
    """The cell of ``arch`` (a name or a ``ModelConfig``) at ``shape`` (a
    name in ``SHAPES`` or a ``ShapeSpec``) on ``mesh`` (a name such as
    ``"2x4"`` or a MeshShape). ``card=False`` counts the kernels' plain
    versions, as a CPU step runs them (its tests hold the count to one)."""
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
        held = train_memory(cfg, ms, batch, tuple(a for a in axes if ms.shape[a] > 1), card, plan)
        mem = {"state_bytes": state_bytes, "batch_bytes": batch_bytes, "argument_bytes": state_bytes + batch_bytes,
               "output_bytes": state_bytes + 16, "alias_bytes": state_bytes, "temp_bytes": held.peak,
               "temp_breakdown": held.breakdown}

        def count(c):
            shards, split, _ = _meta_split(c, ms, tuple(a for a in axes if ms.shape[a] > 1))
            return dot_flops(value_and_grad, build_model(c), shards["params"], batch, split)

        return Cell(ms, rows, mem, plan, count)

    fns = build_model(cfg)
    params = fns.init(SHAPES_ONLY)
    pspecs = sh.param_shardings(cfg, params, ms)
    param_bytes = _shard_bytes(params, pspecs)
    specs = dict(flatten(pspecs))
    gathered = sum(plan.gather(tuple(t.shape), t.dtype, specs[p]) for p, t in flatten(params))
    mem = {"param_bytes": param_bytes, "batch_bytes": batch_bytes}

    def serve_temp(step, *args):
        """temp_bytes and temp_breakdown: the gathered copies beside the
        memory pass of ``step`` on this rank's rows, its arguments whole."""
        held = memory.count(step, *args, card=card)[1]
        return {"temp_bytes": gathered + held.peak,
                "temp_breakdown": dict(held.breakdown, gathers=held.breakdown["gathers"] + gathered)}

    if shape.kind == "prefill":
        cache_bytes = _whole_bytes(fns.init_cache(rows, shape.seq_len, device="meta"))
        mem.update(argument_bytes=param_bytes + batch_bytes, output_bytes=logits_bytes + cache_bytes,
                   alias_bytes=0, **serve_temp(fns.prefill, params, batch))

        def count(c):
            return dot_flops(make_prefill_step(c), build_model(c).init(SHAPES_ONLY), batch)

        return Cell(ms, rows, mem, plan, count)

    # decode: one token against a seq_len-sized cache
    cache = fns.init_cache(shape.global_batch, shape.seq_len, device="meta")
    cspecs = dict(flatten(sh.cache_shardings(cfg, cache, ms, shape.global_batch)))
    cache_bytes = _shard_bytes(cache, sh.cache_shardings(cfg, cache, ms, shape.global_batch))
    for p, t in flatten(cache):
        if isinstance(t, torch.Tensor):
            gathered += plan.gather(tuple(t.shape), t.dtype, cspecs[p], keep_dims=(1,))  # this rank's rows
    mem.update(cache_bytes=cache_bytes, argument_bytes=param_bytes + cache_bytes + batch_bytes,
               output_bytes=logits_bytes + cache_bytes, alias_bytes=cache_bytes,
               **serve_temp(fns.decode_step, params, fns.init_cache(rows, shape.seq_len, "meta"), batch))

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
