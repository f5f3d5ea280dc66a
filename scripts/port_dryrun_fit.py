"""What would bring each dry-run cell that does not fit one H100 under its
80 GiB, by the dry-run's own count (``repro_torch.launch.dryrun``, on meta).

    PYTHONPATH=src python scripts/port_dryrun_fit.py [--arch qwen3-1.7b] \\
        [--meshes 16x16,2x16x16,1x1] [--out fit.jsonl]

For each cell whose argument + temp + output - alias exceeds 80 GiB, one
JSON line:

* ``peak_GiB``: the bytes by kind at the step's peak (``temp_breakdown``);
* train cells: ``microbatch``, the least ``REPRO_MICROBATCH`` (a divisor of
  the rank's rows, which the step splits evenly) under which the same count
  fits, and the total there; null where none does;
* prefill cells: ``prefill_calls``, the least number of calls the rank's
  rows split into under which one call's count fits, and its total;
* MoE cells: ``moe_buffer_GiB``, one layer's dispatch buffer as the step
  makes it (E x min(capacity, the rank's tokens) x d; E / model experts a
  rank where a train step splits them over ``model``) beside one sized to
  the rank's k x tokens assignments;
* ``state_alone``: true where the arguments and outputs alone exceed
  80 GiB, so that no split of the batch can help.
"""
from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import SHAPE_ORDER, SHAPES, ShapeSpec, cell_applicable
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import parse_mesh
from repro_torch.models.common import dtype_of
from repro_torch.models.layers import moe_capacity

GIB = 2**30


def total(mem) -> int:
    return mem["argument_bytes"] + mem["temp_bytes"] + mem["output_bytes"] - mem["alias_bytes"]


def least(options, fits):
    """The least of ``options`` (ascending) for which ``fits`` holds, by
    bisection (more splits hold less), with its value; (None, None)."""
    lo, hi, found = 0, len(options) - 1, (None, None)
    while lo <= hi:
        mid = (lo + hi) // 2
        ok, value = fits(options[mid])
        if ok:
            found, hi = (options[mid], value), mid - 1
        else:
            lo = mid + 1
    return found


def cell_fit(cfg, shape, ms, mem) -> dict:
    """The line of one cell whose dry-run record has ``mem``."""
    rec = {"arch": cfg.name, "shape": shape.name, "mesh": ms.name, "total_GiB": total(mem) / GIB,
           "peak_GiB": {k: v / GIB for k, v in mem["temp_breakdown"].items()}}
    rows = dryrun._local_batch(cfg, shape, ms)[0]
    fixed = mem["argument_bytes"] + mem["output_bytes"] - mem["alias_bytes"]
    rec["state_alone"] = fixed > dryrun.H100_BYTES
    if cfg.moe is not None and shape.kind != "decode":
        m, n = cfg.moe, rows * shape.seq_len
        n_dp = shape.global_batch // rows  # the ranks that split the batch (layers.moe_dispatch)
        cap = min(moe_capacity(m, n * n_dp), n) if n_dp > 1 else moe_capacity(m, n)
        item = dtype_of(cfg).itemsize
        split = shape.kind == "train" and m.num_experts % ms.shape["model"] == 0
        experts = m.num_experts // ms.shape["model"] if split else m.num_experts
        rec["moe_buffer_GiB"] = [experts * cap * cfg.d_model * item / GIB,
                                 m.top_k * n * cfg.d_model * item / GIB]
    divisors = [k for k in range(2, rows + 1) if rows % k == 0]
    if rec["state_alone"] or not divisors:
        return rec
    if shape.kind == "train":
        def fits(k):
            os.environ["REPRO_MICROBATCH"] = str(k)
            try:
                t = total(dryrun.build_cell(cfg, shape, ms).mem)
            finally:
                del os.environ["REPRO_MICROBATCH"]
            return t <= dryrun.H100_BYTES, t / GIB

        k, value = least(divisors, fits)
        rec.update(microbatch=k, microbatch_total_GiB=value)
    elif shape.kind == "prefill":
        def fits(k):
            t = total(dryrun.build_cell(cfg, ShapeSpec(shape.name, shape.seq_len, shape.global_batch // k,
                                                       shape.kind), ms).mem)
            return t <= dryrun.H100_BYTES, t / GIB

        k, value = least(divisors, fits)
        rec.update(prefill_calls=k, prefill_call_total_GiB=value)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None, help="arch id (default: all assigned)")
    ap.add_argument("--meshes", default=",".join(dryrun.MESHES))
    ap.add_argument("--out", default=None, help="append JSONL here")
    args = ap.parse_args(argv)
    for arch in [args.arch] if args.arch else list(ASSIGNED):
        cfg = get_config(arch)
        for mesh in args.meshes.split(","):
            for name in SHAPE_ORDER:
                shape = SHAPES[name]
                if not cell_applicable(cfg, shape)[0]:
                    continue
                ms = parse_mesh(mesh)
                mem = dryrun.build_cell(cfg, shape, ms).mem
                if total(mem) <= dryrun.H100_BYTES:
                    continue
                rec = cell_fit(cfg, shape, ms, mem)
                line = json.dumps(rec)
                print(line, flush=True)
                if args.out:
                    with open(args.out, "a") as f:
                        f.write(line + "\n")


if __name__ == "__main__":
    main()
