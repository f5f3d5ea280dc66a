"""Times ``stream_matmul``'s gemv route (M <= 8) on the card at every GEMV
shape of ``chip_smoke.py``'s live, decode, hybrid and moe paths, beside its
bytes bound and ``torch.matmul`` (``torch.bmm`` for the expert-batched
products at a decode step), one JSON line a shape.

    python scripts/port_gemv_bench.py [--root DIR] [--sweep] [--out FILE]

``--root`` names the checkout whose ``chip_smoke.py`` and ``src/repro_torch``
are measured (default: this one), so that two trees can be timed in turns in
one session on one card: ``--root parent`` then the default, and again. A
tree whose ``stream_matmul`` takes no ``experts_hit`` gets the expert
products without it. ``--sweep`` also times each dense shape's gemv at K
splits of 1, 2, 4 and 8, and each decode expert product at those splits
over its bound's slots with 4, 6 and 8 experts hit, and at the rule's
splits over E slots (a wrapper with ``k_splits`` and ``experts_hit``
only): the data behind the split rule. Timing is ``chip_smoke.Bench``'s
(CUDA events, the L2 flushed, median of 15). Needs a CUDA card; imports
no JAX.
"""
from __future__ import annotations

import argparse
import inspect
import json
import subprocess
import sys
from pathlib import Path


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path[:0] = [str(root / "src"), str(root)]

    import torch

    if not torch.cuda.is_available():
        sys.exit("port_gemv_bench: no CUDA device")
    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.kernels.streammm import ops
    from repro_torch.models.layers import moe_dispatch

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    _build.build_all()
    bench = cs.Bench(torch, dev)
    gen = torch.Generator(dev).manual_seed(0)
    takes_hit = "experts_hit" in inspect.signature(ops.stream_matmul).parameters
    sm = _build.sm_count(dev)
    lines = []

    def emit(rec):
        rec = {"root": str(root), "card": card, **rec}
        lines.append(json.dumps(rec))
        print(lines[-1], flush=True)

    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32}
    shapes = cs.projection_shapes()
    seen = set()
    for path in ("serve", "decode", "hybrid", "moe"):
        for label, counts in shapes[path].items():
            for (m, k, n, layout, dt), calls in counts.items():
                if m > ops.GEMV_MAX_M or layout != "kn":
                    continue
                dtype = dtypes[dt]
                x = torch.randn((m, k), generator=gen, device=dev).to(dtype)
                w = (torch.randn((k, n), generator=gen, device=dev) / k ** 0.5).to(dtype)
                b, _ = cs.bound(x.element_size() * (m * k + k * n + m * n), 2 * m * k * n, dtype)
                rec = {"path": path, "label": label, "calls": calls, "M": m, "K": k, "N": n, "dtype": dt,
                       "bound_ms": b}
                if (m, k, n, dt) not in seen:  # the times of a shape once; its calls on every path
                    rec["ms"] = bench.ms(lambda: ops.stream_matmul(x, w, out_dtype=dtype))
                    rec["library_ms"] = bench.ms(lambda: torch.matmul(x, w))
                    if args.sweep:
                        out = torch.empty((m, n), dtype=dtype, device=dev)
                        rec["by_splits"] = {
                            s: bench.ms(lambda: ops._launch(x, w, out, None, 1, 1, m, n, k, "gemv", s, "kn", "mk"))
                            for s in (1, 2, 4, 8)}
                        rec["rule_splits"] = ops.k_splits(m, n, k, sm, elem=x.element_size())
                    seen.add((m, k, n, dt))
                emit(rec)
                del x, w
    for arch in cs.MOE_DEPTHS:
        c = cs.moe_config(arch)
        n_tokens = cs.DECODE_B
        rows = moe_dispatch(torch.randn((n_tokens, c.moe.num_experts), generator=gen, device=dev), c.moe).rows
        counts = rows.tolist()
        for (e, cap, k, n), calls in cs.step_experts(c, n_tokens).items():
            live = torch.arange(cap, device=dev) < rows[:, None].long()
            x = torch.randn((e, cap, k), generator=gen, device=dev).to(torch.bfloat16) * live[..., None]
            w = torch.empty((e, k, n), dtype=torch.bfloat16, device=dev).normal_(0.0, k ** -0.5, generator=gen)
            hit = min(e, c.moe.top_k * n_tokens)
            kw = {"rows": rows, **({"experts_hit": hit} if takes_hit else {})}
            filled, n_hit = sum(counts), sum(r > 0 for r in counts)
            b, _ = cs.bound(2 * (filled * k + n_hit * k * n + e * cap * n), 2 * filled * k * n, torch.bfloat16)
            rec = {"path": "moe", "label": f"{arch} decode experts", "calls": calls, "E": e, "C": cap, "K": k,
                   "N": n, "rows": filled, "experts_hit": n_hit, "bound_ms": b,
                   "ms": bench.ms(lambda: ops.stream_matmul(x, w, **kw)),
                   "library_ms": bench.ms(lambda: torch.bmm(x, w))}
            if args.sweep:
                out = torch.empty((e, cap, n), dtype=torch.bfloat16, device=dev)
                rec["rule_splits"] = ops.k_splits(cap, n, k, sm, experts=hit)
                rec["by_hit_splits"] = {}
                for h in (4, 6, 8):  # h experts hold one row each
                    some = torch.zeros_like(rows)
                    some[torch.randperm(e, generator=gen, device=dev)[:h]] = 1
                    rec["by_hit_splits"][h] = {
                        s: bench.ms(lambda: ops._launch(x, w, out, some, e, hit, cap, n, k, "gemv", s, "kn", "mk"))
                        for s in (1, 2, 4, 8)}
                s = ops.k_splits(cap, n, k, sm, experts=e)
                rec["all_slots"] = bench.ms(lambda: ops._launch(x, w, out, rows, e, e, cap, n, k, "gemv", s, "kn", "mk"))
            emit(rec)
            del x, w, live
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write("\n".join(lines) + "\n")


if __name__ == "__main__":
    main()
