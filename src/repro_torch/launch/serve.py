"""Multi-model serving launcher: MSched-scheduled colocation on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        --archs qwen3-1.7b,llama3.2-3b --oversub 1.5 --requests 24

Counterpart of ``python -m repro.launch.serve``. Hosts several models under one
device-memory budget; the MSched coordinator proactively migrates each
model's working set on its slice. Runs on ``cuda`` unless ``--device cpu``;
``--full`` serves the published configs instead of the reduced ones, and
``--page-size`` sets the page size in bytes (2 MiB suits full width).
"""
import argparse
import time


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--archs", default="qwen3-1.7b,llama3.2-3b")
    ap.add_argument("--oversub", type=float, default=1.5)
    ap.add_argument("--requests", type=int, default=24)
    ap.add_argument("--wall-budget-s", type=float, default=20.0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--page-size", type=int, default=4096)
    args = ap.parse_args()

    from repro_torch.runtime.serve_loop import MultiModelServer, Request

    archs = args.archs.split(",")
    server = MultiModelServer(
        archs, device=args.device, full=args.full, page_size=args.page_size,
        oversub=args.oversub,
    )
    rt = server.runtime
    total = sum(t.footprint_bytes() for t in rt.tasks.values())
    budget = rt.pool.capacity * rt.page_size
    print(
        f"{len(archs)} models, aggregate {total/2**20:.1f} MiB, "
        f"budget {budget/2**20:.1f} MiB ({100*args.oversub:.0f}% oversubscription), "
        f"page {args.page_size} B on {args.device}"
    )
    t0 = time.perf_counter()
    for i in range(args.requests):
        server.submit(Request(model=i % len(archs), arrival_s=time.perf_counter()))
    stats = server.serve(wall_budget_s=args.wall_budget_s)
    for m in range(len(archs)):
        print(
            f"model {m} ({archs[m]}): served={stats.served[m]} "
            f"p99={1e3*stats.p99(m):.0f}ms"
        )
    print(
        f"migrated_in={stats.migrated_in_bytes/2**20:.1f}MiB "
        f"faults={stats.demand_faults} wall={time.perf_counter()-t0:.1f}s"
    )


if __name__ == "__main__":
    main()
