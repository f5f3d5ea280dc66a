"""The paper's headline scenario on the PyTorch port, live: three model
instances time-share a device whose memory budget holds only half their
aggregate weights (200% oversubscription). MSched predicts each task's
working set from its command stream (template predictor), enforces
timeline-aligned OPT placement, and migrates real tensors between pinned host
memory and the card on every extended context switch. The same archs, seeds,
budget and slices as ``examples/multitask_oversubscription.py``.

    PYTHONPATH=src python examples/port_multitask_oversubscription.py [--device cpu]
"""
import argparse
import time

from repro_torch.core.runtime import LiveModelTask, LiveRuntime

ARCHS = ["qwen3-1.7b", "llama3.2-3b", "mamba2-1.3b"]


def run(device: str = "cuda"):
    tasks = [LiveModelTask(i, a, seed=i, device=device) for i, a in enumerate(ARCHS)]
    total = sum(t.footprint_bytes() for t in tasks)
    budget = int(total / 2.0)
    print(f"aggregate working set {total/2**20:.1f} MiB, device budget "
          f"{budget/2**20:.1f} MiB (200% oversubscription) on {device}")

    rt = LiveRuntime(tasks, budget, steps_per_slice=4)
    t0 = time.time()
    stats = rt.run(total_slices=9)  # 3 slices each, round robin
    dt = time.time() - t0

    print(f"steps per task: {stats.steps}")
    print(f"proactively migrated in : {stats.migrated_in_bytes/2**20:8.1f} MiB")
    print(f"evicted to host         : {stats.migrated_out_bytes/2**20:8.1f} MiB")
    print(f"demand faults (F- path) : {stats.demand_faults}")
    print(f"avg switch coordinator  : {1e3*sum(stats.switch_wall_s)/len(stats.switch_wall_s):.2f} ms"
          f"  (paper Fig. 11: <1 ms control plane @ GPU scale)")
    print(f"wall time: {dt:.1f}s")
    return stats


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    run(parser.parse_args(argv).device)


if __name__ == "__main__":
    main()
