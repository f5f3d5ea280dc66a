"""Cluster serving demo on the PyTorch port's cluster layer, the counterpart
of ``examples/cluster_serve.py``: one bursty multi-tenant trace over a
heterogeneous fleet, comparing placement policies — with inter-GPU
migration on the MSched-aware packer.

The cluster models its GPUs (``A100_40G`` / ``A100_80G`` and their links)
as ``Platform``s in host Python and runs on no device, so this script takes
no ``--device``: the figures it prints are the model's for that fleet.

Run: PYTHONPATH=src python examples/port_cluster_serve.py [--gpus 2] [--migrate]
"""
import argparse
from typing import Dict, Mapping, Optional

from repro_torch.cluster import ClusterReport, mixed, simulate_cluster
from repro_torch.core.hardware import A100_40G, A100_80G
from repro_torch.core.scheduler import RoundRobinPolicy
from repro_torch.serving import MSchedAdmission, SLOSpec, ServedRequestTask, bursty_trace

PLACEMENTS = ("roundrobin", "leastloaded", "msched")


def run(
    gpus: int = 2,
    rate: float = 2.0,
    duration: float = 4.0,
    oversub: float = 1.5,
    seed: int = 0,
    migrate: bool = False,
    telemetry: Optional[Mapping[str, object]] = None,
) -> Dict[str, ClusterReport]:
    """Replays the trace under each placement and prints the scoreboard;
    returns each placement's ``ClusterReport`` (``"roundrobin"``,
    ``"leastloaded"``, ``"msched"``). ``telemetry`` maps a placement to the
    hub its run emits into."""
    telemetry = telemetry or {}
    trace = bursty_trace(
        rate * gpus, duration, seed=seed, cv=4.0,
        tenants=("qwen3-1.7b",), prompt_mean=128, output_mean=64,
        max_output=128,
    )
    probe = ServedRequestTask(999, trace.requests[0], page_size=1 << 20)
    cap = int(3 * probe.footprint_bytes() / oversub)

    # heterogeneous fleet: alternating 1x/3x-capacity device classes; a
    # topology carries live link-contention state, so each run gets a fresh one
    def topology():
        return mixed([
            (A100_40G, cap // 2) if i % 2 == 0 else (A100_80G, 3 * cap // 2)
            for i in range(gpus)
        ])

    names = ", ".join(
        f"{g.name}={g.hbm_bytes / 2**30:.1f}GiB" for g in topology().gpus
    )
    slo = SLOSpec(ttft_us=3_000_000.0, tpot_us=100_000.0)
    print(
        f"trace: {len(trace)} requests @ {trace.offered_rate_rps():.1f} rps "
        f"over {gpus} GPUs ({names}), "
        f"{oversub:.1f}x oversubscribed at 3-way per-GPU concurrency"
    )
    reports = {}
    for placement in PLACEMENTS:
        rep = simulate_cluster(
            trace, topology(),
            backend="msched", placement=placement,
            admission_factory=lambda i: MSchedAdmission(headroom=0.9),
            policy_factory=lambda i: RoundRobinPolicy(350_000.0),
            page_size=1 << 20, slo=slo,
            rebalance_period_us=500_000.0 if migrate else None,
            telemetry=telemetry.get(placement),
        )
        moved = (
            f" migrations={len(rep.migrations)}" if migrate else ""
        )
        print(
            f"{placement:>12}: finished {rep.stats.n_finished}/"
            f"{rep.stats.n_requests} goodput={rep.stats.goodput_per_s:.2f}/s "
            f"ttft_p99={rep.stats.ttft_p99_us / 1e3:.0f}ms "
            f"placed={[g.placed for g in rep.per_gpu]}{moved}"
        )
        reports[placement] = rep
    return reports


def main(argv=None) -> Dict[str, ClusterReport]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--gpus", type=int, default=2)
    ap.add_argument("--rate", type=float, default=2.0, help="rps per GPU")
    ap.add_argument("--duration", type=float, default=4.0)
    ap.add_argument("--oversub", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--migrate", action="store_true",
                    help="enable periodic inter-GPU rebalancing")
    args = ap.parse_args(argv)
    return run(args.gpus, args.rate, args.duration, args.oversub, args.seed, args.migrate)


if __name__ == "__main__":
    main()
