"""Trace-driven serving demo on the PyTorch port's simulator, the counterpart
of ``examples/serve_trace.py``: replay a bursty request trace through the
dynamic simulator under UM (always-admit) vs MSched (working-set-aware
admission) and print the SLO scoreboard.

The simulator models a ``Platform`` (here ``RTX5080``, the paper's card) in
host Python and runs on no device, so this script takes no ``--device``: the
figures it prints are the model's for that platform.

Run: PYTHONPATH=src python examples/port_serve_trace.py [--arch qwen3-1.7b]
"""
import argparse
from typing import Dict, Mapping, Optional

from repro_torch.core.hardware import RTX5080
from repro_torch.core.scheduler import RoundRobinPolicy
from repro_torch.serving import (
    AlwaysAdmit,
    MSchedAdmission,
    ServeReport,
    SLOSpec,
    ServedRequestTask,
    bursty_trace,
    serve_trace,
)


def run(
    arch: str = "qwen3-1.7b",
    rate: float = 4.0,
    duration: float = 2.0,
    oversub: float = 1.5,
    seed: int = 0,
    telemetry: Optional[Mapping[str, object]] = None,
) -> Dict[str, ServeReport]:
    """Replays the trace under both backends and prints the scoreboard;
    returns each backend's ``ServeReport`` (``"um"``, ``"msched"``).
    ``telemetry`` maps a backend to the hub its run emits into."""
    telemetry = telemetry or {}
    trace = bursty_trace(
        rate, duration, seed=seed, cv=3.0,
        tenants=(arch,), prompt_mean=128, output_mean=16, max_output=32,
    )
    probe = ServedRequestTask(999, trace.requests[0], page_size=1 << 20)
    cap = int(3 * probe.footprint_bytes() / oversub)
    slo = SLOSpec(ttft_us=2_000_000.0, tpot_us=50_000.0)
    print(
        f"trace: {len(trace)} requests @ {trace.offered_rate_rps():.1f} rps, "
        f"tenant={arch}, HBM={cap / 2**30:.1f} GiB "
        f"({oversub:.1f}x oversubscribed at 3-way concurrency)"
    )
    reports = {}
    for backend, admission, quantum in (
        ("um", AlwaysAdmit(), 2_000.0),
        ("msched", MSchedAdmission(headroom=0.9), 350_000.0),
    ):
        rep = serve_trace(
            trace, RTX5080, backend=backend, capacity_bytes=cap,
            admission=admission, policy=RoundRobinPolicy(quantum),
            page_size=1 << 20, slo=slo, telemetry=telemetry.get(backend),
        )
        print(
            f"{backend:>7}: finished {rep.n_finished}/{rep.n_requests} "
            f"goodput={rep.goodput_per_s:.2f}/s "
            f"ttft_p99={rep.ttft_p99_us / 1e3:.0f}ms "
            f"tpot_p50={rep.tpot_p50_us / 1e3:.1f}ms "
            f"p99_latency={rep.latency_p99_us / 1e6:.2f}s "
            f"faults={rep.faults}"
        )
        reports[backend] = rep
    return reports


def main(argv=None) -> Dict[str, ServeReport]:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--rate", type=float, default=4.0)
    ap.add_argument("--duration", type=float, default=2.0)
    ap.add_argument("--oversub", type=float, default=1.5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    return run(args.arch, args.rate, args.duration, args.oversub, args.seed)


if __name__ == "__main__":
    main()
