"""Request trace generation and the replayable ``Trace`` format.

A trace is the serving-side input to the simulator: a time-ordered list of
requests, each with an arrival timestamp, a tenant (model arch), and sampled
prompt/output lengths. Three arrival processes cover the regimes the serving
literature sweeps:

  * ``poisson_trace``  — memoryless arrivals at a fixed rate (the classic
    open-loop load generator);
  * ``bursty_trace``   — Gamma-distributed inter-arrivals with a coefficient
    of variation > 1 (micro-bursts; production LLM traffic is bursty);
  * ``diurnal_trace``  — a sinusoidal rate profile replayed via Poisson
    thinning (a scaled day: peak/trough load in one window).

All generators are deterministic under a fixed seed (``random.Random``; no
global RNG state), and every trace round-trips through JSON so benchmark runs
are replayable byte-for-byte.

Copied from the JAX package's ``serving/traces.py`` with the imports
rewritten; the same inputs give the same decisions, events and counters.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple, Union

import random

DEFAULT_TENANT = "paper-llama3-8b"


@dataclasses.dataclass(frozen=True)
class Request:
    req_id: int
    tenant: str  # model arch served for this request
    arrival_us: float
    prompt_tokens: int
    output_tokens: int
    # SLO class: "rt" (real-time, shed last under degraded capacity) or
    # "be" (best-effort, shed first). Default keeps old traces replayable.
    slo_class: str = "be"


@dataclasses.dataclass
class Trace:
    requests: List[Request]
    meta: Dict[str, object] = dataclasses.field(default_factory=dict)

    def __len__(self) -> int:
        return len(self.requests)

    def __iter__(self):
        return iter(self.requests)

    def duration_us(self) -> float:
        return self.requests[-1].arrival_us if self.requests else 0.0

    def offered_rate_rps(self) -> float:
        d = self.duration_us()
        return len(self.requests) / (d * 1e-6) if d else 0.0

    def total_output_tokens(self) -> int:
        return sum(r.output_tokens for r in self.requests)

    # -- replayable serialization -------------------------------------------
    def to_json(self) -> str:
        return json.dumps(
            {
                "meta": self.meta,
                "requests": [dataclasses.asdict(r) for r in self.requests],
            },
            indent=2,
        )

    @classmethod
    def from_json(cls, text: str) -> "Trace":
        obj = json.loads(text)
        return cls(
            requests=[Request(**r) for r in obj.get("requests", [])],
            meta=obj.get("meta", {}),
        )

    def save(self, path: Union[str, Path]) -> None:
        Path(path).write_text(self.to_json() + "\n")

    @classmethod
    def load(cls, path: Union[str, Path]) -> "Trace":
        return cls.from_json(Path(path).read_text())


# --------------------------------------------------------------------------
# Length sampling
# --------------------------------------------------------------------------


def _sample_lengths(
    rnd: random.Random,
    prompt_mean: int,
    output_mean: int,
    max_prompt: int,
    max_output: int,
) -> Tuple[int, int]:
    """Lognormal prompts (long-tailed, like real chat prompts) and
    exponential-ish output lengths (decode-to-EOS is geometric)."""
    prompt = int(rnd.lognormvariate(math.log(max(prompt_mean, 1)), 0.6))
    output = int(rnd.expovariate(1.0 / max(output_mean, 1))) + 1
    return (
        max(1, min(prompt, max_prompt)),
        max(1, min(output, max_output)),
    )


def _finish(
    arrivals_us: List[float],
    rnd: random.Random,
    tenants: Sequence[str],
    prompt_mean: int,
    output_mean: int,
    max_prompt: int,
    max_output: int,
    meta: Dict[str, object],
    rt_fraction: float = 0.0,
) -> Trace:
    reqs = []
    for i, t_us in enumerate(arrivals_us):
        p, o = _sample_lengths(rnd, prompt_mean, output_mean, max_prompt, max_output)
        # draw the class only when classes are in play: the extra RNG pull
        # would otherwise shift every later length sample and break golden
        # pins on class-free traces
        klass = (
            "rt" if rt_fraction > 0.0 and rnd.random() < rt_fraction else "be"
        )
        reqs.append(
            Request(i, tenants[i % len(tenants)], t_us, p, o, klass)
        )
    return Trace(reqs, meta)


# --------------------------------------------------------------------------
# Arrival processes
# --------------------------------------------------------------------------


def poisson_trace(
    rate_rps: float,
    duration_s: float,
    seed: int = 0,
    tenants: Sequence[str] = (DEFAULT_TENANT,),
    prompt_mean: int = 256,
    output_mean: int = 32,
    max_prompt: int = 2048,
    max_output: int = 256,
    rt_fraction: float = 0.0,
) -> Trace:
    """Memoryless arrivals: exponential inter-arrival times at ``rate_rps``.
    ``rt_fraction`` tags that share of requests real-time ("rt" SLO class,
    protected by graceful degradation); 0 keeps the trace identical to
    class-free generation."""
    rnd = random.Random(seed)
    arrivals: List[float] = []
    t = 0.0
    horizon_us = duration_s * 1e6
    while True:
        t += rnd.expovariate(rate_rps) * 1e6
        if t >= horizon_us:
            break
        arrivals.append(t)
    return _finish(
        arrivals, rnd, tenants, prompt_mean, output_mean, max_prompt, max_output,
        {"process": "poisson", "rate_rps": rate_rps, "duration_s": duration_s,
         "seed": seed},
        rt_fraction=rt_fraction,
    )


def bursty_trace(
    rate_rps: float,
    duration_s: float,
    seed: int = 0,
    cv: float = 3.0,
    tenants: Sequence[str] = (DEFAULT_TENANT,),
    prompt_mean: int = 256,
    output_mean: int = 32,
    max_prompt: int = 2048,
    max_output: int = 256,
    rt_fraction: float = 0.0,
) -> Trace:
    """Gamma inter-arrivals with coefficient of variation ``cv`` (> 1 means
    burstier than Poisson at the same mean rate)."""
    assert cv > 0
    rnd = random.Random(seed)
    shape = 1.0 / (cv * cv)  # CV of Gamma(k, θ) is 1/sqrt(k)
    scale_us = (1.0 / rate_rps) / shape * 1e6  # mean = k·θ = 1/rate
    arrivals: List[float] = []
    t = 0.0
    horizon_us = duration_s * 1e6
    while True:
        t += rnd.gammavariate(shape, scale_us)
        if t >= horizon_us:
            break
        arrivals.append(t)
    return _finish(
        arrivals, rnd, tenants, prompt_mean, output_mean, max_prompt, max_output,
        {"process": "bursty", "rate_rps": rate_rps, "duration_s": duration_s,
         "cv": cv, "seed": seed},
        rt_fraction=rt_fraction,
    )


def diurnal_trace(
    mean_rate_rps: float,
    duration_s: float,
    seed: int = 0,
    amplitude: float = 0.8,
    period_s: Optional[float] = None,
    tenants: Sequence[str] = (DEFAULT_TENANT,),
    prompt_mean: int = 256,
    output_mean: int = 32,
    max_prompt: int = 2048,
    max_output: int = 256,
    rt_fraction: float = 0.0,
) -> Trace:
    """A scaled-day replay: sinusoidal rate profile
    ``rate(t) = mean·(1 + amplitude·sin(2πt/period))`` realized by thinning a
    Poisson process at the peak rate (so the output is a true inhomogeneous
    Poisson process)."""
    assert 0.0 <= amplitude < 1.0
    rnd = random.Random(seed)
    period_us = (period_s or duration_s) * 1e6
    peak = mean_rate_rps * (1.0 + amplitude)
    arrivals: List[float] = []
    t = 0.0
    horizon_us = duration_s * 1e6
    while True:
        t += rnd.expovariate(peak) * 1e6
        if t >= horizon_us:
            break
        rate = mean_rate_rps * (1.0 + amplitude * math.sin(2 * math.pi * t / period_us))
        if rnd.random() < rate / peak:  # thinning
            arrivals.append(t)
    return _finish(
        arrivals, rnd, tenants, prompt_mean, output_mean, max_prompt, max_output,
        {"process": "diurnal", "mean_rate_rps": mean_rate_rps,
         "duration_s": duration_s, "amplitude": amplitude,
         "period_s": period_s or duration_s, "seed": seed},
        rt_fraction=rt_fraction,
    )


GENERATORS = {
    "poisson": poisson_trace,
    "bursty": bursty_trace,
    "diurnal": diurnal_trace,
}
