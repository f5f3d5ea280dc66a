"""Kernel microbenchmarks of the port: the counterpart of the JAX package's
``benchmarks/kernels_bench.py``, with its four rows at its shapes.

    PYTHONPATH=src python -m repro_torch.kernels.bench [--device cpu]

prints ``name,us,derived`` rows. On the card each time is the mean of CUDA
events over ``REPS`` launches after a warm-up; on the CPU it is the wall time
of one call of the kernel's plain version, which says nothing of the card.
``derived`` gives ``h100_bound_us``, the least time one H100 SXM could take
(published peaks: 989 TFLOP/s bf16, 3.35 TB/s HBM) for the bytes each call
must move and the operations it does, and the device the time was taken on.
Inputs come from a ``torch.Generator`` seeded with ``SEED``.
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, List, Tuple

import torch

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streammm.ops import stream_matmul, stream_matmul_int8
from repro_torch.models.common import resolve_device

H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BYTES_PER_S = 3.35e12
SEED = 0
REPS = 20
# the JAX bench's shapes (benchmarks/kernels_bench.py)
MM_SHAPE = (256, 512, 256)  # M, K, N for both matmuls
INT8_BLOCK_K, INT8_SCALE = 128, 0.01
FA_SHAPE = (1, 512, 8, 2, 64)  # B, S, H, Hkv, D; causal
PA_SHAPE = (4, 8, 64, 32, 8)  # B, H, D, page tokens, pages a row; Hkv = 2
PA_LENGTH = 32 * 8 - 3

Row = Tuple[str, float, str]


def h100_bound_us(flops: float, nbytes: float) -> float:
    return max(flops / H100_PEAK_BF16_FLOPS, nbytes / H100_HBM_BYTES_PER_S) * 1e6


def timed(fn: Callable, device: torch.device) -> float:
    """Microseconds a call: CUDA events over REPS launches after a warm-up on
    the card, the wall time of one call on the CPU."""
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e6
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) * 1e3 / REPS


def emit(rows: List[Row]) -> None:
    for name, us, derived in rows:
        print(f"{name},{us:.1f},{derived}")


def run(device="cuda") -> List[Row]:
    dev = resolve_device(device)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    gen = torch.Generator(dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    def derived(flops, nbytes, shape):
        return f"h100_bound_us={h100_bound_us(flops, nbytes):.3f};shape={shape};device={where}"

    rows = []
    m, k, n = MM_SHAPE
    x, w = randn(m, k), randn(k, n)
    us = timed(lambda: stream_matmul(x, w), dev)
    fl = 2 * m * k * n
    rows.append(("kernel_streammm", us, derived(fl, 2 * (m * k + k * n + m * n), f"M{m}xK{k}xN{n}")))

    w_q = torch.randint(-127, 127, (k, n), generator=gen, device=dev, dtype=torch.int8)
    scales = torch.full((k // INT8_BLOCK_K, n), INT8_SCALE, dtype=torch.float32, device=dev)
    us = timed(lambda: stream_matmul_int8(x, w_q, scales, INT8_BLOCK_K), dev)
    by8 = 2 * m * k + k * n + 4 * scales.numel() + 2 * m * n
    rows.append(("kernel_streammm_int8", us, derived(fl, by8, f"M{m}xK{k}xN{n}xBK{INT8_BLOCK_K}")))

    b, s, h, hkv, d = FA_SHAPE
    q, kk, v = randn(b, s, h, d), randn(b, s, hkv, d), randn(b, s, hkv, d)
    us = timed(lambda: flash_attention(q, kk, v, causal=True), dev)
    fl = 2 * 2 * b * h * s * s * d * 0.5  # causal
    by = 2 * (2 * q.numel() + kk.numel() + v.numel())
    rows.append(("kernel_flash_attention", us, derived(fl, by, f"B{b}xS{s}xH{h}xHkv{hkv}xD{d}")))

    bb, hh, dd, pt, mp = PA_SHAPE
    pool_k = randn(bb * mp, pt, 2, dd)
    pool_v = pool_k  # as in the JAX bench
    qq = randn(bb, hh, dd)
    table = torch.arange(bb * mp, dtype=torch.int32, device=dev).reshape(bb, mp)
    lens = torch.full((bb,), PA_LENGTH, dtype=torch.int32, device=dev)
    us = timed(lambda: paged_attention(qq, pool_k, pool_v, table, lens), dev)
    by = 2 * (pool_k.numel() + pool_v.numel())
    fl = 2 * 2 * bb * hh * pt * mp * dd
    rows.append(("kernel_paged_attention", us,
                 derived(fl, by, f"B{bb}xH{hh}xHkv2xD{dd}xpt{pt}xpages{mp}xlen{PA_LENGTH}")))
    return rows


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    emit(run(ap.parse_args().device))


if __name__ == "__main__":
    main()
