"""Wrapper of the CUDA weight-streaming matmul (``csrc/streammm.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``stream_matmul.launches`` counts
the kernel's launches.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.streammm.ref import stream_matmul_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GEMV_MAX_M = 8  # rows of x the kernel's gemv path takes (kGemvMaxM)
GEMV_COLS = 256  # output columns per gemv block (kGemvCols)
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
_sm_count: Dict[int, int] = {}


def k_splits(m: int, n: int, k: int, sm_count: int) -> int:
    """How many K chunks the gemv path cuts a product into: enough blocks for
    about four per SM, each chunk at least 64 rows deep. 0 selects the tiled
    path (m > GEMV_MAX_M)."""
    if m > GEMV_MAX_M:
        return 0
    col_blocks = -(-n // GEMV_COLS)
    return max(1, min(-(-4 * sm_count // col_blocks), k // 64))


def stream_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.bfloat16) -> torch.Tensor:
    """``x @ w`` for x (M, K) and w (K, N) of one dtype, f32 accumulation,
    result in ``out_dtype`` (bfloat16 or float32)."""
    if x.device.type == "cpu" and w.device.type == "cpu":
        return stream_matmul_ref(x, w, out_dtype)
    if not (x.is_cuda and w.is_cuda and x.device == w.device):
        raise ValueError(f"stream_matmul: x on {x.device}, w on {w.device}")
    if x.dim() != 2 or w.dim() != 2 or x.shape[1] != w.shape[0] or 0 in (*x.shape, w.shape[1]):
        raise ValueError(f"stream_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)}")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"stream_matmul: dtypes {x.dtype} @ {w.dtype} -> {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stream_matmul: x and w must be contiguous")
    m, k = x.shape
    n = w.shape[1]
    dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
    if dev not in _sm_count:
        _sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
    splits = k_splits(m, n, k, _sm_count[dev])
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    work = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    fn = _build.function("streammm", "stream_matmul", _ARGTYPES)
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        m, n, k, splits, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, "stream_matmul")
    stream_matmul.launches += 1
    return out


stream_matmul.launches = 0
