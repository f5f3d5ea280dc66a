"""Wrapper of the CUDA paged-KV decode attention (``csrc/paged_attention.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``paged_attention.launches``
counts the kernel's launches.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.paged_attention.ref import paged_attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 128
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def paged_attention(
    q: torch.Tensor,  # (B, H, D): one decode token per sequence
    pool_k: torch.Tensor,  # (n_pages, page_tokens, Hkv, D)
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32 pool indices
    lengths: torch.Tensor,  # (B,) int32 current sequence lengths
    *,
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of each sequence's query over the first ``lengths[b]`` slots
    of its pages ``page_table[b]``; a row of length 0 gives zeros. Table
    entries must be valid pool indices: the kernel does not check them."""
    tensors = (q, pool_k, pool_v, page_table, lengths)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_attention_ref(q, pool_k, pool_v, page_table, lengths, sm_scale=sm_scale)
    if not all(t.is_cuda and t.device == q.device for t in tensors):
        raise ValueError(
            "paged_attention: q, pools, table and lengths on "
            + ", ".join(str(t.device) for t in tensors)
        )
    if q.dim() != 3 or pool_k.dim() != 4 or pool_k.shape != pool_v.shape:
        raise ValueError(f"paged_attention: shapes {tuple(q.shape)}, {tuple(pool_k.shape)}, {tuple(pool_v.shape)}")
    b, h, d = q.shape
    _, pt, hkv, kd = pool_k.shape
    if kd != d or h % hkv or not 0 < d <= MAX_HEAD_DIM or 0 in (b, h, pt, pool_k.shape[0]):
        raise ValueError(f"paged_attention: shapes {tuple(q.shape)}, {tuple(pool_k.shape)}")
    if page_table.dim() != 2 or page_table.shape[0] != b or page_table.shape[1] == 0:
        raise ValueError(f"paged_attention: page_table {tuple(page_table.shape)} for B={b}")
    if tuple(lengths.shape) != (b,):
        raise ValueError(f"paged_attention: lengths {tuple(lengths.shape)} for B={b}")
    if not (q.dtype == pool_k.dtype == pool_v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"paged_attention: dtypes {q.dtype}, {pool_k.dtype}, {pool_v.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError(f"paged_attention: page_table {page_table.dtype}, lengths {lengths.dtype}; need int32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention: every input must be contiguous")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    fn = _build.function("paged_attention", "paged_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, h, hkv, d, pt, page_table.shape[1], scale,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
