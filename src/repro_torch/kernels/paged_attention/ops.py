"""Wrapper of the CUDA paged-KV decode attention (``csrc/paged_attention.cu``).

A CPU or meta tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. Under the dry-run's memory pass
(``roofline/memory.py``) a meta tensor takes the CUDA path instead, up to
the launch: it allocates what the launch would, by the same route rules,
and launches nothing. ``paged_attention.launches``
counts the wrapper's calls on the card: a call is one kernel launch when
:func:`pa_splits` gives one split, else two (the split kernel and the merge
of the splits). Head dims up to MAX_HEAD_DIM. The kernel has no backward: on
CUDA under grad, with q or a pool requiring grad, the call raises. With
``return_lse`` the same launches also write each row and head's
log-sum-exp (the sharded decode's merge over its sequence shards).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build, on_card, takes_plain
from repro_torch.kernels.paged_attention.ref import paged_attention_ref
from repro_torch.roofline import memory

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256
PA_BLOCKS_PER_SM = 2  # blocks of (row, KV head, run) the rule aims for on each SM
PA_MAX_SPLIT_PAGES = 64  # page ids one block holds (kMaxSplitPages)
_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def pa_splits(b: int, hkv: int, max_pages: int, sm_count: int) -> int:
    """How many runs of pages the kernel cuts each row's walk into: about
    PA_BLOCKS_PER_SM blocks of (row, KV head, run) on each SM, at most
    PA_MAX_SPLIT_PAGES pages a run, no more runs than pages. A rule of
    shapes only, never of the lengths: reading them would wait on the card,
    and the split count sets the merge order and with it the bits."""
    want = max(1, min(max_pages, -(-PA_BLOCKS_PER_SM * sm_count // (b * hkv))))
    per_split = min(-(-max_pages // want), PA_MAX_SPLIT_PAGES)
    return -(-max_pages // per_split)


def paged_attention(
    q: torch.Tensor,  # (B, H, D): one decode token per sequence
    pool_k: torch.Tensor,  # (n_pages, page_tokens, Hkv, D)
    pool_v: torch.Tensor,
    page_table: torch.Tensor,  # (B, max_pages) int32 pool indices
    lengths: torch.Tensor,  # (B,) int32 current sequence lengths
    *,
    sm_scale: Optional[float] = None,
    return_lse: bool = False,
):
    """Attention of each sequence's query over the first ``lengths[b]`` slots
    of its pages ``page_table[b]``; a row of length 0 gives zeros. Table
    entries must be valid pool indices: the kernel does not check them.
    With ``return_lse``, (out, lse): lse (B, H) f32, the natural log of the
    sum of exp(scale * q.k) over the valid slots, -inf for a row of length
    0."""
    tensors = (q, pool_k, pool_v, page_table, lengths)
    if takes_plain(*tensors):
        return paged_attention_ref(q, pool_k, pool_v, page_table, lengths, sm_scale=sm_scale, return_lse=return_lse)
    if not all(on_card(t) and t.device == q.device for t in tensors):
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, pool_k, pool_v)):
        raise RuntimeError("paged_attention has no backward on CUDA yet (ROADMAP.md §1); "
                           "call it under torch.no_grad() or on the CPU")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    max_pages = page_table.shape[1]
    splits = pa_splits(b, hkv, max_pages, _build.sm_count(q.device))
    out = torch.empty_like(q)
    work = torch.empty((b, h, splits, d + 2), dtype=torch.float32, device=q.device) if splits > 1 else None
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    if q.is_meta:  # the dry-run's memory pass: the launch's allocations, no launch
        memory.mark(work, "workspace")
        return (out, lse) if return_lse else out
    fn = _build.function("paged_attention", "paged_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), pool_k.data_ptr(), pool_v.data_ptr(), page_table.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), work.data_ptr() if work is not None else None,
        lse.data_ptr() if lse is not None else None, b, h, hkv, d, pt, max_pages, splits, scale,
        DTYPE_CODES[q.dtype], torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, "paged_attention")
    paged_attention.launches += 1
    return (out, lse) if return_lse else out


paged_attention.launches = 0
