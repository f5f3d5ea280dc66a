"""Wrapper of the CUDA online-softmax attention (``csrc/flash_attention.cu``).

A CPU tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. ``flash_attention.launches``
counts the kernel's launches, ``flash_attention.wgmma_launches`` those of
them that took the tensor-core route.

The kernel replaces the JAX package's ``flash_attention``
(``src/repro/kernels/flash_attention/kernel.py:79``). At prefill it is bound
by the bf16 tensor-core rate; :func:`fa_route` sends those calls to the
``wgmma`` route (TMA-fed K/V tiles, wgmma for both products, P rounded to
bf16) and everything else (f32, the one-token live call, other head dims
up to MAX_HEAD_DIM, Sq > Skv) to the f32 ``simt`` route. The route is a rule
of dtype and shape, not a fallback: a route that fails raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # the simt route; the wgmma route takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_ROWS = 64  # folded rows (Sq x group heads): one consumer warpgroup's tile
ROUTE_CODES = {"simt": 0, "wgmma": 1}  # the C entry point's route argument
_ARGTYPES = (
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)


def fa_route(b: int, sq: int, skv: int, h: int, hkv: int, d: int, dtype: torch.dtype,
             aligned: bool = True) -> str:
    """The kernel route of an attention call: "wgmma" for bf16 with head dim
    64 or 128, Sq <= Skv (so that tile skipping holds) and at least 64 folded
    rows (Sq x H / Hkv), with q, k and v 16-byte aligned (``aligned``: TMA and
    16-byte loads); "simt" otherwise."""
    if (dtype == torch.bfloat16 and d in WGMMA_HEAD_DIMS and sq <= skv
            and sq * (h // hkv) >= WGMMA_MIN_ROWS and aligned):
        return "wgmma"
    return "simt"


def flash_attention(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    *,
    causal: bool = True,
    window: int = 0,  # 0 = unlimited
    sm_scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention of query i over keys j (positions 0..S-1 on both sides):
    causal keeps j <= i, a window keeps i - j < window."""
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    if not all(t.is_cuda and t.device == q.device for t in (q, k, v)):
        raise ValueError(f"flash_attention: q/k/v on {q.device}, {k.device}, {v.device}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4:
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    kb, skv, hkv, kd = k.shape
    if kb != b or kd != d or h % hkv or not 0 < d <= MAX_HEAD_DIM or 0 in (sq, skv):
        raise ValueError(f"flash_attention: shapes {tuple(q.shape)}, {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPE_CODES:
        raise TypeError(f"flash_attention: dtypes {q.dtype}, {k.dtype}, {v.dtype}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be contiguous")
    if window < 0:
        raise ValueError(f"flash_attention: window {window} < 0")
    scale = sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)
    route = fa_route(b, sq, skv, h, hkv, d, q.dtype, all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
    out = torch.empty_like(q)
    fn = _build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, sq, skv, h, hkv, d, scale, int(causal), int(window), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], _build.sm_count(q.device),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    if route == "wgmma":
        flash_attention.wgmma_launches += 1
    return out


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
