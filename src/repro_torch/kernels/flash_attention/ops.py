"""Wrapper of the CUDA online-softmax attention (``csrc/flash_attention.cu``).

A CPU or meta tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. Under the dry-run's memory pass
(``roofline/memory.py``) a meta tensor takes the CUDA path instead, up to
the launch: it allocates what the launch would, by the same route rules,
and launches nothing. ``flash_attention.launches``
counts the kernel's launches, ``flash_attention.wgmma_launches`` those of
them that took the tensor-core route.

On CUDA, with grad mode on and q, k or v requiring grad, the call runs
inside an ``autograd.Function`` that saves q, k, v and the output, and, on
the wgmma route, each row's softmax statistics, which the forward then
writes beside the output (``lse2``, (B, H, Sq) f32, the convention of
``csrc/flash_attention_wgmma.cuh``); remat's replay writes them again. Its
backward is :func:`flash_attention_backward`, the hand-written kernels of
``csrc/flash_attention_bwd.cu``, counted once a call in
``flash_attention.bwd_launches`` and, on the tensor-core route, in
``flash_attention.bwd_wgmma_launches``. :func:`fa_bwd_route` picks the
route by the rule of the forward's: ``wgmma`` (a row pass for delta, then
dQ, then dK and dV, each a TMA-fed wgmma kernel reading the forward's
statistics, P and dS rounded to bf16 as product operands) or ``simt`` (f32
arithmetic, with its own pass for the statistics). Neither uses atomics, so
the bits depend on the shapes alone. Without grad the forward's launch,
route and bits are those of a call outside autograd, and it writes no
statistics.

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

from repro_torch.kernels import _build, on_card, takes_plain
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_backward
from repro_torch.roofline import memory

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256  # the simt route; the wgmma route takes WGMMA_HEAD_DIMS
WGMMA_HEAD_DIMS = (64, 128)
WGMMA_MIN_ROWS = 64  # folded rows (Sq x group heads): one consumer warpgroup's tile
ROUTE_CODES = {"simt": 0, "wgmma": 1}  # the C entry point's route argument
_ARGTYPES = (
    [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float]
    + [ctypes.c_int] * 5 + [ctypes.c_void_p]
)
_BWD_ARGTYPES = (
    [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_float] + [ctypes.c_int] * 5 + [ctypes.c_void_p]
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
    if takes_plain(q, k, v):
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=sm_scale)
    scale = _check(q, k, v, window, sm_scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale)


def _check(q, k, v, window, sm_scale) -> float:
    """Raises on what the CUDA kernels do not take; returns the scale."""
    if not all(on_card(t) and t.device == q.device for t in (q, k, v)):
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
    return sm_scale if sm_scale is not None else 1.0 / math.sqrt(d)


def fa_bwd_route(b: int, sq: int, skv: int, h: int, hkv: int, d: int, dtype: torch.dtype,
                 aligned: bool = True) -> str:
    """The kernel route of a backward call: the rule of :func:`fa_route`,
    with ``aligned`` covering q, k, v, the output and its gradient: "wgmma"
    for bf16 at head dim 64 or 128, Sq <= Skv and Sq x H / Hkv >= 64;
    "simt" otherwise."""
    return fa_route(b, sq, skv, h, hkv, d, dtype, aligned)


def _aligned(*tensors) -> bool:
    return all(t.data_ptr() % 16 == 0 for t in tensors)


def _check_lse(lse: torch.Tensor, q: torch.Tensor, what: str) -> None:
    """Raises unless ``lse`` is a contiguous (B, H, Sq) f32 buffer on q's
    device: the kernels read or write it through a raw pointer."""
    b, sq, h, _ = q.shape
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"{what}: statistics {tuple(lse.shape)} {lse.dtype} on {lse.device}, want "
                         f"({b}, {h}, {sq}) float32 on {q.device}")


def _forward(q, k, v, causal: bool, window: int, scale: float, lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One launch of the forward kernel on checked inputs; on the wgmma
    route, ``lse`` (a (B, H, Sq) f32 buffer) receives the rows'
    statistics."""
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    route = fa_route(b, sq, skv, h, hkv, d, q.dtype, _aligned(q, k, v))
    if lse is not None:
        if route != "wgmma":
            raise ValueError("flash_attention: only the wgmma route writes the rows' statistics")
        _check_lse(lse, q, "flash_attention")
    out = torch.empty_like(q)
    if out.is_meta:  # the dry-run's memory pass: the launch's allocations, no launch
        memory.mark((out, lse), "attention")
        return out
    fn = _build.function("flash_attention", "flash_attention", _ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, sq, skv, h, hkv, d, scale, int(causal), int(window), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], _build.sm_count(q.device),
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, f"flash_attention ({route})")
    flash_attention.launches += 1
    if route == "wgmma":
        flash_attention.wgmma_launches += 1
    return out


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with :func:`flash_attention_backward` as its
    gradient; on the wgmma route the forward also writes the rows'
    statistics, which the backward reads instead of recomputing them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        b, sq, h, d = q.shape
        lse = None
        if fa_route(b, sq, k.shape[1], h, k.shape[2], d, q.dtype, _aligned(q, k, v)) == "wgmma":
            lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
            out = _forward(q, k, v, causal, window, scale, lse)
        else:
            out = _forward(q, k, v, causal, window, scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.attrs = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, window, scale = ctx.attrs
        kw = dict(causal=causal, window=window, sm_scale=scale)
        if lse is not None:
            kw["lse"] = lse
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout.contiguous(), **kw)
        return dq, dk, dv, None, None, None


def flash_attention_backward(
    q: torch.Tensor,  # (B, Sq, H, D)
    k: torch.Tensor,  # (B, Skv, Hkv, D)
    v: torch.Tensor,  # (B, Skv, Hkv, D)
    out: torch.Tensor,  # (B, Sq, H, D), the forward's output
    dout: torch.Tensor,  # (B, Sq, H, D), its gradient
    *,
    lse: Optional[torch.Tensor] = None,  # (B, H, Sq) f32, the wgmma forward's statistics
    causal: bool = True,
    window: int = 0,
    sm_scale: Optional[float] = None,
):
    """(dq, dk, dv) of :func:`flash_attention` with the same masks, each in
    its input's dtype. A CPU tensor goes to the plain version; on CUDA one
    call of the C entry point on the route of :func:`fa_bwd_route`, counted
    in ``flash_attention.bwd_launches`` (and ``bwd_wgmma_launches``). ``lse``,
    the statistics the wgmma forward wrote for this call, spares the wgmma
    route a forward that rebuilds them, with the same bits; the simt route
    computes its own and ignores it."""
    tensors = (q, k, v, out, dout)
    if takes_plain(*tensors):
        return attention_ref_backward(q, k, v, dout, causal=causal, window=window, sm_scale=sm_scale)
    scale = _check(q, k, v, window, sm_scale)
    if not all(on_card(t) and t.device == q.device for t in (out, dout)):
        raise ValueError(f"flash_attention_backward: out on {out.device}, dout on {dout.device}")
    if out.shape != q.shape or dout.shape != q.shape or out.dtype != q.dtype or dout.dtype != q.dtype:
        raise ValueError(f"flash_attention_backward: out {tuple(out.shape)} {out.dtype}, dout "
                         f"{tuple(dout.shape)} {dout.dtype} for q {tuple(q.shape)} {q.dtype}")
    if not (out.is_contiguous() and dout.is_contiguous()):
        raise ValueError("flash_attention_backward: out and dout must be contiguous")
    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    route = fa_bwd_route(b, sq, skv, h, hkv, d, q.dtype, _aligned(*tensors))
    if route == "simt":
        lse = None
    elif lse is not None:
        _check_lse(lse, q, "flash_attention_backward")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # simt: row m, l, delta; wgmma: lse2 (unless given), delta
    work = torch.empty((3 if route == "simt" else 2, b * h * sq), dtype=torch.float32, device=q.device)
    if work.is_meta:
        memory.mark(work, "workspace")
        return dq, dk, dv
    fn = _build.function("flash_attention_bwd", "flash_attention_bwd", _BWD_ARGTYPES)
    err = fn(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), work.data_ptr(), None if lse is None else lse.data_ptr(),
        b, sq, skv, h, hkv, d, scale, int(causal), int(window), DTYPE_CODES[q.dtype],
        ROUTE_CODES[route], _build.sm_count(q.device), torch.cuda.current_stream(q.device).cuda_stream,
    )
    _build.check(err, f"flash_attention_backward ({route})")
    flash_attention.bwd_launches += 1
    if route == "wgmma":
        flash_attention.bwd_wgmma_launches += 1
    return dq, dk, dv


flash_attention.launches = 0
flash_attention.wgmma_launches = 0
flash_attention.bwd_launches = 0
flash_attention.bwd_wgmma_launches = 0
