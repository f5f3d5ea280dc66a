"""Shared model building blocks: plain functions on tensors over a params dict.

Counterpart of the JAX package's ``models/common.py``. Initializers draw from
an explicit ``torch.Generator`` on the generator's device.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.flash_attention.ops import flash_attention


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is CUDA and there is
    no card, so nothing carries on on the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to run on the CPU")
    return dev


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    # int8 configs (paper llama.cpp workload) still compute in bf16; int8 is
    # the storage dtype handled by the quantized kernels / workload model.
    if cfg.dtype in ("bfloat16", "int8"):
        return torch.bfloat16
    return getattr(torch, cfg.dtype)


# --------------------------------------------------------------------------
# Initializers
# --------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...], dtype, fan_in: int):
    scale = 1.0 / math.sqrt(max(fan_in, 1))
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


def embed_init(gen: torch.Generator, shape: Tuple[int, ...], dtype):
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * 0.02).to(dtype)


# --------------------------------------------------------------------------
# Normalization
# --------------------------------------------------------------------------


def rms_norm(x, weight, eps: float):
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps)
    return (out * (1.0 + weight.float())).to(x.dtype)


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D); positions: (B, S) int32."""
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, x.device)  # (half,)
    angles = positions[..., None].float() * freqs  # (B, S, half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# Attention core (exact, memory-bounded via query-block loop)
# --------------------------------------------------------------------------


def gqa_scores_einsum(q, k):
    """q: (B, S, H, D), k: (B, T, Hkv, D) -> scores (B, H, S, T) for GQA."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    qg = q.reshape(b, s, hkv, h // hkv, d)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k)
    return scores.reshape(b, h, s, k.shape[1])


def gqa_values_einsum(probs, v):
    """probs: (B, H, S, T), v: (B, T, Hkv, D) -> (B, S, H, D)."""
    b, h, s, t = probs.shape
    hkv = v.shape[2]
    pg = probs.reshape(b, hkv, h // hkv, s, t)
    out = torch.einsum("bkgst,btkd->bskgd", pg, v)
    return out.reshape(b, s, h, out.shape[-1])


def masked_softmax(scores, mask):
    scores = scores.float()
    neg = torch.finfo(torch.float32).min
    scores = scores.masked_fill(~mask, neg)
    m = scores.amax(dim=-1, keepdim=True)
    e = torch.exp(scores - m)
    e = e.masked_fill(~mask, 0.0)
    return e / (e.sum(dim=-1, keepdim=True) + 1e-30)


def attend(
    q,
    k,
    v,
    *,
    q_positions=None,
    kv_positions=None,
    causal: bool,
    window: Optional[int] = None,
    scale: Optional[float] = None,
    q_block: int = 1024,
):
    """Exact attention. q: (B, Sq, H, D); k/v: (B, Skv, Hkv, D).

    q_positions: (B, Sq) int32; kv_positions: (B, Skv) int32 (-1 = invalid
    slot); ``None`` means 0..S-1 on that side, which is what ``forward``
    builds. On CUDA tensors this is the ``flash_attention`` kernel, which takes
    only those positions. On the CPU it is the plain version, which loops over
    query blocks when S_q is large so the (B, H, Sq, Skv) score tensor never
    materializes in full.
    """
    b, sq, h, d = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    if q.is_cuda:
        if q_positions is not None or kv_positions is not None:
            raise ValueError("attend on CUDA: the kernel takes positions 0..S-1 (pass None)")
        return flash_attention(q, k, v, causal=causal, window=window or 0, sm_scale=scale)
    if q_positions is None:
        q_positions = torch.arange(sq, dtype=torch.int32, device=q.device).expand(b, sq)
    if kv_positions is None:
        skv = k.shape[1]
        kv_positions = torch.arange(skv, dtype=torch.int32, device=q.device).expand(b, skv)

    def block(qb, qpos_b):
        scores = gqa_scores_einsum(qb * scale, k)  # (B, H, sb, Skv)
        valid = (kv_positions >= 0)[:, None, None, :]
        if causal:
            mask = qpos_b[:, None, :, None] >= kv_positions[:, None, None, :]
        else:
            mask = torch.ones((b, 1, qb.shape[1], kv_positions.shape[1]), dtype=torch.bool)
        if window is not None:
            near = (qpos_b[:, None, :, None] - kv_positions[:, None, None, :]) < window
            mask = mask & near
        mask = mask & valid
        probs = masked_softmax(scores, mask).to(v.dtype)
        return gqa_values_einsum(probs, v)

    if sq <= q_block:
        return block(q, q_positions)

    if sq % q_block:
        raise ValueError(f"attend: Sq={sq} is not a multiple of q_block={q_block}")
    outs = [
        block(q[:, i : i + q_block], q_positions[:, i : i + q_block])
        for i in range(0, sq, q_block)
    ]
    return torch.cat(outs, dim=1)
