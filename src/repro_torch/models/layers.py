"""Attention / MLP layers: init + apply, plain functions over params dicts.

Counterpart of the JAX package's ``models/layers.py`` for the dense family.
Init functions take a ``lead`` shape prefix so the model can draw every
layer's leaf at once in the stacked layout (leading ``L`` axis) that the JAX
package builds with ``vmap``. Every ``x @ W`` is the ``stream_matmul`` kernel
on a 2-D ``(B*S, K)`` view; one-token decode reads the KV cache through the
``paged_attention`` kernel. MoE, M-RoPE and the ring/window caches of the
hybrid family are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streammm.ops import stream_matmul
from repro_torch.models import common
from repro_torch.models.common import apply_rope, attend, dense_init, rms_norm


def linear(x, w):
    """``x @ w`` over the last axis of x: (..., K) @ (K, N) -> (..., N)."""
    out = stream_matmul(x.reshape(-1, x.shape[-1]), w, out_dtype=x.dtype)
    return out.reshape(*x.shape[:-1], w.shape[-1])


# --------------------------------------------------------------------------
# Attention layer
# --------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    hd = cfg.resolved_head_dim()
    h, hkv = cfg.num_heads, cfg.num_kv_heads
    dt = common.dtype_of(cfg)
    dev = gen.device
    p = {
        "wq": dense_init(gen, (*lead, d, h * hd), dt, fan_in=d),
        "wk": dense_init(gen, (*lead, d, hkv * hd), dt, fan_in=d),
        "wv": dense_init(gen, (*lead, d, hkv * hd), dt, fan_in=d),
        "wo": dense_init(gen, (*lead, h * hd, d), dt, fan_in=h * hd),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros((*lead, h * hd), dtype=dt, device=dev)
        p["bk"] = torch.zeros((*lead, hkv * hd), dtype=dt, device=dev)
        p["bv"] = torch.zeros((*lead, hkv * hd), dtype=dt, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros((*lead, hd), dtype=torch.float32, device=dev)
        p["k_norm"] = torch.zeros((*lead, hd), dtype=torch.float32, device=dev)
    return p


def _project_qkv(p, x, cfg: ModelConfig, positions):
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim()
    q = linear(x, p["wq"])
    k = linear(x, p["wk"])
    v = linear(x, p["wv"])
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(b, s, cfg.num_heads, hd)
    k = k.reshape(b, s, cfg.num_kv_heads, hd)
    v = v.reshape(b, s, cfg.num_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    if cfg.causal:  # encoder (hubert) backbone: no rope on bidirectional attn
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_apply(p, x, cfg: ModelConfig, *, positions, window: Optional[int] = None):
    """Full-sequence attention. ``positions`` (B, S) must be 0..S-1 per row,
    as ``forward`` builds them: RoPE reads them, and ``attend`` masks for
    those positions. Returns (out, (k, v))."""
    q, k, v = _project_qkv(p, x, cfg, positions)
    out = attend(q, k, v, causal=cfg.causal, window=window)
    b, s, _, _ = out.shape
    return linear(out.reshape(b, s, -1), p["wo"]), (k, v)


def kv_page_tokens(smax: int) -> int:
    """Slots a page holds in the page-pool view of a cache of ``smax`` slots:
    the largest power of two <= 64 that divides it."""
    pt = 64
    while smax % pt:
        pt //= 2
    return pt


def kv_pages(index, batch: int, smax: int):
    """The page-pool view of a layer's cache of ``smax`` slots at decode
    position ``index`` (0-d int32 tensor): the write slot (a 1-element int64
    tensor), the page table (B, Smax / pt) int32, row b owning pages
    ``b * P .. b * P + P - 1`` of :func:`kv_page_tokens` slots, and the lengths
    ``index + 1`` (B,) int32. Every layer of a step shares it. Nothing here
    waits for the device."""
    n = smax // kv_page_tokens(smax)
    table = torch.arange(batch * n, dtype=torch.int32, device=index.device).reshape(batch, n)
    return index.reshape(1).long(), table, index.expand(batch) + 1


def attention_decode(
    p,
    x,
    cfg: ModelConfig,
    *,
    k_cache,
    v_cache,
    index,
    positions,
    window: Optional[int] = None,
    ring: bool = False,
    pages=None,
):
    """One-token decode against one layer's KV cache, updated in place.

    k_cache/v_cache: (B, Smax, Hkv, Dh); index: 0-d int32 tensor on their
    device (the current position, the same for every row); positions: (B, 1);
    pages: :func:`kv_pages` of ``index``, built here when not given.
    The JAX function is pure and returns new caches; this one writes k/v at
    slot ``index`` into ``k_cache``/``v_cache`` themselves, so that a step
    copies no cache, and returns them. Attention then views the cache as a
    pool of ``B * Smax / pt`` pages and reads the first ``index + 1`` slots of
    each row through ``paged_attention``. The caller checks ``index < Smax``
    (``decode_step`` does, on the host copy the cache carries); past it, the
    write's own bounds check fails (IndexError on the CPU, a device-side
    assertion on CUDA) where the reference's ``dynamic_update_slice`` clamps
    and overwrites the last slot. Ring buffers and windows (the hybrid family)
    are not ported yet.
    """
    if ring or window is not None:
        raise NotImplementedError(
            "attention_decode: ring and window caches come with the hybrid family (ROADMAP.md §1)"
        )
    q, k, v = _project_qkv(p, x, cfg, positions)
    b, smax, hkv, hd = k_cache.shape
    slot, table, lengths = pages if pages is not None else kv_pages(index, b, smax)
    k_cache.index_copy_(1, slot, k)
    v_cache.index_copy_(1, slot, v)
    pt = kv_page_tokens(smax)
    out = paged_attention(
        q.reshape(b, cfg.num_heads, hd),
        k_cache.view(b * smax // pt, pt, hkv, hd),
        v_cache.view(b * smax // pt, pt, hkv, hd),
        table,
        lengths,
    )
    return linear(out.reshape(b, 1, -1), p["wo"]), (k_cache, v_cache)


# --------------------------------------------------------------------------
# Dense (gated) MLP
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d, f = cfg.d_model, cfg.d_ff
    dt = common.dtype_of(cfg)
    return {
        "w1": dense_init(gen, (*lead, d, f), dt, fan_in=d),
        "w3": dense_init(gen, (*lead, d, f), dt, fan_in=d),
        "w2": dense_init(gen, (*lead, f, d), dt, fan_in=f),
    }


def mlp_apply(p, x):
    h = F.silu(linear(x, p["w1"]))
    h = h * linear(x, p["w3"])
    return linear(h, p["w2"])


# --------------------------------------------------------------------------
# Norm params
# --------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, lead: Tuple[int, ...] = (), device=None):
    return torch.zeros((*lead, cfg.d_model), dtype=torch.float32, device=device)
