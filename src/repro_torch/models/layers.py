"""Attention / MLP layers: init + apply, plain functions over params dicts.

Counterpart of the JAX package's ``models/layers.py`` for the dense family.
Init functions take a ``lead`` shape prefix so the model can draw every
layer's leaf at once in the stacked layout (leading ``L`` axis) that the JAX
package builds with ``vmap``. Every ``x @ W`` is the ``stream_matmul`` kernel
on a 2-D ``(B*S, K)`` view. MoE, M-RoPE and the KV-cache decode path are not
ported yet (ROADMAP.md).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
