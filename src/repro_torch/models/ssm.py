"""Mamba2 / SSD (state-space duality) block: chunked parallel form + decode.

Counterpart of the JAX package's ``models/ssm.py`` (arXiv:2405.21060):
within-chunk quadratic ("attention-like") term + across-chunk recurrent state
passing, single group (B/C shared across heads), depthwise causal conv over
(x, B, C). ``in_proj`` and ``out_proj`` go through ``layers.linear``, so
through the ``stream_matmul`` kernel on the card; the scan itself is plain
PyTorch in f32, as the JAX package computes it outside any Pallas kernel.
Init functions take a ``lead`` shape prefix for the stacked-layer layout.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.layers import linear


def dims(cfg: ModelConfig):
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_dim = d_inner + 2 * s.state_dim
    return d_inner, n_heads, conv_dim


def init_ssm(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    s = cfg.ssm
    d = cfg.d_model
    d_inner, n_heads, conv_dim = dims(cfg)
    dt = common.dtype_of(cfg)
    dev = gen.device
    proj_out = 2 * d_inner + 2 * s.state_dim + n_heads  # z, x, B, C, dt
    return {
        "in_proj": dense_init(gen, (*lead, d, proj_out), dt, fan_in=d),
        "conv_w": dense_init(gen, (*lead, s.conv_width, conv_dim), dt, fan_in=s.conv_width),
        "conv_b": torch.zeros((*lead, conv_dim), dtype=dt, device=dev),
        "A_log": torch.zeros((*lead, n_heads), dtype=torch.float32, device=dev),
        "D": torch.ones((*lead, n_heads), dtype=torch.float32, device=dev),
        "dt_bias": torch.zeros((*lead, n_heads), dtype=torch.float32, device=dev),
        "gate_norm": torch.zeros((*lead, d_inner), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, (*lead, d_inner, d), dt, fan_in=d_inner),
    }


def _split_proj(proj, cfg: ModelConfig):
    d_inner, n_heads, conv_dim = dims(cfg)
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : d_inner + conv_dim]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _silu(x):
    """``x * sigmoid(x)`` as the JAX package's ``jax.nn.silu`` computes it on
    the CPU: XLA expands the sigmoid into ``1 / (1 + exp(-x))`` and rounds
    every op to x's dtype. In bf16 ``F.silu``, which rounds once, differs
    from it in 40% of the places."""
    return x * (1 / (1 + torch.exp(-x)))


def _causal_conv(xbc, w, b):
    """Depthwise causal conv along S. xbc: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = torch.zeros_like(xbc)
    for i in range(width):  # width is tiny (4); unrolled taps
        out = out + pad[:, i : i + xbc.shape[1], :] * w[i]
    return out + b


def ssm_apply(p, x, cfg: ModelConfig):
    out, _ = _ssm_core(p, x, cfg)
    return out


def ssm_apply_with_state(p, x, cfg: ModelConfig):
    """Like ``ssm_apply`` but also returns the decode-continuation cache
    {'state': (B,H,hd,ns) f32, 'conv': (B,width-1,conv_dim)}."""
    return _ssm_core(p, x, cfg)


def _ssm_core(p, x, cfg: ModelConfig):
    """Full-sequence SSD. x: (B, S, D) -> (B, S, D), any S.

    The reference pads x to a chunk multiple before ``in_proj``; this
    projects the S valid rows and pads ``proj`` with zero rows, which gives
    the same values: padded rows of x are zero, ``in_proj`` has no bias,
    their ``dt`` is masked to 0 (they neither decay nor update the carried
    state) and their outputs are cut. ``out_proj`` likewise sees the valid
    rows only. The scan runs over whole chunks, one Python step a chunk,
    carrying the inter-chunk state, so only one chunk's (B, Q, Q, H) decay
    tensor is live at a time.
    """
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    hd, ns, q = s_cfg.head_dim, s_cfg.state_dim, s_cfg.chunk
    b, s_orig, _ = x.shape
    pad = (-s_orig) % q
    s = s_orig + pad
    nc = s // q

    proj = linear(x, p["in_proj"])
    if pad:
        proj = F.pad(proj, (0, 0, 0, pad))
    z, xbc_raw, dt = _split_proj(proj, cfg)
    conv_tail = xbc_raw[:, :s_orig, :][:, -(s_cfg.conv_width - 1) :, :]
    xbc = _silu(_causal_conv(xbc_raw, p["conv_w"], p["conv_b"]))
    xs = xbc[..., :d_inner]
    Bm = xbc[..., d_inner : d_inner + ns].float()
    Cm = xbc[..., d_inner + ns :].float()

    dt = F.softplus(dt.float() + p["dt_bias"])  # (B,S,H)
    if pad:
        valid = (torch.arange(s, device=x.device) < s_orig)[None, :, None]
        dt = torch.where(valid, dt, 0.0)
    A = -torch.exp(p["A_log"])  # (H,)
    dA = dt * A  # (B,S,H)
    xh = xs.reshape(b, s, n_heads, hd).float()

    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    state = torch.zeros((b, n_heads, hd, ns), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        sl = slice(c * q, (c + 1) * q)
        dac, dtk, xk, bk, ck = dA[:, sl], dt[:, sl], xh[:, sl], Bm[:, sl], Cm[:, sl]
        cum = torch.cumsum(dac, dim=1)  # (B,Q,H) inclusive
        # intra-chunk: M[i,j] = exp(cum_i - cum_j) for i >= j
        diff = cum[:, :, None, :] - cum[:, None, :, :]  # (B,Qi,Qj,H)
        decay = torch.where(tri[None, :, :, None], torch.exp(diff), 0.0)
        cb = torch.einsum("bis,bjs->bij", ck, bk)  # (B,Qi,Qj)
        m = cb[..., None] * decay  # (B,Qi,Qj,H)
        y_intra = torch.einsum("bijh,bjh,bjhp->bihp", m, dtk, xk)
        # inter-chunk: contribution of the entering state
        y_inter = torch.einsum("bis,bih,bhps->bihp", ck, torch.exp(cum), state)
        # state update to chunk exit
        seg = torch.exp(cum[:, -1:, :] - cum)  # decay from j to chunk end
        st_new = torch.einsum("bjs,bjh,bjh,bjhp->bhps", bk, dtk, seg, xk)
        state = state * torch.exp(cum[:, -1, :])[:, :, None, None] + st_new
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)[:, :s_orig]  # (B,S,H,hd)

    y = y + p["D"][None, None, :, None] * xh[:, :s_orig]
    y = y.reshape(b, s_orig, d_inner)
    y = rms_norm(y * _silu(z[:, :s_orig].float()), p["gate_norm"], cfg.norm_eps)
    out = linear(y.to(x.dtype), p["out_proj"])
    return out, {"state": state, "conv": conv_tail}


def init_ssm_cache(cfg: ModelConfig, batch: int, dtype=torch.float32, device=None):
    s = cfg.ssm
    d_inner, n_heads, conv_dim = dims(cfg)
    return {
        "state": torch.zeros((batch, n_heads, s.head_dim, s.state_dim), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, s.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def ssm_decode(p, x, cache, cfg: ModelConfig):
    """Single-token recurrence. x: (B, 1, D). The JAX function is pure; this
    one writes the new state and conv history into ``cache["state"]`` and
    ``cache["conv"]`` themselves, so that a step copies no cache, and returns
    them. The conv taps are summed in f32."""
    s_cfg = cfg.ssm
    d_inner, n_heads, _ = dims(cfg)
    hd, ns = s_cfg.head_dim, s_cfg.state_dim
    b = x.shape[0]

    proj = linear(x, p["in_proj"])
    z, xbc, dt = _split_proj(proj, cfg)  # xbc: (B,1,conv_dim)
    conv_hist = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)  # (B,W,C)
    cache["conv"].copy_(conv_hist[:, 1:, :])
    conv_out = (conv_hist.float() * p["conv_w"].float()).sum(dim=1).to(xbc.dtype) + p["conv_b"]
    xbc = _silu(conv_out)

    xs = xbc[:, :d_inner]
    Bm = xbc[:, d_inner : d_inner + ns].float()  # (B,ns)
    Cm = xbc[:, d_inner + ns :].float()

    dt = F.softplus(dt.float() + p["dt_bias"])[:, 0]  # (B,H)
    A = -torch.exp(p["A_log"])
    da = torch.exp(dt * A)  # (B,H)

    xh = xs.reshape(b, n_heads, hd).float()
    upd = torch.einsum("bh,bhp,bs->bhps", dt, xh, Bm)
    state = cache["state"]
    state.mul_(da[:, :, None, None]).add_(upd)
    y = torch.einsum("bs,bhps->bhp", Cm, state) + p["D"][None, :, None] * xh
    y = y.reshape(b, 1, d_inner)
    y = rms_norm(y * _silu(z.float()), p["gate_norm"], cfg.norm_eps)
    out = linear(y.to(x.dtype), p["out_proj"])
    return out, {"state": state, "conv": cache["conv"]}
