"""RecurrentGemma / Griffin recurrent block: conv + RG-LRU gated recurrence.

Counterpart of the JAX package's ``models/rglru.py`` (arXiv:2402.19427):

    r_t = sigmoid(W_a x_t)            (recurrence gate)
    i_t = sigmoid(W_x x_t)            (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Every projection goes through ``layers.linear``, so through the
``stream_matmul`` kernel on the card. The sequence form is the JAX package's
``jax.lax.associative_scan`` written out (:func:`rglru_scan`): plain PyTorch
in f32, as the reference computes it outside any Pallas kernel. bf16 rounds
where the reference rounds: after each projection, the conv's taps, and
``h`` before the gate branch's product. Init functions take a ``lead`` shape
prefix for the stacked-layer layout.

Under the sharded steps' ``model`` axis (``sharding/fsdp.py``), where it
divides d_model, a rank computes its channels, as the reference's GSPMD
does with its placements (``sharding/specs.py``): ``w_in`` and
``w_gate_branch`` on its columns, the conv on its channels, ``w_a`` and
``w_x`` on its columns of the whole conv output (gathered over ``model``),
the gates and the scan on its channels (each channel's recurrence is its
own), ``w_out`` on its rows, summed over ``model``.
"""
from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init
from repro_torch.models.layers import linear
from repro_torch.sharding import fsdp

RGLRU_C = 8.0


def init_rec_block(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    d = cfg.d_model
    dt = common.dtype_of(cfg)
    dev = gen.device
    return {
        "w_in": dense_init(gen, (*lead, d, d), dt, fan_in=d),  # recurrent branch input proj
        "w_gate_branch": dense_init(gen, (*lead, d, d), dt, fan_in=d),  # multiplicative branch
        "conv_w": dense_init(gen, (*lead, cfg.rglru.conv_width, d), dt, fan_in=4),
        "conv_b": torch.zeros((*lead, d), dtype=dt, device=dev),
        "w_a": dense_init(gen, (*lead, d, d), dt, fan_in=d),
        "w_x": dense_init(gen, (*lead, d, d), dt, fan_in=d),
        "lam": torch.full((*lead, d), 0.65, dtype=torch.float32, device=dev),  # Lambda (softplus-domain)
        "w_out": dense_init(gen, (*lead, d, d), dt, fan_in=d),
    }


def _gelu(x):
    """``jax.nn.gelu`` as the JAX package computes it on the CPU: its
    default tanh approximation (PyTorch's default is the exact erf form),
    every op and both constants rounded to x's dtype. In bf16
    ``F.gelu(approximate="tanh")``, which rounds once, differs from it in 46%
    of the places; this in none of 65536 (2 * randn inputs)."""
    c, k = (torch.tensor(v, dtype=x.dtype).item() for v in (math.sqrt(2 / math.pi), 0.044715))
    return x * (0.5 * (1.0 + torch.tanh(c * (x + k * (x * x * x)))))


def _gates(p, xb):
    """(a, gated input), both (B, S, D) f32, from the conv output xb; on
    the rank's channels, the gates' products read xb whole, gathered over
    ``model``."""
    whole = fsdp.tp_all_gather(xb, -1) if fsdp.is_tp_shard(p["w_a"]) else xb
    r = torch.sigmoid(linear(whole, p["w_a"]).float())
    i = torch.sigmoid(linear(whole, p["w_x"]).float())
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xb.float())
    return a, gated_in


def _combine(x, y):
    a1, b1 = x
    a2, b2 = y
    return a1 * a2, a2 * b1 + b2


def _interleave(even, odd):
    """even[0], odd[0], even[1], odd[1], ... along axis 1 (even holds as many
    elements as odd, or one more)."""
    n = even.shape[1] + odd.shape[1]
    out = even.new_empty((even.shape[0], n, *even.shape[2:]))
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _scan(a, b):
    """The inclusive scan of ``_combine`` over axis 1 by JAX's recursion
    (``associative_scan``'s ``_scan``): combine adjacent pairs, scan them,
    which gives the odd elements, combine those with the even inputs, then
    interleave. The same combines in the same order as the reference, so the
    same f32 operations; 2 * log2(S) levels of elementwise launches."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd_a, odd_b = _scan(*_combine((a[:, 0 : n - 1 : 2], b[:, 0 : n - 1 : 2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even_a, even_b = _combine((odd_a[:, :-1], odd_b[:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even_a, even_b = _combine((odd_a, odd_b), (a[:, 2::2], b[:, 2::2]))
    even_a = torch.cat([a[:, :1], even_a], dim=1)
    even_b = torch.cat([b[:, :1], even_b], dim=1)
    return _interleave(even_a, odd_a), _interleave(even_b, odd_b)


def rglru_scan(a, b, h0=None):
    """h_t = a_t h_{t-1} + b_t over axis 1. a/b: (B, S, D) f32; h0: (B, D)."""
    if h0 is not None:
        # fold the initial state into the first step
        b = b.clone()
        b[:, 0, :] += a[:, 0, :] * h0
    _, h = _scan(a, b)
    return h


def _causal_conv(xr, w, bias):
    """Depthwise causal conv along S of the recurrent branch, the reference's
    Python ``sum`` over the taps in xr's dtype (from 0) plus the bias."""
    width, s = w.shape[0], xr.shape[1]
    pad = F.pad(xr, (0, 0, width - 1, 0))
    conv = 0
    for i in range(width):
        conv = conv + pad[:, i : i + s, :] * w[i]
    return conv + bias


def rec_block_with_input(p, x, cfg: ModelConfig, h0=None):
    """:func:`rec_block_apply` that also returns xr = x @ w_in (B, S, D), of
    which :func:`conv_tail` is the last ``width - 1`` rows: prefill takes the
    tail from here, the same product on the same input, instead of computing
    x @ w_in a second time as the reference does. On the rank's ``model``
    shard, h_last and xr are its channels'."""
    split = fsdp.is_tp_shard(p["w_in"])
    if split:
        x = fsdp.tp_copy(x)
    xr = linear(x, p["w_in"])
    xg = _gelu(linear(x, p["w_gate_branch"]))
    xb = _causal_conv(xr, p["conv_w"], p["conv_b"])
    a, gated_in = _gates(p, xb)
    h = rglru_scan(a, gated_in, h0)
    out = (h.to(x.dtype) * xg).to(x.dtype)
    out = linear(out, p["w_out"])
    return (fsdp.tp_sum(out) if split else out), h[:, -1, :], xr


def rec_block_apply(p, x, cfg: ModelConfig, h0=None):
    """x: (B, S, D) -> (out, h_last (B, D) f32)."""
    out, h_last, _ = rec_block_with_input(p, x, cfg, h0)
    return out, h_last


def conv_tail(p, x):
    """Last (width-1) pre-conv recurrent-branch inputs, for decode carry-over.

    x: the *normed* block input (B, S, D).
    """
    width = p["conv_w"].shape[0]
    xr = linear(x, p["w_in"])
    return xr[:, -(width - 1) :, :]


def rec_block_decode(p, x, h_prev, cfg: ModelConfig, conv_state=None):
    """One-token step. x: (B, 1, D); h_prev: (B, D) f32.

    conv_state: (B, width-1, D) trailing conv inputs (or None for width-1
    zeros, e.g. at sequence start). Returns (out, h, new_conv); the caller
    writes h and new_conv into its cache. The conv's taps are summed in f32
    and rounded once, as the reference's einsum. On the rank's ``model``
    shard, h_prev, conv_state, h and new_conv are its channels'.
    """
    split = fsdp.is_tp_shard(p["w_in"])
    if split:
        x = fsdp.tp_copy(x)
    xr = linear(x, p["w_in"])
    xg = _gelu(linear(x, p["w_gate_branch"]))
    width = p["conv_w"].shape[0]
    if conv_state is None:
        conv_state = xr.new_zeros((x.shape[0], width - 1, xr.shape[-1]))
    hist = torch.cat([conv_state, xr.to(conv_state.dtype)], dim=1)  # (B, width, D)
    new_conv = hist[:, 1:, :]
    conv = (hist.float() * p["conv_w"].float()).sum(dim=1).to(xr.dtype)
    xb = (conv + p["conv_b"])[:, None, :]
    a, gated_in = _gates(p, xb)
    h = a[:, 0] * h_prev + gated_in[:, 0]  # (B, D)
    out = (h[:, None, :].to(x.dtype) * xg).to(x.dtype)
    out = linear(out, p["w_out"])
    return (fsdp.tp_sum(out) if split else out), h, new_conv
