"""Mamba2 / SSD (state-space duality) block: chunked parallel form + decode.

Counterpart of the JAX package's ``models/ssm.py`` (arXiv:2405.21060):
within-chunk quadratic ("attention-like") term + across-chunk recurrent state
passing, single group (B/C shared across heads), depthwise causal conv over
(x, B, C). ``in_proj`` and ``out_proj`` go through ``layers.linear``, so
through the ``stream_matmul`` kernel on the card; the scan itself is plain
PyTorch in f32, as the JAX package computes it outside any Pallas kernel.
Init functions take a ``lead`` shape prefix for the stacked-layer layout.

Under the sharded steps' ``model`` axis (``sharding/fsdp.py``), where it
divides the heads, a rank computes its heads, as the reference's GSPMD
does with its placements (``sharding/specs.py``): ``in_proj``'s columns
are cut into contiguous runs that do not line up with the packed z | x |
B | C | dt, so the rank multiplies x by its run and an all-to-all over
``model`` (``fsdp.tp_exchange``) hands it its heads' z, x and dt columns
and the whole of B and C (one group, shared by every head). ``conv_w`` /
``conv_b`` are read whole (mode ``sum``) at the rank's channels; the conv,
the scan (``C Bᵀ`` whole on every rank: each head reads it), the gate and
``gate_norm`` (its sum of squares summed over ``model``) run on its heads,
``out_proj`` on its rows, summed over ``model``. Unsplit, the rank's heads
are every head and nothing is exchanged.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import dense_init, rms_norm
from repro_torch.models.layers import linear
from repro_torch.sharding import fsdp


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


def _split_proj(proj, cfg: ModelConfig, n_heads=None):
    """(z, xbc, dt) of a packed projection of ``n_heads`` heads (default
    every head) and the whole of B and C."""
    n_heads = n_heads or dims(cfg)[1]
    d_inner = n_heads * cfg.ssm.head_dim
    z = proj[..., :d_inner]
    xbc = proj[..., d_inner : 2 * d_inner + 2 * cfg.ssm.state_dim]
    dt = proj[..., -n_heads:]
    return z, xbc, dt


def _split(p) -> bool:
    """Whether the rank computes its heads with its ``model`` shard."""
    return fsdp.is_tp_shard(p["in_proj"])


def _columns(cfg: ModelConfig, n: int, r: int):
    """The packed ``in_proj`` columns that rank ``r`` of ``n`` reads, as
    (start, stop) runs in packed order: its heads' z and x, the whole of B
    and C, its heads' dt."""
    d_inner, n_heads, _ = dims(cfg)
    di, nh, bc = d_inner // n, n_heads // n, 2 * cfg.ssm.state_dim
    return ((r * di, (r + 1) * di), (d_inner + r * di, d_inner + (r + 1) * di), (2 * d_inner, 2 * d_inner + bc),
            (2 * d_inner + bc + r * nh, 2 * d_inner + bc + (r + 1) * nh))


@functools.lru_cache(maxsize=64)
def _exchange_plan(cfg: ModelConfig, n: int, r: int, device):
    """``fsdp.tp_exchange``'s (send, sends, recvs) for rank ``r`` of ``n``,
    whose ``in_proj`` shard is the packed columns [r w, (r + 1) w): to each
    rank q, its columns among those q reads (:func:`_columns`), in order;
    from each rank, as many of the columns r reads as lie in its run. A
    rank's runs of what it reads are in packed order, and so are the
    senders' runs, so the columns come back in packed order. Kept for the
    next call: ``send`` is a tensor on ``device``, and a decode step would
    otherwise copy it there a layer."""
    d_inner, n_heads, _ = dims(cfg)
    w = (2 * d_inner + 2 * cfg.ssm.state_dim + n_heads) // n

    def common(q, s):
        """The columns q reads in sender s's run, as indices in that run."""
        return [c - s * w for a, b in _columns(cfg, n, q) for c in range(max(a, s * w), min(b, (s + 1) * w))]

    sends = [common(q, r) for q in range(n)]
    send = torch.tensor([c for cols in sends for c in cols], dtype=torch.int64, device=device)
    return send, tuple(map(len, sends)), tuple(len(common(r, s)) for s in range(n))


def _project(p, x, cfg: ModelConfig):
    """The packed projection of the heads the rank computes, ``x @
    in_proj`` unsplit; on its ``model`` shard its run of the columns
    exchanged over ``model`` for those of its heads and B, C."""
    if not _split(p):
        return linear(x, p["in_proj"])
    axis = fsdp.tp()
    return fsdp.tp_exchange(linear(fsdp.tp_copy(x), p["in_proj"]), *_exchange_plan(cfg, axis.size, axis.index, x.device))


def _own_channels(t, cfg: ModelConfig, d_inner: int):
    """``t``'s last dim, the conv's channels, at those of the rank's heads'
    x (d_inner of them) and of B and C."""
    r = fsdp.tp().index
    return torch.cat([t[..., r * d_inner : (r + 1) * d_inner], t[..., dims(cfg)[0] :]], dim=-1)


def _conv_params(p, cfg: ModelConfig, d_inner: int):
    """``conv_w`` and ``conv_b`` at the rank's channels (every channel,
    unsplit)."""
    if not _split(p):
        return p["conv_w"], p["conv_b"]
    return _own_channels(p["conv_w"], cfg, d_inner), _own_channels(p["conv_b"], cfg, d_inner)


def _gate_norm(y, p, cfg: ModelConfig):
    """``rms_norm`` over d_inner of the gated y; on the rank's channels, its
    sum of squares summed over ``model`` (all-reduced in the backward too:
    each rank reads the sum in its own part)."""
    if not _split(p):
        return rms_norm(y, p["gate_norm"], cfg.norm_eps)
    return rms_norm(y, p["gate_norm"], cfg.norm_eps, lambda t: fsdp.tp_copy(fsdp.tp_sum(t)), dims(cfg)[0])


def _out(p, y, dtype):
    """``out_proj`` over the rank's rows of d_inner, summed over ``model``."""
    out = linear(y.to(dtype), p["out_proj"])
    return fsdp.tp_sum(out) if _split(p) else out


def conv_history(p, tail, cfg: ModelConfig, channels: int):
    """The cache's conv history from ``tail`` (B, W - 1, ·), the pre-conv
    inputs of the rank's heads' x and of B and C: all of x gathered over
    ``model`` where the rank computes its heads, then the run of
    ``channels`` that the rank's cache shard holds (every channel where
    ``channels`` is the conv's whole width)."""
    if _split(p):
        d_inner = p["A_log"].shape[-1] * cfg.ssm.head_dim
        tail = torch.cat([fsdp.tp_all_gather(tail[..., :d_inner], -1), tail[..., d_inner:]], dim=-1)
    if channels < tail.shape[-1]:
        tail = tail.narrow(-1, fsdp.tp().index * channels, channels)
    return tail


def _spanning(g):
    """For g (B, Qi, Qj, H), out[:, k] = the sum of g[:, i, j] over j < k <=
    i: each term once, in a sum over i from the chunk's end (a reversed
    cumsum), then over j."""
    q = g.shape[1]
    rev = torch.flip(torch.cumsum(torch.flip(g, (1,)), dim=1), (1,))  # rev[:, k, j]: the sum over i >= k
    strict = torch.tril(torch.ones((q, q), dtype=torch.bool, device=g.device), -1)[None, :, :, None]
    return torch.where(strict, rev, 0.0).sum(dim=2)


class _Differences(torch.autograd.Function):
    """The intra-chunk decay exponents cum_i - cum_j (B, Qi, Qj, H) of dA
    (B, Q, H), cum its inclusive cumsum over the chunk: the reference's
    bits. Its gradient goes to dA as the sum of the terms whose segment
    j < k <= i holds k (:func:`_spanning`), where autograd through the cumsum
    would take the difference of two sums over the whole chunk that cancel
    nearly all the way (shifting every cum_i leaves the differences alone),
    so that the last bits of the gradients that come in, which a step split
    over ``model`` sums in another order, reached A_log's and dt_bias's
    gradients many times over (``scripts/port_split_step_figures.py``)."""

    @staticmethod
    def forward(ctx, dac):
        cum = torch.cumsum(dac, dim=1)
        return cum[:, :, None, :] - cum[:, None, :, :]

    @staticmethod
    def backward(ctx, g):
        return _spanning(g) - _spanning(g.transpose(1, 2))


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
    {'state': (B,H,hd,ns) f32, 'conv': (B,width-1,conv_dim)}, of the
    heads the rank computes and their x's and B's and C's channels
    (:func:`conv_history` makes the cache's run of them)."""
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
    n_heads = p["A_log"].shape[-1]  # the rank's heads
    hd, ns, q = s_cfg.head_dim, s_cfg.state_dim, s_cfg.chunk
    d_inner = n_heads * hd
    b, s_orig, _ = x.shape
    pad = (-s_orig) % q
    s = s_orig + pad
    nc = s // q

    proj = _project(p, x, cfg)
    if pad:
        proj = F.pad(proj, (0, 0, 0, pad))
    z, xbc_raw, dt = _split_proj(proj, cfg, n_heads)
    conv_tail = xbc_raw[:, :s_orig, :][:, -(s_cfg.conv_width - 1) :, :]
    xbc = _silu(_causal_conv(xbc_raw, *_conv_params(p, cfg, d_inner)))
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
        # intra-chunk: M[i,j] = exp(cum_i - cum_j) for i >= j; masked before
        # the exp, so that a chunk whose cum_i - cum_j for i < j passes f32's
        # range (published widths, 256-step chunks) gives a 0, not an inf,
        # whose gradient through the mask would be 0 * inf = NaN (the
        # reference's where-after-exp; the values are the same bits)
        diff = _Differences.apply(dac)  # (B,Qi,Qj,H)
        decay = torch.exp(torch.where(tri[None, :, :, None], diff, float("-inf")))
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
    y = _gate_norm(y * _silu(z[:, :s_orig].float()), p, cfg)
    return _out(p, y, x.dtype), {"state": state, "conv": conv_tail}


def ssm_decode(p, x, cache, cfg: ModelConfig):
    """Single-token recurrence. x: (B, 1, D). The JAX function is pure; this
    one writes the new state and conv history into ``cache["state"]`` and
    ``cache["conv"]`` themselves, so that a step copies no cache, and returns
    them. The conv taps are summed in f32.

    On the rank's ``model`` shard: ``cache["state"]`` holds its heads and
    ``cache["conv"]`` its run of the channels (``cache_shardings``; or all
    of them where ``model`` does not divide them). The history is gathered
    whole over ``model`` and joined with the token's x, B and C (x
    gathered over ``model``), the rank's run of it written back, and the
    conv taken at its channels; its heads' state is updated in place."""
    s_cfg = cfg.ssm
    n_heads = p["A_log"].shape[-1]
    hd, ns = s_cfg.head_dim, s_cfg.state_dim
    d_inner = n_heads * hd
    b = x.shape[0]

    proj = _project(p, x, cfg)
    z, xbc, dt = _split_proj(proj, cfg, n_heads)  # xbc: (B,1,d_inner + 2 ns)
    # every channel's history (B, W, C), the rank's run of it written back,
    # the conv at its channels
    run, whole = cache["conv"].shape[-1], dims(cfg)[2]
    start = fsdp.tp().index * run if run < whole else 0
    hist = fsdp.tp_all_gather(cache["conv"], -1) if run < whole else cache["conv"]
    hist = torch.cat([hist, conv_history(p, xbc, cfg, whole).to(hist.dtype)], dim=1)
    cache["conv"].copy_(hist[:, 1:, start : start + run])
    if _split(p):
        hist = _own_channels(hist, cfg, d_inner)
    conv_w, conv_b = _conv_params(p, cfg, d_inner)
    xbc = _silu((hist.float() * conv_w.float()).sum(dim=1).to(xbc.dtype) + conv_b)

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
    y = _gate_norm(y * _silu(z.float()), p, cfg)
    return _out(p, y, x.dtype), {"state": state, "conv": cache["conv"]}
