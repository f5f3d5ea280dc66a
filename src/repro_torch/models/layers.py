"""Attention / MLP layers: init + apply, plain functions over params dicts.

Counterpart of the JAX package's ``models/layers.py`` for the attention
families (dense, VLM with M-RoPE, the bidirectional audio encoder). Init
functions take a ``lead`` shape prefix so the model can draw every layer's
leaf at once in the stacked layout (leading ``L`` axis) that the JAX package
builds with ``vmap``. Every ``x @ W`` is the ``stream_matmul`` kernel on a 2-D
``(B*S, K)`` view; one-token decode reads the KV cache through the
``paged_attention`` kernel. The MoE layer (grok-1-314b, arctic-480b with its
dense residual) dispatches tokens into expert slots as the reference does and
runs the expert products through ``stream_matmul``'s expert-batched form. The
hybrid family's local-attention layers decode against a ring of ``w`` slots
(``ring=True``), still through ``paged_attention``.

Under the sharded train step's ``model`` axis (``sharding/fsdp.py``) the
attention, MLP and MoE layers compute the rank's part of each product
whose weight that axis splits, as the reference's GSPMD does with its
placements (``sharding/specs.py``): :func:`tp_modes` says which leaves a
rank keeps as its shard; the layers see it through ``fsdp.is_tp_shard``.
The sharded serving steps use the same split, and decode against a cache
whose sequence ``model`` splits (:func:`attention_decode`; the hybrid's
ring too, :func:`kv_pages`).
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig, MoEConfig
from repro_torch.kernels import on_card
from repro_torch.kernels.paged_attention.ops import paged_attention
from repro_torch.kernels.streammm.ops import stream_matmul
from repro_torch.models import common
from repro_torch.models.common import apply_mrope, apply_rope, attend, dense_init, rms_norm
from repro_torch.sharding import fsdp


def linear(x, w, w_layout: str = "kn"):
    """``x @ w`` over the last axis of x: (..., K) @ (K, N) -> (..., N); with
    ``w_layout="nk"``, ``x @ w.T`` for w (N, K), read in place (the tied LM
    head over the (V, d) embedding table)."""
    out = stream_matmul(x.reshape(-1, x.shape[-1]), w, out_dtype=x.dtype, w_layout=w_layout)
    return out.reshape(*x.shape[:-1], out.shape[-1])


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


_SSM = ("in_proj", "conv_w", "conv_b", "A_log", "D", "dt_bias", "gate_norm", "out_proj")


def tp_modes(dims: dict) -> dict:
    """The gather modes (``sharding.fsdp.gather``) of a layer's leaves, or
    the head's, from ``dims`` (path -> the dim the ``model`` axis splits, or
    None; ``fsdp.model_dims``): every leaf that ``model`` splits is kept as
    the rank's shard (``local``), but for an expert ``w2`` that it splits
    by columns (the reference's rule when d_model = moe.d_ff): that one,
    and the per-head norms beside a split ``wq``, are gathered whole and
    read on the rank's hidden slice or heads only (``sum``). An SSM block
    (``models/ssm.py``) computes its heads where ``model`` splits both its
    heads (``A_log``) and ``in_proj``; there its ``conv_w`` and ``conv_b``,
    whose channel runs do not line up with heads, are read whole at the
    rank's channels (``sum``). Elsewhere every leaf of the block is read
    whole."""
    modes = {p: "local" for p, d in dims.items() if d is not None}
    for p, d in dims.items():
        prefix, _, leaf = p.rpartition("/")
        pre = prefix + "/" if prefix else ""
        if leaf == "w2" and d == 2 and dims.get(pre + "w1") is not None:  # (E, F, D) split by columns
            modes[p] = "sum"
        elif leaf in ("q_norm", "k_norm") and dims.get(pre + "wq") is not None:
            modes[p] = "sum"
        elif leaf in _SSM and pre + "A_log" in dims:
            if dims[pre + "A_log"] is None or dims.get(pre + "in_proj") is None:
                modes.pop(p, None)
            elif leaf in ("conv_w", "conv_b"):
                modes[p] = "sum"
    return modes


def _position_one(t, norm, cfg: ModelConfig, positions, positions3):
    """The per-head norm (``norm``: ``q_norm`` or ``k_norm``) and RoPE (or
    M-RoPE) of one of q and k: elementwise in each head, so a subset of the
    heads gets the same values as the whole."""
    if cfg.qk_norm:
        t = rms_norm(t, norm, cfg.norm_eps)
    if cfg.mrope_sections is not None:
        assert positions3 is not None
        return apply_mrope(t, positions3, cfg.rope_theta, cfg.mrope_sections)
    if cfg.causal:  # encoder (hubert) backbone: no rope on bidirectional attn
        return apply_rope(t, positions, cfg.rope_theta)
    return t


def _position(q, k, p, cfg: ModelConfig, positions, positions3):
    """The per-head norms and RoPE (or M-RoPE) of q and k."""
    return (_position_one(q, p.get("q_norm"), cfg, positions, positions3),
            _position_one(k, p.get("k_norm"), cfg, positions, positions3))


def attention_apply(
    p, x, cfg: ModelConfig, *, positions, positions3=None, window: Optional[int] = None, whole_kv: bool = False
):
    """Full-sequence attention: RoPE (or M-RoPE, from ``positions3`` (3, B,
    S)) reads ``positions`` (B, S). ``attend`` masks by ``positions`` as the
    reference does: on the CPU for every family, on CUDA for the VLM (whose
    M-RoPE layout gives an image's patches one temporal position), where the
    flash kernel takes them; the other families' positions are 0..S-1, and
    on CUDA the kernel masks those by index. Returns (out, (k, v)) of the
    heads the rank attends with.

    On this rank's ``model`` shard, ``wq`` / ``bq`` hold columns [r W, (r +
    1) W) of the heads' (H * Dh), ``wo`` the same rows. The rank attends
    with the query heads those columns touch (all ranks' projections
    gathered where its columns cut a head, as qwen2-vl-7b's 28 heads on 16
    ranks do) and the KV heads they read, in GQA order: its own ``wk`` /
    ``wv`` columns where they are exactly those heads, else every rank's
    gathered (a KV head that several ranks' query heads share: every
    published config's on 16). Its columns of the attention's output times
    its rows of ``wo`` are its part of the output, summed over ``model``.
    Unsplit, r = 0 and W = H * Dh: every head, and nothing gathered.

    With ``whole_kv`` (a prefill's cache) the (k, v) returned are every KV
    head, (B, S, Hkv, Dh), k positioned: where the rank's own columns were
    exactly the heads it reads, they are all-gathered over ``model`` for
    it; unsplit, they are the attention's own."""
    b, s, _ = x.shape
    hd, h, hkv = cfg.resolved_head_dim(), cfg.num_heads, cfg.num_kv_heads
    group = h // hkv
    split = fsdp.is_tp_shard(p["wq"])
    r = fsdp.tp().index if split else 0
    if split:
        x = fsdp.tp_copy(x)
    width = p["wq"].shape[-1]
    lo, hi = r * width // hd, ((r + 1) * width - 1) // hd + 1
    q = linear(x, p["wq"])
    if cfg.qkv_bias:
        q = q + p["bq"]
    if width % hd or r * width % hd:  # the columns cut a head: take the heads whole
        q = fsdp.tp_all_gather(q, -1)[..., lo * hd : hi * hd]
    kv = [(lo + j) // group for j in range(hi - lo)]  # the KV head of each query head
    klo, khi = kv[0], kv[-1] + 1

    def project(w, bias):
        """(the KV heads the rank reads, the projection they were cut from)."""
        assert fsdp.is_tp_shard(p[w]) == split, f"{w} is split over model where wq is not, or whole where it is"
        out = linear(x, p[w])
        if cfg.qkv_bias:
            out = out + p[bias]
        n = p[w].shape[-1]
        if r * n == klo * hd and (r + 1) * n == khi * hd and not (whole_kv and split):  # exactly its KV heads
            return out, out
        whole = fsdp.tp_all_gather(out, -1)
        return whole[..., klo * hd : khi * hd], whole

    (k, k_all), (v, v_all) = project("wk", "bk"), project("wv", "bv")
    nq, nk = hi - lo, khi - klo
    q = q.reshape(b, s, nq, hd)
    k = k.reshape(b, s, nk, hd)
    v = v.reshape(b, s, nk, hd)
    if nq % nk or any(kv[j] - klo != j // (nq // nk) for j in range(nq)):  # no GQA grouping: a KV head a query head
        idx = torch.tensor([i - klo for i in kv], device=x.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    q, k = _position(q, k, p, cfg, positions, positions3)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    mask_positions = positions if cfg.family == "vlm" or not on_card(q) else None
    out = attend(q, k, v, q_positions=mask_positions, kv_positions=mask_positions,
                 causal=cfg.causal, window=window)
    off = r * width - lo * hd
    out = linear(out.reshape(b, s, nq * hd)[..., off : off + width].contiguous(), p["wo"])
    if split:
        out = fsdp.tp_sum(out)
    if whole_kv and split:
        k_all = _position_one(k_all.reshape(b, s, hkv, hd), p.get("k_norm"), cfg, positions, positions3)
        return out, (k_all, v_all.reshape(b, s, hkv, hd))
    return out, (k, v)


def kv_page_tokens(smax: int) -> int:
    """Slots a page holds in the page-pool view of a cache of ``smax`` slots:
    the largest power of two <= 64 that divides it."""
    pt = 64
    while smax % pt:
        pt //= 2
    return pt


def kv_pages(index, batch: int, smax: int, ring: bool = False, start: int = 0,
             whole: Optional[int] = None):
    """The page-pool view of a layer's cache of ``smax`` slots at decode
    position ``index`` (0-d int32 tensor): the write slot (a 1-element int64
    tensor), the page table (B, Smax / pt) int32, row b owning pages
    ``b * P .. b * P + P - 1`` of :func:`kv_page_tokens` slots, and the
    lengths (B,) int32. The cache is a rank's shard of one of ``whole``
    slots (``smax``, the default, where it is not cut), its slots [start,
    start + smax): the write slot is ``index - start`` (meaningful on the
    rank that owns ``index`` only) and the lengths ``index + 1 - start``
    clamped to [0, smax]. With ``ring``, the whole cache is a ring: the
    write slot is ``index % whole - start`` and the lengths ``min(index +
    1, whole) - start``, clamped likewise. Every layer of a step shares it.
    Nothing here waits for the device."""
    n = smax // kv_page_tokens(smax)
    table = torch.arange(batch * n, dtype=torch.int32, device=index.device).reshape(batch, n)
    lengths = index.expand(batch) + 1
    if ring:
        whole = smax if whole is None else whole
        index, lengths = index % whole, lengths.clamp(max=whole)
    return (index - start).reshape(1).long(), table, (lengths - start).clamp(0, smax)


def attention_decode(
    p,
    x,
    cfg: ModelConfig,
    *,
    k_cache,
    v_cache,
    index,
    positions,
    positions3=None,
    window: Optional[int] = None,
    ring: bool = False,
    pages=None,
    write: bool = True,
):
    """One-token decode against one layer's KV cache, updated in place.

    k_cache/v_cache: (B, Smax, Hkv, Dh); index: 0-d int32 tensor on their
    device (the current position, the same for every row); positions: (B, 1);
    positions3: (3, B, 1) for M-RoPE; pages: :func:`kv_pages` of ``index``
    (and ``ring``), built here when not given. The JAX function is pure and
    returns new caches; this one writes k/v at the write slot into
    ``k_cache``/``v_cache`` themselves, so that a step copies no cache, and
    returns them. Attention then views the cache as a pool of ``B * Smax /
    pt`` pages and reads the first ``lengths`` slots of each row through
    ``paged_attention``.

    A plain cache is written at slot ``index``. The caller checks ``index <
    Smax`` (``decode_step`` does, on the host copy the cache carries); past
    it, the write's own bounds check fails (IndexError on the CPU, a
    device-side assertion on CUDA) where the reference's
    ``dynamic_update_slice`` clamps and overwrites the last slot.

    With ``ring=True`` the cache is a ring of Smax slots (the hybrid's local
    attention), written at slot ``index % Smax`` before attending, as the
    reference does. Its valid slots are then exactly the first ``min(index +
    1, Smax)``, and with Smax <= ``window`` every one of them lies inside the
    window, so the kernel needs no window: softmax does not depend on the
    order of the slots. A ring wider than ``window``, and a window over a
    plain cache, would need slots that are not a prefix: they raise
    ValueError (no path of either package builds them).

    Under the sharded serving step's ``model`` axis (``sharding.fsdp``):
    the token's q, k and v are gathered whole over ``model`` (all H and Hkv
    heads) from the rank's columns of ``wq`` / ``wk`` / ``wv``; the k / v are
    written only where ``write`` (the rank that owns slot ``index`` of a
    cache whose sequence ``model`` splits; every rank of an undivided one);
    each rank attends over its slots with every head (``pages`` of its
    shard, ``kv_pages(..., start=)``; of its run of the shard's rows where
    the ranks along ``pod`` share the shard, each writing the k / v of all
    of them) and the ranks' parts are merged over
    ``model`` from their log-sum-exps (``fsdp.tp_merge_attention``; none
    where the cache is whole on each rank); the rank's columns of the
    merged output meet its rows of ``wo``, summed over ``model``.
    """
    if window is not None and not (ring and k_cache.shape[1] <= window):
        raise ValueError(
            f"attention_decode: a window of {window} needs a ring of at most that many slots "
            f"(ring={ring}, {k_cache.shape[1]} slots)"
        )
    _, smax, hkv, hd = k_cache.shape
    b = x.shape[0]
    slot, table, lengths = pages if pages is not None else kv_pages(index, b, smax, ring)
    split = fsdp.is_tp_shard(p["wq"])
    r = fsdp.tp().index if split else 0

    def project(w, bias, heads):
        """The token's projection by ``p[w]``: every head, gathered over
        ``model`` from the rank's columns where split."""
        assert fsdp.is_tp_shard(p[w]) == split, f"{w} is split over model where wq is not, or whole where it is"
        out = linear(x, p[w])
        if cfg.qkv_bias:
            out = out + p[bias]
        if split:
            out = fsdp.tp_all_gather(out, -1)
        return out.reshape(b, 1, heads, hd)

    q, k = _position(project("wq", "bq", cfg.num_heads), project("wk", "bk", hkv), p, cfg, positions, positions3)
    v = project("wv", "bv", hkv)
    if write:  # the ranks along share hold one model coordinate, so all of them write or none
        k_cache.index_copy_(1, slot, fsdp.share_all_gather(k))
        v_cache.index_copy_(1, slot, fsdp.share_all_gather(v))
    pt = kv_page_tokens(smax)
    k_rows, v_rows = fsdp.share_rows(k_cache), fsdp.share_rows(v_cache)
    args = (q.reshape(b, cfg.num_heads, hd), k_rows.view(b * smax // pt, pt, hkv, hd),
            v_rows.view(b * smax // pt, pt, hkv, hd), table, lengths)
    if fsdp.seq_axis() is not None:
        out = fsdp.tp_merge_attention(*paged_attention(*args, return_lse=True))
    else:
        out = paged_attention(*args)
    width = p["wo"].shape[0]
    out = linear(out.reshape(b, 1, -1)[..., r * width : (r + 1) * width].contiguous(), p["wo"])
    if split:
        out = fsdp.tp_sum(out)
    return out, (k_cache, v_cache)


# --------------------------------------------------------------------------
# Dense (gated) MLP
# --------------------------------------------------------------------------


def init_mlp(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = (), d_ff: Optional[int] = None):
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    dt = common.dtype_of(cfg)
    return {
        "w1": dense_init(gen, (*lead, d, f), dt, fan_in=d),
        "w3": dense_init(gen, (*lead, d, f), dt, fan_in=d),
        "w2": dense_init(gen, (*lead, f, d), dt, fan_in=f),
    }


def _mlp(p, x):
    h = F.silu(linear(x, p["w1"]))
    h = h * linear(x, p["w3"])
    return linear(h, p["w2"])


def mlp_apply(p, x):
    """The gated MLP; on this rank's ``model`` shard (``w1`` / ``w3`` by
    columns, ``w2`` by rows of the hidden) its part, summed over ``model``."""
    if fsdp.is_tp_shard(p["w1"]):
        return fsdp.tp_sum(_mlp(p, fsdp.tp_copy(x)))
    return _mlp(p, x)


# --------------------------------------------------------------------------
# Mixture of Experts (capacity-based, scatter/gather dispatch)
# --------------------------------------------------------------------------


def init_moe(gen: torch.Generator, cfg: ModelConfig, lead: Tuple[int, ...] = ()):
    """The reference's leaves: ``router`` f32 (d, E), ``w1``/``w3`` (E, d, f),
    ``w2`` (E, f, d), and arctic's ``dense`` MLP of ``dense_d_ff``, under
    ``lead``. The reference scales an expert leaf by its leading axis (E);
    here each expert matrix is scaled by its own fan-in, so that activations
    stay O(1) at published width. The tests take the reference's values
    through ``convert.py``, so only the shapes and dtypes are shared."""
    m: MoEConfig = cfg.moe
    d, e, f = cfg.d_model, m.num_experts, m.d_ff
    dt = common.dtype_of(cfg)
    p = {
        "router": dense_init(gen, (*lead, d, e), torch.float32, fan_in=d),
        "w1": dense_init(gen, (*lead, e, d, f), dt, fan_in=d),
        "w3": dense_init(gen, (*lead, e, d, f), dt, fan_in=d),
        "w2": dense_init(gen, (*lead, e, f, d), dt, fan_in=f),
    }
    if m.dense_residual:
        p["dense"] = init_mlp(gen, cfg, lead, d_ff=m.dense_d_ff)
    return p


def moe_capacity(m: MoEConfig, n_tokens: int) -> int:
    c = int(math.ceil(m.top_k * n_tokens / m.num_experts * m.capacity_factor))
    return max(c, m.top_k)


class Dispatch(NamedTuple):
    """Where the reference's ``moe_apply`` sends each of the k * n
    assignments, choice-major (every token's first choice before any second
    one): ``idx`` (n, k) experts, best first; ``gates`` (k * n,) renormalised
    f32 gates; ``posn`` its position in its expert; ``keep`` whether that is
    below the capacity; ``slot`` its row in the (E * ``cap``, d) dispatch
    buffer (``e * cap`` where dropped); ``rows`` (E,) int32, each expert's
    filled slots; ``cap`` the buffer's slots an expert. Unsplit, ``cap`` is
    the capacity and ``slot`` is ``e * cap + posn``. Under a batch split
    ``posn`` and ``keep`` are those of the dp group's tokens, the rank's
    rows in their place; the buffer holds only this rank's kept
    assignments, ``cap = min(capacity, n)``."""

    idx: torch.Tensor
    gates: torch.Tensor
    posn: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    rows: torch.Tensor
    cap: int


def moe_dispatch(router_logits, m: MoEConfig, batch=()) -> Dispatch:
    """The reference's routing of (n, E) f32 router logits: softmax, top-k,
    gates renormalised with ``+ 1e-9``, a choice-major capacity sort. Integer
    work on the device and no host sync: no boolean indexing, no
    ``bincount``; the counts are the last row of the one-hot cumsum.

    Under a batch split (``batch``: ``sharding.fsdp`` axes) the reference's
    call sees the dp group's n * n_dp tokens, the ranks' rows in rank order.
    So the capacity is ``moe_capacity(m, n * n_dp)``, and an assignment's
    place in its expert counts every earlier one of the group: those of
    earlier choices on every rank, then those of its own choice on earlier
    ranks, then its own rank's. Each rank all-gathers a (k, E) int32 table
    of its counts a choice, not its tokens. The rank's kept assignments of an
    expert are the first of its own in its order, and a token picks an
    expert once, so they fit ``min(capacity, n)`` slots."""
    n, e = router_logits.shape
    probs = torch.softmax(router_logits, dim=-1)
    # jax.lax.top_k puts the lower index first on an exact tie: a stable sort
    # descending keeps that order (torch.topk gives no order among ties)
    gates, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, idx = gates[:, : m.top_k], idx[:, : m.top_k]
    gates = gates / (gates.sum(dim=-1, keepdim=True) + 1e-9)
    flat_e = idx.T.reshape(-1)
    one_hot = (flat_e[:, None] == torch.arange(e, device=flat_e.device)).to(torch.int32)
    seen = torch.cumsum(one_hot, dim=0, dtype=torch.int32)  # (k n, E), inclusive
    posn = seen.gather(1, flat_e[:, None]).squeeze(1) - 1  # the reference's exclusive cumsum
    if not batch:
        cap = moe_capacity(m, n)
        keep = posn < cap
        slot = flat_e * cap + torch.where(keep, posn, 0)
        rows = seen[-1].clamp(max=cap).to(torch.int32)
        return Dispatch(idx, gates.T.reshape(-1), posn, keep, slot, rows, cap)
    capacity = moe_capacity(m, n * fsdp.batch_size(batch))
    counts = one_hot.view(m.top_k, n, e).sum(dim=1, dtype=torch.int32)  # (k, E)
    table = fsdp.batch_all_gather(counts, batch)  # (n_dp, k, E)
    others = table.sum(dim=0, dtype=torch.int32) - counts
    before = torch.cumsum(others, dim=0, dtype=torch.int32) - others  # other ranks' earlier choices
    before = before + table[: fsdp.batch_index(batch)].sum(dim=0, dtype=torch.int32)  # earlier ranks
    choice = torch.arange(m.top_k, device=flat_e.device).repeat_interleave(n)
    place = posn + before[choice, flat_e]
    keep = place < capacity
    cap = min(capacity, n)
    slot = flat_e * cap + torch.where(keep, posn, 0)
    rows = (one_hot * keep[:, None]).sum(dim=0, dtype=torch.int32)
    return Dispatch(idx, gates.T.reshape(-1), place, keep, slot, rows, cap)


def moe_apply(p, x, cfg: ModelConfig):
    """Capacity-based top-k MoE, the reference's ``moe_apply``: returns
    (out (B, S, d), router_logits (B*S, E) f32). The router is
    ``stream_matmul`` in f32 (exact f32 on every route, never TF32); the
    three expert products are ``stream_matmul``'s expert-batched form over
    the (E, cap, d) dispatch buffer, each expert's filled slots given as
    ``rows``. Slots past them hold zeros, ``silu(0) * 0 = 0``, so the kernel's
    zero rows are the reference's ``expert_out`` bit for bit. Nothing here
    waits for the device: ``cap`` is a function of the shape. The
    reference's sharding constraints do nothing on one card and are
    dropped. Under the sharded step's batch split the routing is the dp
    group's (:func:`moe_dispatch`) and the experts run on this rank's kept
    assignments only: no token leaves its rank.

    On this rank's ``model`` shard of the experts, every rank of ``model``
    routes the same tokens alike and computes its part: with E / ``model``
    experts a rank (expert parallelism: arctic-480b's 128 on 16), the
    assignments to its experts; with each expert's hidden cut (grok-1-314b's
    8 experts on 16), its slice of every expert's hidden. The gates pass
    through ``fsdp.tp_copy`` (a rank's part of the combine reads them) and
    the combined parts are summed over ``model``; the dense residual is
    :func:`mlp_apply`'s."""
    m = cfg.moe
    b, s, d = x.shape
    n = b * s
    tokens = x.reshape(n, d)
    router_logits = stream_matmul(tokens.float(), p["router"], out_dtype=torch.float32)
    route = moe_dispatch(router_logits, m, fsdp.batch_axes())
    cap = route.cap
    split = fsdp.is_tp_shard(p["w1"])
    e = p["w1"].shape[0]  # this rank's experts: E, or E / model under expert parallelism
    keep, slot, rows, gates, w2 = route.keep, route.slot, route.rows, route.gates, p["w2"]
    if split:
        tokens, gates = fsdp.tp_copy(tokens), fsdp.tp_copy(gates)
        r = fsdp.tp().index
        if e != m.num_experts:  # only the assignments to its experts
            flat_e = route.idx.T.reshape(-1)
            keep = keep & (flat_e >= r * e) & (flat_e < (r + 1) * e)
            slot = torch.where(keep, slot - r * e * cap, 0)
            rows = rows[r * e : (r + 1) * e]
        elif w2.shape[1] == m.d_ff:  # w2 split by columns: its rows of the rank's hidden slice
            f = p["w1"].shape[-1]
            w2 = w2[:, r * f : (r + 1) * f].contiguous()

    # Scatter the k copies of each token into its slot. A kept assignment owns
    # its slot; a dropped one adds an exact zero row into its expert's first
    # slot (flat_e * cap), and under expert parallelism one to another rank's
    # expert adds it into slot 0. So each slot receives at most one non-zero
    # row, every sum is exact, and the index_add_ (atomics on CUDA) gives the
    # same bits in any order.
    token_rep = tokens.repeat(m.top_k, 1)  # (k n, d), jnp.tile
    buf = torch.zeros((e * cap, d), dtype=tokens.dtype, device=tokens.device)
    buf.index_add_(0, slot, torch.where(keep[:, None], token_rep, 0))
    expert_in = buf.view(e, cap, d)

    # at most top_k x n of the experts hold a row: a decode step's few tokens
    # hit few of arctic-480b's 128, and the kernel's grid spans only that many
    hit = min(e, m.top_k * n)
    h = F.silu(stream_matmul(expert_in, p["w1"], out_dtype=x.dtype, rows=rows, experts_hit=hit))
    h = h * stream_matmul(expert_in, p["w3"], out_dtype=x.dtype, rows=rows, experts_hit=hit)
    expert_out = stream_matmul(h, w2, out_dtype=x.dtype, rows=rows, experts_hit=hit)  # (E, cap, d)

    # Under grad, index_select's backward is an index_add_ (atomics on CUDA)
    # into the (E * cap, d) gradient: a kept slot receives its one row, and a
    # row that is not kept adds an exact zero row into the slot it reads
    # (flat_e * cap, or slot 0; the where below passes it no gradient), so
    # that sum too has the same bits in any order, and remat off gives remat
    # on's gradients bit for bit.
    out_rep = expert_out.view(e * cap, d).index_select(0, slot)
    out_rep = torch.where(keep[:, None], out_rep, 0) * gates[:, None].to(out_rep.dtype)
    out = out_rep.view(m.top_k, n, d).sum(dim=0)
    if split:
        out = fsdp.tp_sum(out)
    if m.dense_residual:
        out = out + mlp_apply(p["dense"], x).reshape(n, d)
    return out.reshape(b, s, d), router_logits


# --------------------------------------------------------------------------
# Norm params
# --------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, lead: Tuple[int, ...] = (), device=None):
    return torch.zeros((*lead, cfg.d_model), dtype=torch.float32, device=device)
