"""Model assembly for the attention families (dense, tied or not; MoE; VLM;
the audio encoder), the SSM family and the hybrid family, with the
reference's contract:

  init(generator)                     -> params
  forward(params, batch)              -> logits (B, S, V)
  loss(params, batch)                 -> (scalar, {"ce", "aux"})
  prefill(params, batch, max_seq)     -> (last_logits, cache)
  decode_step(params, cache, batch)   -> (logits, cache)        [one token]
  init_cache(batch, max_seq, device)  -> cache

Counterpart of the JAX package's ``models/model.py``. Params keep the
reference's tree and stacked-layer layout: ``head`` holds
``embed``/``lm_head``/``final_norm`` (no ``lm_head`` where the embeddings are
tied: the logits read ``embed`` as a K-major weight) and every leaf under
``layers`` has a leading ``L`` axis, walked by a Python loop over per-layer
views (the JAX package scans it), one ``unbind`` a leaf, so that under
autograd a leaf's gradient is one stack of its layers' gradients. Batches are the reference's: ``tokens``
(and ``labels`` for ``loss``);
for the VLM family also ``vision_embeds`` (B, S_vis, d), placed before the
tokens, and ``positions3`` (3, B, S_vis + S_text); for the audio family
``frames`` (B, S, d) and an optional ``frame_mask`` (B, S), whose frames
take ``embed[0]``. The cache is the reference's too: for the attention families
``{"k", "v"}`` of shape (L, B, Smax, Hkv, hd), for the SSM family
``{"state", "conv"}`` of shapes (L, B, H, hd, ns) f32 and (L, B, width-1,
conv_dim), each with a 0-d int32 ``index``; ``prefill`` and ``decode_step``
write into it in place. It also carries ``host_index``, the same position as
a Python int, so that a step checks its bounds without waiting for the
device. An MoE layer (``cfg.moe``) holds ``moe`` where a dense one holds
``mlp``. The hybrid family (recurrentgemma) holds ``rec_layers`` and
``attn_layers``, each stacked, and a cache of ``{"h", "conv", "k", "v"}``
whose k/v are rings of ``w`` slots.

``loss`` is the reference's: the token-mean cross-entropy in f32
(:func:`cross_entropy`) plus, for the attention families, 0.01 times MoE's
load-balance term averaged over the layers (0 for a dense model); the VLM's
vision prefix carries no labels, and audio labels are ignored where
``frame_mask`` is False. With ``cfg.remat`` each layer (the hybrid: each
(rec, rec, attn) group) runs under ``torch.utils.checkpoint``, as the
reference's ``_remat`` wraps its scan body: the numbers do not change, the
activations kept for the backward do. Under the sharded train step
``loss`` gets each leaf's local shard and gathers a layer's leaves (a
group's) inside that unit and the head's where they are used
(``sharding/fsdp.py``); with nothing installed the gathers are the leaves
themselves. Under its ``model`` axis every family's layers, embedding,
head and cross-entropy compute this rank's part of each product that axis
splits (``models/layers.tp_modes``): the attention families' heads, FFN
hidden and experts, the SSM's heads (``models/ssm.py``), the RG-LRU's
channels (``models/rglru.py``). Every family's ``prefill`` and
``decode_step`` run the same split under the sharded serving steps
(``launch/steps.make_sharded_prefill_step``), one layer's leaves gathered
at a time, the cache the rank's shard as ``cache_shardings`` places it:
the KV cache's sequence (the hybrid's ring's slots) cut over ``model``
where it divides, the SSM's state by heads and its conv history by
channels, the RG-LRU's state and conv history by channels.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common, rglru, ssm
from repro_torch.models.common import resolve_device, rms_norm
from repro_torch.roofline import memory
from repro_torch.models.layers import (
    attention_apply,
    attention_decode,
    init_attention,
    init_mlp,
    init_moe,
    init_norm,
    kv_pages,
    linear,
    mlp_apply,
    moe_apply,
    tp_modes,
)
from repro_torch.sharding import fsdp


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    loss: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def prefill_slots(cfg: ModelConfig, s: int, max_seq: Optional[int] = None) -> int:
    """The ``max_seq`` of ``init_cache`` for the whole cache that ``prefill``
    builds from S tokens: ``max(max_seq, S)`` slots for the attention
    families; the hybrid's ring is sized by the prompt (``init_cache``
    takes ``min(window, S)``) and the SSM's state reads neither."""
    return s if cfg.family in ("ssm", "hybrid") else max(max_seq or s, s)


def _init_head(gen: torch.Generator, cfg: ModelConfig):
    dt = common.dtype_of(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    p = {"embed": common.embed_init(gen, (v, d), dt)}
    if not cfg.tie_embeddings:
        p["lm_head"] = common.dense_init(gen, (d, v), dt, fan_in=d)
    p["final_norm"] = init_norm(cfg, device=gen.device)
    return p


def _gather_tp(tree):
    """``fsdp.gather`` of a layer's or the head's leaves, each ``model``
    shard kept where the layer computes its part with it (``tp_modes``)."""
    return fsdp.gather(tree, tp_modes(fsdp.model_dims(tree)))


def _tp_cut(n: int) -> int:
    """n / ``model`` where the installed ``model`` axis divides n, else n:
    the heads or channels of a cache shard, as ``cache_shardings`` cuts
    them."""
    axis = fsdp.tp()
    return n // axis.size if axis is not None and n % axis.size == 0 else n


def _embed(params, ids):
    """The embeddings of ``ids`` (an int64 tensor of any shape, or one int).
    Under the sharded step the table is gathered here; where ``model``
    splits its rows, each rank looks up the ids among its rows (zeros for
    the others) and the rows are summed over ``model``."""
    table = _gather_tp({"embed": params["head"]["embed"]})["embed"]
    if not fsdp.is_tp_shard(table):
        return table[ids]
    n = table.shape[0]
    local = ids - fsdp.tp().index * n
    if isinstance(ids, int):
        return fsdp.tp_sum(table[local] if 0 <= local < n else table.new_zeros(table.shape[1:]))
    mine = (local >= 0) & (local < n)
    rows = table[torch.where(mine, local, 0)]
    return fsdp.tp_sum(torch.where(mine[..., None], rows, 0))


@memory.kind("logits")
def _head(p, x, cfg: ModelConfig):
    """The LM head over x: (logits, the ``model`` axis that splits their
    vocabulary, or None). Under the sharded step its leaves are gathered
    here (``sharding.fsdp``), the tied head's ``embed`` a second time, and
    where ``model`` splits the vocabulary each rank's logits are its slice
    of it (:func:`cross_entropy` takes them so, with that axis)."""
    p = _gather_tp({k: p[k] for k in ("final_norm", "embed" if cfg.tie_embeddings else "lm_head")})
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    head = p["embed"] if cfg.tie_embeddings else p["lm_head"]
    axis = fsdp.tp() if fsdp.is_tp_shard(head) else None
    if axis is not None:
        x = fsdp.tp_copy(x)
    if cfg.tie_embeddings:  # x @ embed^T, embed (V, d) read in place
        return linear(x, head, w_layout="nk"), axis
    return linear(x, head), axis


def _logits(p, x, cfg: ModelConfig):
    return _head(p, x, cfg)[0]


def _serve_logits(p, x, cfg: ModelConfig):
    """The head's logits whole over the vocabulary: each rank's slice
    all-gathered over ``model`` where it splits them (the serving steps)."""
    logits, axis = _head(p, x, cfg)
    return logits if axis is None else fsdp.tp_all_gather(logits, -1)


def _head_loss(p, x, labels, cfg: ModelConfig):
    """:func:`cross_entropy` of the head's logits over x: over the
    vocabulary's slices where ``model`` splits it."""
    logits, axis = _head(p, x, cfg)
    return cross_entropy(logits, labels, axis=axis)


def _layer_views(tree, n: int):
    """The ``n`` layers of a stacked tree as views, one ``unbind`` a leaf:
    under autograd the leaf's gradient is then one stack of the layers'
    gradients, where indexing ``[l]`` would add a zero tensor of the whole
    leaf for every layer. Under the sharded step the views are the
    layers' shards (``sharding.fsdp.unbind``)."""
    split = {k: _layer_views(v, n) if isinstance(v, dict) else fsdp.unbind(v) for k, v in tree.items()}
    return [{k: v[l] for k, v in split.items()} for l in range(n)]


def _remat(cfg: ModelConfig, fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when ``cfg.remat``: the
    reference's ``_remat`` (``jax.checkpoint``) around a scan body. The
    model draws no random numbers, so no RNG state is kept for the replay.
    Under the sharded step the replay sees its split too (it gathers the
    layer again). The tensors the unit keeps for its replay are the
    dry-run's ``residuals`` (``roofline.memory``)."""
    if cfg.remat:
        memory.mark(args, "residuals")
        ctx = fsdp.current()
        kw = {} if ctx is None else {"context_fn": fsdp.remat_contexts(ctx)}
        return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False, **kw)
    return fn(*args)


class _PickLogit(torch.autograd.Function):
    """``logits.gather(-1, idx[..., None])[..., 0]``, keeping only ``idx``
    for the backward, which writes the gradient into zeros in place.
    Autograd's own gather keeps the whole (f32) logits for its backward,
    and that backward scatters out of place under any dispatch mode (the
    dry-run's memory pass), so that a count of it would hold a buffer of
    the logits' size that the card's step does not."""

    @staticmethod
    def forward(ctx, logits, idx):
        ctx.save_for_backward(idx)
        ctx.shape = logits.shape
        return logits.gather(-1, idx[..., None])[..., 0]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        grad = g.new_zeros(ctx.shape)
        grad.scatter_(-1, idx[..., None], g[..., None])
        return grad, None


@memory.kind("logits")
def cross_entropy(logits, labels, ignore: int = -1, axis=None):
    """Token-mean cross-entropy in f32, the reference's: the max taken without
    a gradient, labels equal to ``ignore`` masked out. The label's logit is
    gathered (the reference selects it with an iota compare and a sum over
    V, which adds only zeros to it: the same value). The exponentials are
    taken in place of the shifted logits, so that one (rows, V) f32 buffer
    fewer is live at once.

    With ``axis`` (``sharding.fsdp``'s installed ``model`` axis), ``logits``
    are this rank's slice of the vocabulary, columns [i n, (i + 1) n) at
    its index i: the max is taken over the ranks, the sum of exponentials
    and the label's logit (0 on every rank but its owner's) summed over
    them (``fsdp.tp_max``, ``fsdp.tp_sum``)."""
    logits = logits.float()
    m = logits.amax(dim=-1, keepdim=True).detach()
    mask = labels != ignore
    if axis is None:
        lse = torch.log((logits - m).exp_().sum(dim=-1)) + m[..., 0]
        ll = _PickLogit.apply(logits, torch.where(mask, labels, 0).long())
    else:
        m = fsdp.tp_max(m)
        lse = torch.log(fsdp.tp_sum((logits - m).exp_().sum(dim=-1))) + m[..., 0]
        n = logits.shape[-1]
        local = labels.long() - axis.index * n
        mine = mask & (local >= 0) & (local < n)
        ll = _PickLogit.apply(logits, torch.where(mine, local, 0))
        ll = fsdp.tp_sum(torch.where(mine, ll, 0))
    maskf = mask.float()
    return ((lse - ll) * maskf).sum() / maskf.sum().clamp(min=1.0)


def loss_tokens(cfg: ModelConfig, batch) -> torch.Tensor:
    """How many labels ``loss``'s cross-entropy averages over (before its
    clamp to 1), a 0-d int64 tensor: labels other than -1, for the audio
    family only where ``frame_mask``."""
    labels = batch["labels"]
    if cfg.family == "audio" and "frame_mask" in batch:
        labels = torch.where(batch["frame_mask"], labels, -1)
    return (labels != -1).sum()


def _load_balance_loss(router_logits, cfg: ModelConfig):
    """MoE's auxiliary term, the reference's ``_load_balance_loss``: E times
    the sum over experts of (the share of tokens whose top choice it is) x
    (its mean router probability). Under a batch split both means are over
    the dp group's tokens, as the reference's global call takes them: the
    rank's sums summed over the group (``sharding.fsdp.batch_sum``). The
    one-hot of the top choices is a comparison, as ``moe_dispatch``'s: no
    bounds check reads the indices on the host, and the op allocates the
    same on every device (the dry-run's memory pass)."""
    e = cfg.moe.num_experts
    probs = torch.softmax(router_logits.float(), dim=-1)
    top = (probs.argmax(dim=-1)[:, None] == torch.arange(e, device=probs.device)).float()
    batch = fsdp.batch_axes()
    if not batch:
        frac = top.mean(dim=0)
        return e * (frac * probs.mean(dim=0)).sum()
    n = probs.shape[0] * fsdp.batch_size(batch)
    frac = fsdp.batch_sum(top.sum(dim=0), batch) / n
    return e * (frac * (fsdp.batch_sum(probs.sum(dim=0), batch) / n)).sum()


def _transformer_fns(cfg: ModelConfig) -> ModelFns:
    L = cfg.num_layers
    hd = cfg.resolved_head_dim()

    def init(gen: torch.Generator):
        layers = {
            "attn_norm": init_norm(cfg, (L,), gen.device),
            "attn": init_attention(gen, cfg, (L,)),
            "mlp_norm": init_norm(cfg, (L,), gen.device),
        }
        if cfg.moe is not None:
            layers["moe"] = init_moe(gen, cfg, (L,))
        else:
            layers["mlp"] = init_mlp(gen, cfg, (L,))
        return {"head": _init_head(gen, cfg), "layers": layers}

    def _mlp_block(lp, x):
        """The reference's ``_mix_mlp``: (x + the MLP's output, the MoE
        layer's router logits, from which only ``loss`` takes the auxiliary
        term; None for a dense layer)."""
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        if cfg.moe is not None:
            out, router_logits = moe_apply(lp["moe"], h, cfg)
            return x + out, router_logits
        return x + mlp_apply(lp["mlp"], h), None

    def _layer(lp, x, positions, positions3, whole_kv=False):
        """One layer over the sequence: (x, (k, v), router logits or None);
        with ``whole_kv``, (k, v) of every KV head (``attention_apply``)."""
        h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        attn_out, kv = attention_apply(lp["attn"], h, cfg, positions=positions, positions3=positions3,
                                       whole_kv=whole_kv)
        x, router_logits = _mlp_block(lp, x + attn_out)
        return x, kv, router_logits

    def _loss_layer(lp, x, positions, positions3):
        """One layer of ``loss``: (x, its load-balance term, 0 if dense).
        Under the sharded step the layer's leaves are gathered here, inside
        remat's unit."""
        x, _, router_logits = _layer(_gather_tp(lp), x, positions, positions3)
        if router_logits is None:
            return x, torch.zeros((), dtype=torch.float32, device=x.device)
        return x, _load_balance_loss(router_logits, cfg)

    def _embed_inputs(params, batch):
        """(x, positions, positions3) as the reference's ``_embed_inputs``:
        audio frames (``embed[0]`` where ``frame_mask``), vision embeddings
        before the token embeddings with ``positions3[0]`` as positions (the
        attention's mask, on the card too), or token embeddings at 0..S-1."""
        if cfg.family == "audio":
            x = batch["frames"].to(common.dtype_of(cfg))
            if "frame_mask" in batch:
                x = torch.where(batch["frame_mask"][..., None], _embed(params, 0), x)
            b, s = x.shape[:2]
            return x, torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s), None
        tokens = batch["tokens"]
        x = _embed(params, tokens)
        if cfg.family == "vlm":
            x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
            positions3 = batch["positions3"]
            return x, positions3[0], positions3
        b, s = tokens.shape
        return x, torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s), None

    def _run_layers(params, x, positions, positions3, cache=None):
        """The layer stack over the embedded sequence x (B, S, d); with
        ``cache``, each layer's k/v are written into its slots 0..S-1. Under
        the sharded serving step each layer's leaves are gathered here, and
        a cache whose sequence ``model`` splits (``fsdp.seq_axis``) is the
        rank's shard, slots [r n, (r + 1) n): it takes the prompt's k/v
        there, of every rank that shares its rows (``fsdp.share_all_gather``)."""
        s = x.shape[1]
        seq = fsdp.seq_axis()
        for l, lp in enumerate(_layer_views(params["layers"], L)):
            x, (k, v), _ = _layer(_gather_tp(lp), x, positions, positions3, cache is not None)
            if cache is not None:
                start = seq.index * cache["k"].shape[2] if seq is not None else 0
                n = min(s - start, cache["k"].shape[2])
                if n > 0:
                    cache["k"][l, :, :n] = fsdp.share_all_gather(k[:, start : start + n])
                    cache["v"][l, :, :n] = fsdp.share_all_gather(v[:, start : start + n])
        return x

    def forward(params, batch):
        x = _run_layers(params, *_embed_inputs(params, batch))
        return _logits(params["head"], x, cfg)

    def loss(params, batch):
        x, positions, positions3 = _embed_inputs(params, batch)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for lp in _layer_views(params["layers"], L):
            x, aux_l = _remat(cfg, _loss_layer, lp, x, positions, positions3)
            aux = aux + aux_l
        aux = aux / L
        if cfg.family == "vlm":  # only text positions carry labels
            x = x[:, batch["vision_embeds"].shape[1] :, :]
        labels = batch["labels"]
        if cfg.family == "audio" and "frame_mask" in batch:
            labels = torch.where(batch["frame_mask"], labels, -1)
        ce = _head_loss(params["head"], x, labels, cfg)
        return ce + 0.01 * aux, {"ce": ce, "aux": aux}

    def init_cache(batch_size: int, max_seq: int, device="cuda"):
        dev = resolve_device(device)
        dt = common.dtype_of(cfg)
        shape = (L, batch_size, max_seq, cfg.num_kv_heads, hd)
        return {
            "k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "index": torch.zeros((), dtype=torch.int32, device=dev),
            "host_index": 0,
        }

    def prefill(params, batch, max_seq: Optional[int] = None):
        """Logits at the last position (B, 1, V) and a cache of
        ``max(max_seq, S)`` slots holding the prompt's k/v, zero past S; S is
        the embedded length (vision plus text for the VLM family). Under the
        sharded serving step: the rank's rows, logits whole over the
        vocabulary, and where ``model`` splits the cache's sequence the
        rank's shard of it (the rows of every rank that shares it)."""
        x, positions, positions3 = _embed_inputs(params, batch)
        b, s = x.shape[:2]
        smax, seq = prefill_slots(cfg, s, max_seq), fsdp.seq_axis()
        if seq is not None:
            assert smax % seq.size == 0, f"{smax} slots do not split {seq.size} ways"
            smax //= seq.size
        cache = init_cache(b * fsdp.share_size(), smax, x.device)
        x = _run_layers(params, x, positions, positions3, cache)
        cache["index"].fill_(s)
        cache["host_index"] = s
        return _serve_logits(params["head"], x[:, -1:, :], cfg), cache

    def decode_step(params, cache, batch):
        """One token per row at position ``cache["index"]``: logits (B, 1, V)
        and the cache, whose k/v were updated in place (the returned dict
        shares them with the one passed in) and whose index is one more.
        Raises IndexError, before it writes anything, when the cache is full
        (the reference clamps the write into the last slot). Under the
        sharded serving step: the rank's rows, each layer's leaves gathered
        here, the cache the rank's shard (``layers.attention_decode``)."""
        tokens = batch["tokens"]  # (B, 1)
        b = tokens.shape[0]
        n, seq = cache["k"].shape[2], fsdp.seq_axis()
        smax = n * seq.size if seq is not None else n
        host = cache["host_index"]
        if host >= smax:
            raise IndexError(f"decode_step: index {host} is out of bounds for a cache of {smax} slots")
        x = _embed(params, tokens)
        index = cache["index"]
        positions = index.expand(b, 1)
        # the reference's decode takes position = index on all three M-RoPE axes
        positions3 = index.expand(3, b, 1) if cfg.family == "vlm" else None
        # the rank's slots [r n, (r + 1) n); the token's k/v go to the rank that owns slot index
        r = seq.index if seq is not None else 0
        pages, write = kv_pages(index, b, n, start=r * n), host // n == r
        for l, lp in enumerate(_layer_views(params["layers"], L)):
            lp = _gather_tp(lp)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            attn_out, _ = attention_decode(
                lp["attn"], h, cfg, k_cache=cache["k"][l], v_cache=cache["v"][l],
                index=index, positions=positions, positions3=positions3, pages=pages, write=write,
            )
            x, _ = _mlp_block(lp, x + attn_out)
        logits = _serve_logits(params["head"], x, cfg)
        return logits, {"k": cache["k"], "v": cache["v"], "index": index + 1,
                        "host_index": cache["host_index"] + 1}

    return ModelFns(cfg, init, forward, loss, prefill, decode_step, init_cache)


def _ssm_fns(cfg: ModelConfig) -> ModelFns:
    """mamba2: the reference's ``_ssm_fns``. Params ``{"head", "layers":
    {"norm", "mixer"}}`` with the layers stacked on L; a constant-size decode
    cache."""
    L = cfg.num_layers
    width = cfg.ssm.conv_width

    def init(gen: torch.Generator):
        return {
            "head": _init_head(gen, cfg),
            "layers": {
                "norm": init_norm(cfg, (L,), gen.device),
                "mixer": ssm.init_ssm(gen, cfg, (L,)),
            },
        }

    def _run_layers(params, tokens, cache=None):
        """The layer stack over the whole sequence; with ``cache``, each
        layer's final state and conv tail are written into it (under the
        sharded serving step, the rank's heads and run of channels, of the
        rows of every rank that shares its shard)."""
        x = _embed(params, tokens)
        for l, lp in enumerate(_layer_views(params["layers"], L)):
            lp = _gather_tp(lp)
            h = rms_norm(x, lp["norm"], cfg.norm_eps)
            out, st = ssm.ssm_apply_with_state(lp["mixer"], h, cfg)
            if cache is not None:
                cache["state"][l] = fsdp.share_all_gather(st["state"])
                cache["conv"][l] = fsdp.share_all_gather(ssm.conv_history(lp["mixer"], st["conv"], cfg,
                                                                          cache["conv"].shape[-1]))
            x = x + out
        return x

    def forward(params, batch):
        return _logits(params["head"], _run_layers(params, batch["tokens"]), cfg)

    def _loss_layer(lp, x):
        lp = _gather_tp(lp)
        return x + ssm.ssm_apply(lp["mixer"], rms_norm(x, lp["norm"], cfg.norm_eps), cfg)

    def loss(params, batch):
        x = _embed(params, batch["tokens"])
        for lp in _layer_views(params["layers"], L):
            x = _remat(cfg, _loss_layer, lp, x)
        ce = _head_loss(params["head"], x, batch["labels"], cfg)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}

    def init_cache(batch_size: int, max_seq: int, device="cuda"):
        """``max_seq`` is not used: the decode state has a constant size.
        Under an installed ``model`` axis, the rank's heads of the state and
        its run of the conv channels (:func:`_tp_cut`)."""
        dev = resolve_device(device)
        _, n_heads, conv_dim = ssm.dims(cfg)
        s = cfg.ssm
        return {"state": torch.zeros((L, batch_size, _tp_cut(n_heads), s.head_dim, s.state_dim),
                                     dtype=torch.float32, device=dev),
                "conv": torch.zeros((L, batch_size, width - 1, _tp_cut(conv_dim)), dtype=common.dtype_of(cfg),
                                    device=dev),
                "index": torch.zeros((), dtype=torch.int32, device=dev), "host_index": 0}

    def prefill(params, batch, max_seq: Optional[int] = None):
        """Logits at the last position (B, 1, V) and the decode cache after the
        prompt. Raises ValueError for a prompt shorter than ``conv_width - 1``
        tokens: its conv tail would be short, and the reference's decode
        cannot read the cache the reference builds there. Under the sharded
        serving step: the rank's rows, logits whole over the vocabulary,
        the rank's shard of the cache."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s < width - 1:
            raise ValueError(f"prefill: {cfg.name} needs a prompt of at least {width - 1} tokens, got {s}")
        cache = init_cache(b * fsdp.share_size(), s, tokens.device)
        x = _run_layers(params, tokens, cache)
        cache["index"].fill_(s)
        cache["host_index"] = s
        return _serve_logits(params["head"], x[:, -1:, :], cfg), cache

    def decode_step(params, cache, batch):
        """One token per row: logits (B, 1, V) and the cache, whose state and
        conv history were updated in place (the returned dict shares them with
        the one passed in) and whose index is one more. Under the sharded
        serving step: the rank's rows of its cache shard, each layer's leaves
        gathered here (``ssm.ssm_decode``)."""
        x = _embed(params, batch["tokens"])
        for l, lp in enumerate(_layer_views(params["layers"], L)):
            lp = _gather_tp(lp)
            h = rms_norm(x, lp["norm"], cfg.norm_eps)
            rows = {k: fsdp.share_rows(cache[k][l]) for k in ("state", "conv")}
            out, _ = ssm.ssm_decode(lp["mixer"], h, rows, cfg)
            if fsdp.share_size() > 1:
                for k, t in rows.items():
                    cache[k][l].copy_(fsdp.share_all_gather(t))
            x = x + out
        logits = _serve_logits(params["head"], x, cfg)
        return logits, {"state": cache["state"], "conv": cache["conv"], "index": cache["index"] + 1,
                        "host_index": cache["host_index"] + 1}

    return ModelFns(cfg, init, forward, loss, prefill, decode_step, init_cache)


def _hybrid_counts(cfg: ModelConfig):
    kinds = cfg.layer_kinds()
    n_rec = sum(1 for k in kinds if k == "rec")
    n_attn = sum(1 for k in kinds if k == "attn")
    pat = cfg.rglru.pattern
    n_groups = cfg.num_layers // len(pat)
    n_rem = cfg.num_layers - n_groups * len(pat)
    return kinds, n_rec, n_attn, n_groups, n_rem


def _hybrid_fns(cfg: ModelConfig) -> ModelFns:
    """recurrentgemma: the reference's ``_hybrid_fns``. ``n_groups`` groups of
    (rec, rec, attn) layers, then ``n_rem`` trailing recurrent layers; params
    ``{"head", "rec_layers", "attn_layers"}``, each stack on its own leading
    axis (recurrent layer 2g and 2g + 1 and attention layer g make group g).
    The attention layers are local (``cfg.rglru.window``); their decode cache
    is a ring of ``w = min(window, S)`` slots after a prefill of S tokens, as
    the reference sizes it (``max_seq`` is not read), and the recurrent
    layers carry ``h`` (f32) and the last ``conv_width - 1`` conv inputs."""
    _, n_rec, n_attn, n_groups, n_rem = _hybrid_counts(cfg)
    assert cfg.rglru.pattern == ("rec", "rec", "attn")
    window = cfg.rglru.window
    width = cfg.rglru.conv_width
    hd = cfg.resolved_head_dim()

    def init(gen: torch.Generator):
        dev = gen.device
        return {
            "head": _init_head(gen, cfg),
            "rec_layers": {
                "norm": init_norm(cfg, (n_rec,), dev),
                "rec": rglru.init_rec_block(gen, cfg, (n_rec,)),
                "mlp_norm": init_norm(cfg, (n_rec,), dev),
                "mlp": init_mlp(gen, cfg, (n_rec,)),
            },
            "attn_layers": {
                "norm": init_norm(cfg, (n_attn,), dev),
                "attn": init_attention(gen, cfg, (n_attn,)),
                "mlp_norm": init_norm(cfg, (n_attn,), dev),
                "mlp": init_mlp(gen, cfg, (n_attn,)),
            },
        }

    def _mlp(lp, x):
        return x + mlp_apply(lp["mlp"], rms_norm(x, lp["mlp_norm"], cfg.norm_eps))

    def _rec_apply(lp, x):
        """A recurrent layer over the sequence: (x, h_last, the conv tail)."""
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, h_new, xr = rglru.rec_block_with_input(lp["rec"], h, cfg)
        return _mlp(lp, x + out), h_new, xr[:, -(width - 1) :]

    def _attn_apply(lp, x, positions, whole_kv=False):
        """An attention layer over the sequence: (x, (k, v)); with
        ``whole_kv``, every KV head (``attention_apply``)."""
        h = rms_norm(x, lp["norm"], cfg.norm_eps)
        out, kv = attention_apply(lp["attn"], h, cfg, positions=positions, window=window, whole_kv=whole_kv)
        return _mlp(lp, x + out), kv

    def _views(params):
        """The recurrent and the attention layers' views (:func:`_layer_views`)."""
        return _layer_views(params["rec_layers"], n_rec), _layer_views(params["attn_layers"], n_attn)

    def _order():
        """The layers in the order they run: ("rec", i) or ("attn", g)."""
        for g in range(n_groups):
            yield from (("rec", 2 * g), ("rec", 2 * g + 1), ("attn", g))
        for i in range(n_rem):
            yield "rec", 2 * n_groups + i

    def _run_full(params, tokens, cache=None):
        """The layer stack over the whole sequence; with ``cache``, each
        recurrent layer's state and conv tail and each attention layer's last
        ``w`` k/v, in ring order, are written into it. Under the sharded
        serving step each layer's leaves are gathered here, and the cache is
        the rank's shard: its channels of the state and conv tail, and,
        where ``model`` splits the ring (``fsdp.seq_axis``), its slots [r n,
        (r + 1) n) of it, cut after the roll; of the rows of every rank that
        shares it (``fsdp.share_all_gather``)."""
        x = _embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        recs, attns = _views(params)
        seq = fsdp.seq_axis()
        for kind, i in _order():
            if kind == "rec":
                x, h, tail = _rec_apply(_gather_tp(recs[i]), x)
                if cache is not None:
                    cache["h"][i] = fsdp.share_all_gather(h)
                    cache["conv"][i] = fsdp.share_all_gather(tail)
            else:
                x, kv = _attn_apply(_gather_tp(attns[i]), x, positions, cache is not None)
                if cache is not None:
                    for key, t in zip(("k", "v"), kv):
                        cache[key][i] = fsdp.share_all_gather(_seed_ring(t, cache["k"].shape[2], seq))
        return x

    def _seed_ring(t, n, seq):
        """The reference's seed_ring of the prompt's k or v ``t`` (B, S, Hkv,
        hd): its last ``w`` positions in ring order, w = n, or n times the
        size of ``seq`` where that axis splits the ring: then the rank's n
        slots of it."""
        s, w = t.shape[1], n * seq.size if seq is not None else n
        ring = torch.roll(t[:, -w:], (s - w) % w, dims=1)
        return ring if seq is None else ring[:, seq.index * n : (seq.index + 1) * n]

    def forward(params, batch):
        return _logits(params["head"], _run_full(params, batch["tokens"]), cfg)

    def _loss_group(r0, r1, attn, x, positions):
        """One (rec, rec, attn) group of ``loss``, the reference's remat unit,
        its leaves gathered together under the sharded step."""
        g = _gather_tp({"r0": r0, "r1": r1, "attn": attn})
        x = _rec_apply(g["r0"], x)[0]
        x = _rec_apply(g["r1"], x)[0]
        return _attn_apply(g["attn"], x, positions)[0]

    def loss(params, batch):
        tokens = batch["tokens"]
        x = _embed(params, tokens)
        b, s = tokens.shape
        positions = torch.arange(s, dtype=torch.int32, device=x.device).expand(b, s)
        recs, attns = _views(params)
        for g in range(n_groups):
            x = _remat(cfg, _loss_group, recs[2 * g], recs[2 * g + 1], attns[g], x, positions)
        for i in range(n_rem):  # the trailing recurrent layers, outside the reference's remat scan
            x = _rec_apply(_gather_tp(recs[2 * n_groups + i]), x)[0]
        ce = _head_loss(params["head"], x, batch["labels"], cfg)
        return ce, {"ce": ce, "aux": torch.zeros((), dtype=torch.float32, device=ce.device)}

    def init_cache(batch_size: int, max_seq: int, device="cuda"):
        """A ring of ``min(window, max_seq)`` slots; under an installed
        ``model`` axis, the rank's channels of the recurrent state and conv
        history (:func:`_tp_cut`)."""
        dev = resolve_device(device)
        dt = common.dtype_of(cfg)
        kv = (n_attn, batch_size, min(window, max_seq), cfg.num_kv_heads, hd)
        return {
            "h": torch.zeros((n_rec, batch_size, _tp_cut(cfg.d_model)), dtype=torch.float32, device=dev),
            "conv": torch.zeros((n_rec, batch_size, width - 1, _tp_cut(cfg.d_model)), dtype=dt, device=dev),
            "k": torch.zeros(kv, dtype=dt, device=dev),
            "v": torch.zeros(kv, dtype=dt, device=dev),
            "index": torch.zeros((), dtype=torch.int32, device=dev),
            "host_index": 0,
        }

    def prefill(params, batch, max_seq: Optional[int] = None):
        """Logits at the last position (B, 1, V) and the decode cache after the
        prompt: a ring of ``min(window, S)`` slots, as the reference sizes it
        (``max_seq`` is not read; a prompt shorter than the window gets a ring
        of S slots, whose first decode step overwrites position 0). Raises
        ValueError for a prompt shorter than ``conv_width - 1`` tokens: its
        conv tail would be short, and the reference's decode cannot read the
        cache the reference builds there. Under the sharded serving step:
        the rank's rows, logits whole over the vocabulary, the rank's shard
        of the cache (:func:`_run_full`)."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        if s < width - 1:
            raise ValueError(f"prefill: {cfg.name} needs a prompt of at least {width - 1} tokens, got {s}")
        w, seq = min(window, prefill_slots(cfg, s, max_seq)), fsdp.seq_axis()
        if seq is not None:
            assert w % seq.size == 0, f"a ring of {w} slots does not split {seq.size} ways"
            w //= seq.size
        cache = init_cache(b * fsdp.share_size(), w, tokens.device)
        x = _run_full(params, tokens, cache)
        cache["index"].fill_(s)
        cache["host_index"] = s
        return _serve_logits(params["head"], x[:, -1:, :], cfg), cache

    def decode_step(params, cache, batch):
        """One token per row at position ``cache["index"]``: logits (B, 1, V)
        and the cache, whose state, conv history and k/v rings were updated in
        place (the returned dict shares them with the one passed in) and whose
        index is one more. A ring never fills, so there is no bound to check.
        Under the sharded serving step: the rank's rows of its cache shard,
        each layer's leaves gathered here; where ``model`` splits the ring
        (``fsdp.seq_axis``), the token's k / v go to the rank that owns slot
        ``index % w`` (from ``host_index``: no device sync), and each rank
        attends over its slots (``layers.attention_decode``)."""
        x = _embed(params, batch["tokens"])
        b = x.shape[0]
        index = cache["index"]
        positions = index.expand(b, 1)
        n, seq = cache["k"].shape[2], fsdp.seq_axis()
        # the rank's slots [r n, (r + 1) n) of a ring of w
        r, w = (seq.index, n * seq.size) if seq is not None else (0, n)
        pages = kv_pages(index, b, n, ring=True, start=r * n, whole=w)
        write = cache["host_index"] % w // n == r
        recs, attns = _views(params)
        for kind, i in _order():
            if kind == "rec":
                lp = _gather_tp(recs[i])
                h = rms_norm(x, lp["norm"], cfg.norm_eps)
                h_prev, conv = fsdp.share_rows(cache["h"][i]), fsdp.share_rows(cache["conv"][i])
                out, h_new, conv_new = rglru.rec_block_decode(lp["rec"], h, h_prev, cfg, conv)
                cache["h"][i] = fsdp.share_all_gather(h_new)
                cache["conv"][i] = fsdp.share_all_gather(conv_new)
                x = _mlp(lp, x + out)
            else:
                lp = _gather_tp(attns[i])
                h = rms_norm(x, lp["norm"], cfg.norm_eps)
                out, _ = attention_decode(
                    lp["attn"], h, cfg, k_cache=cache["k"][i], v_cache=cache["v"][i],
                    index=index, positions=positions, window=window, ring=True, pages=pages, write=write,
                )
                x = _mlp(lp, x + out)
        logits = _serve_logits(params["head"], x, cfg)
        return logits, {"h": cache["h"], "conv": cache["conv"], "k": cache["k"], "v": cache["v"],
                        "index": index + 1, "host_index": cache["host_index"] + 1}

    return ModelFns(cfg, init, forward, loss, prefill, decode_step, init_cache)


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family == "ssm":
        return _ssm_fns(cfg)
    if cfg.family == "hybrid":
        return _hybrid_fns(cfg)
    return _transformer_fns(cfg)
