"""Model assembly for the dense family, with the reference's contract:

  init(generator)                     -> params
  forward(params, batch)              -> logits (B, S, V)
  prefill(params, batch, max_seq)     -> (last_logits, cache)
  decode_step(params, cache, batch)   -> (logits, cache)        [one token]
  init_cache(batch, max_seq, device)  -> cache

Counterpart of the JAX package's ``models/model.py``. Params keep the
reference's tree and stacked-layer layout: ``head`` holds
``embed``/``lm_head``/``final_norm`` and every leaf under ``layers`` has a
leading ``L`` axis, walked by a Python loop over ``[l]`` views (the JAX
package scans it). The cache is the reference's too: ``{"k", "v"}`` of shape
(L, B, Smax, Hkv, hd) and a 0-d int32 ``index``; ``prefill`` and
``decode_step`` write into it in place. It also carries ``host_index``, the
same position as a Python int, so that a step checks its bounds without
waiting for the device. ``loss`` and the other families are
not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import resolve_device, rms_norm
from repro_torch.models.layers import (
    attention_apply,
    attention_decode,
    init_attention,
    init_mlp,
    init_norm,
    kv_pages,
    linear,
    mlp_apply,
)


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable
    forward: Callable
    prefill: Callable
    decode_step: Callable
    init_cache: Callable


def _init_head(gen: torch.Generator, cfg: ModelConfig):
    dt = common.dtype_of(cfg)
    d, v = cfg.d_model, cfg.vocab_size
    return {
        "embed": common.embed_init(gen, (v, d), dt),
        "lm_head": common.dense_init(gen, (d, v), dt, fan_in=d),
        "final_norm": init_norm(cfg, device=gen.device),
    }


def _logits(p, x, cfg: ModelConfig):
    x = rms_norm(x, p["final_norm"], cfg.norm_eps)
    return linear(x, p["lm_head"])


def _layer_view(tree, l: int):
    return {k: _layer_view(v, l) if isinstance(v, dict) else v[l] for k, v in tree.items()}


def _transformer_fns(cfg: ModelConfig) -> ModelFns:
    L = cfg.num_layers
    hd = cfg.resolved_head_dim()

    def init(gen: torch.Generator):
        return {
            "head": _init_head(gen, cfg),
            "layers": {
                "attn_norm": init_norm(cfg, (L,), gen.device),
                "attn": init_attention(gen, cfg, (L,)),
                "mlp_norm": init_norm(cfg, (L,), gen.device),
                "mlp": init_mlp(gen, cfg, (L,)),
            },
        }

    def _mlp_block(lp, x):
        h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        return x + mlp_apply(lp["mlp"], h)

    def _run_layers(params, tokens, cache=None):
        """The layer stack over the whole sequence; with ``cache``, each
        layer's k/v are written into its slots 0..S-1."""
        b, s = tokens.shape
        x = params["head"]["embed"][tokens]
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        for l in range(L):
            lp = _layer_view(params["layers"], l)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            attn_out, (k, v) = attention_apply(lp["attn"], h, cfg, positions=positions)
            if cache is not None:
                cache["k"][l, :, :s] = k
                cache["v"][l, :, :s] = v
            x = _mlp_block(lp, x + attn_out)
        return x

    def forward(params, batch):
        return _logits(params["head"], _run_layers(params, batch["tokens"]), cfg)

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
        ``max(max_seq, S)`` slots holding the prompt's k/v, zero past S."""
        tokens = batch["tokens"]
        b, s = tokens.shape
        cache = init_cache(b, max(max_seq or s, s), tokens.device)
        x = _run_layers(params, tokens, cache)
        cache["index"].fill_(s)
        cache["host_index"] = s
        return _logits(params["head"], x[:, -1:, :], cfg), cache

    def decode_step(params, cache, batch):
        """One token per row at position ``cache["index"]``: logits (B, 1, V)
        and the cache, whose k/v were updated in place (the returned dict
        shares them with the one passed in) and whose index is one more.
        Raises IndexError, before it writes anything, when the cache is full
        (the reference clamps the write into the last slot)."""
        tokens = batch["tokens"]  # (B, 1)
        b = tokens.shape[0]
        smax = cache["k"].shape[2]
        if cache["host_index"] >= smax:
            raise IndexError(
                f"decode_step: index {cache['host_index']} is out of bounds for a cache of {smax} slots"
            )
        x = params["head"]["embed"][tokens]
        index = cache["index"]
        positions = index.expand(b, 1)
        pages = kv_pages(index, b, smax)
        for l in range(L):
            lp = _layer_view(params["layers"], l)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            attn_out, _ = attention_decode(
                lp["attn"], h, cfg, k_cache=cache["k"][l], v_cache=cache["v"][l],
                index=index, positions=positions, pages=pages,
            )
            x = _mlp_block(lp, x + attn_out)
        logits = _logits(params["head"], x, cfg)
        return logits, {"k": cache["k"], "v": cache["v"], "index": index + 1,
                        "host_index": cache["host_index"] + 1}

    return ModelFns(cfg, init, forward, prefill, decode_step, init_cache)


def build_model(cfg: ModelConfig) -> ModelFns:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet "
            "(ROADMAP.md §1, 'Modules still to port')"
        )
    if cfg.tie_embeddings:
        raise NotImplementedError(
            f"{cfg.name}: tied embeddings are not ported yet (ROADMAP.md §1)"
        )
    return _transformer_fns(cfg)
