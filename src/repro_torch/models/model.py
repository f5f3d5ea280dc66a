"""Model assembly: ``init(generator)`` and ``forward(params, batch)``.

Counterpart of the JAX package's ``models/model.py`` for the dense family.
Params keep the reference's tree and stacked-layer layout: ``head`` holds
``embed``/``lm_head``/``final_norm`` and every leaf under ``layers`` has a
leading ``L`` axis, walked by a Python loop over ``[l]`` views (the JAX
package scans it). Other families are not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.models.common import rms_norm
from repro_torch.models.layers import (
    attention_apply,
    init_attention,
    init_mlp,
    init_norm,
    linear,
    mlp_apply,
)


@dataclasses.dataclass(frozen=True)
class ModelFns:
    cfg: ModelConfig
    init: Callable
    forward: Callable


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

    def forward(params, batch):
        tokens = batch["tokens"]  # (B, S) int
        b, s = tokens.shape
        x = params["head"]["embed"][tokens]
        positions = torch.arange(s, dtype=torch.int32, device=tokens.device).expand(b, s)
        for l in range(L):
            lp = _layer_view(params["layers"], l)
            h = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
            attn_out, _ = attention_apply(lp["attn"], h, cfg, positions=positions)
            x = x + attn_out
            h = rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
            x = x + mlp_apply(lp["mlp"], h)
        return _logits(params["head"], x, cfg)

    return ModelFns(cfg, init, forward)


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
