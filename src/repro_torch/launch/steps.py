"""Step builders for serving: the counterparts of the JAX package's
``make_prefill_step`` and ``make_serve_step`` (``launch/steps.py``).

Each returns a plain function over the port's params, cache and batch; the
device is that of the tensors it is given. ``prefill_step`` also takes the
cache size ``max_seq``, which the reference's leaves at the prompt length
(its decode then clamps the write into the last slot; the port's raises).
The train and dry-run builders are not ported yet (ROADMAP.md §1).
"""
from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model


def make_prefill_step(cfg: ModelConfig):
    """Prefill: ``prefill_step(params, batch, max_seq=None) -> (last_logits, cache)``."""
    return build_model(cfg).prefill


def make_serve_step(cfg: ModelConfig):
    """Decode: ``serve_step(params, cache, batch) -> (logits, cache)``, one new
    token per row against the cache, which it updates in place."""
    return build_model(cfg).decode_step
