"""Input specs per (arch x shape) and concrete random batches for them.

Counterpart of the JAX package's ``launch/specs.py``: :func:`batch_spec`
gives each input's shape and dtype as a plain ``(shape, torch.dtype)`` pair,
and :func:`make_concrete_batch` draws the reference's batch from the same
numpy generator, in the same key order, so that one seed gives both packages
the same values; the tensors land on ``device``.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models import common
from repro_torch.models.common import resolve_device

VISION_FRACTION = 8  # qwen2-vl: 1/8 of the sequence is vision patches

Spec = Tuple[Tuple[int, ...], torch.dtype]


def batch_spec(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Spec]:
    """{input name: (shape, dtype)} for ``forward``/``prefill``/``decode_step``."""
    b, s = shape.global_batch, shape.seq_len
    dt = common.dtype_of(cfg)
    i32 = torch.int32

    if shape.kind == "decode":
        # the VLM family's decode positions derive from the cache index
        return {"tokens": ((b, 1), i32)}

    if cfg.family == "audio":
        spec = {"frames": ((b, s, cfg.d_model), dt), "frame_mask": ((b, s), torch.bool)}
        if shape.kind == "train":
            spec["labels"] = ((b, s), i32)
        return spec

    if cfg.family == "vlm":
        s_vis = s // VISION_FRACTION
        s_text = s - s_vis
        spec = {
            "tokens": ((b, s_text), i32),
            "vision_embeds": ((b, s_vis, cfg.d_model), dt),
            "positions3": ((3, b, s), i32),
        }
        if shape.kind == "train":
            spec["labels"] = ((b, s_text), i32)
        return spec

    spec = {"tokens": ((b, s), i32)}
    if shape.kind == "train":
        spec["labels"] = ((b, s), i32)
    return spec


def make_concrete_batch(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0, device="cuda"):
    """A random batch matching :func:`batch_spec`, the reference's values:
    tokens and labels uniform in [1, V), positions3 0..S-1 on all three axes,
    frame masks at 30%, embeddings standard normal."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for name, (shp, dtype) in batch_spec(cfg, shape).items():
        if name in ("tokens", "labels"):
            a = rng.integers(1, cfg.vocab_size, size=shp, dtype=np.int32)
        elif name == "positions3":
            _, b, s = shp
            a = np.broadcast_to(np.arange(s, dtype=np.int32), (3, b, s)).copy()
        elif name == "frame_mask":
            a = rng.random(shp) < 0.3
        else:  # float embeddings
            a = rng.standard_normal(shp)
        out[name] = torch.from_numpy(a).to(dtype).to(dev)
    return out
