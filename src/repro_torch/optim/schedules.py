"""LR schedules: cosine and WSD (Warmup-Stable-Decay, MiniCPM
arXiv:2404.06395), the JAX package's ``optim/schedules.py``. ``lr(step)``
takes a 0-d tensor (or a number) and returns a 0-d f32 tensor on its
device, computed there."""
from __future__ import annotations

import math

import torch


def _step(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def cosine_schedule(peak_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return lr


def wsd_schedule(peak_lr: float, warmup: int, total: int, decay_frac: float = 0.1, min_ratio: float = 0.01):
    """Warmup -> Stable (constant) -> Decay (the last ``decay_frac`` of the
    steps, linearly down to ``min_ratio * peak``)."""
    decay_steps = max(int(total * decay_frac), 1)
    decay_start = total - decay_steps

    def lr(step):
        step = _step(step)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        decay = peak_lr * (1.0 - (1.0 - min_ratio) * frac)
        stable = torch.full_like(step, peak_lr)
        return torch.where(step < warmup, warm, torch.where(step < decay_start, stable, decay))

    return lr


def get_schedule(name: str, peak_lr: float, warmup: int, total: int):
    if name == "cosine":
        return cosine_schedule(peak_lr, warmup, total)
    if name == "wsd":
        return wsd_schedule(peak_lr, warmup, total)
    raise KeyError(name)
