"""Deterministic, shardable token pipeline: a copy of the JAX package's
``data/pipeline.py`` (numpy only), whose batches it gives bit for bit.

Sources: synthetic LM stream (hash-mixed, reproducible across restarts and
mesh shapes) or a binary token file (memory-mapped). The iterator state is a
single integer step, so checkpoint/restore and elastic re-mesh resume exactly
(no hidden RNG state) — the fault-tolerance substrate depends on this.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig, ShapeSpec


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    token_file: Optional[str] = None  # raw int32 tokens; else synthetic


class TokenPipeline:
    """step -> batch dict {tokens, labels}; pure function of (config, step)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._mmap = None
        if cfg.token_file:
            self._mmap = np.memmap(cfg.token_file, dtype=np.int32, mode="r")

    def _synthetic(self, step: int) -> np.ndarray:
        c = self.cfg
        n = c.global_batch * (c.seq_len + 1)
        base = np.arange(n, dtype=np.uint64) + np.uint64(step) * np.uint64(n)
        mixed = (base * np.uint64(2654435761) + np.uint64(c.seed)) % np.uint64(
            2**31 - 1
        )
        toks = (mixed % np.uint64(max(c.vocab_size - 2, 1))).astype(np.int32) + 1
        return toks.reshape(c.global_batch, c.seq_len + 1)

    def _from_file(self, step: int) -> np.ndarray:
        c = self.cfg
        n = c.global_batch * (c.seq_len + 1)
        start = (step * n) % max(len(self._mmap) - n, 1)
        return np.asarray(self._mmap[start : start + n]).reshape(
            c.global_batch, c.seq_len + 1
        )

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        toks = self._from_file(step) if self._mmap is not None else self._synthetic(step)
        return {
            "tokens": np.ascontiguousarray(toks[:, :-1]),
            "labels": np.ascontiguousarray(toks[:, 1:]),
        }

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1


def pipeline_for(cfg: ModelConfig, shape: ShapeSpec, seed: int = 0) -> TokenPipeline:
    return TokenPipeline(
        DataConfig(
            seq_len=shape.seq_len,
            global_batch=shape.global_batch,
            vocab_size=cfg.vocab_size,
            seed=seed,
        )
    )
