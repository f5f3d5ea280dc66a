"""Per-device costs of one step under the port's sharding scheme: the
counterpart of the JAX package's ``roofline/hlo_costs.py``.

The reference parses the partitioned HLO that XLA compiled for one device
and counts what XLA chose to run. The port has no HLO, and these figures are
the port's own scheme, not XLA's:

* dot FLOPs: ``torch.utils.flop_counter.FlopCounterMode`` over the step's
  products on the meta device (shapes only), with autograd's backward and
  remat's replay; the other ops (elementwise, reductions, gathers) are not
  counted, as ``hlo_costs`` counts only ``dot``. A model's layers are one
  stacked tree, so each period of the layer pattern adds the same products:
  :func:`depth_flops` counts the model at one and two periods (with any
  trailing layers) and extends that line to the published depth.
* collective bytes and counts by kind. For training, every collective
  that one rank's sharded train step issues (``launch/steps.py``,
  ``sharding/fsdp.py``), noted as the dry-run's memory pass runs the step
  on meta (``fsdp.recording`` into :meth:`Plan.note`), remat's replay and
  its early stop included: the leaves' gathers (over ``data``, and over
  ``model`` where a layer computes with the whole leaf), their gradients'
  reduce-scatters and all-reduces, the activations' sums and gathers over
  ``model`` where a product is split over it (two all-reduces a
  transformer layer forward and two backward, the K/V gathers, the
  embedding's and the cross-entropy's sums), MoE's count tables and
  load-balance sums over the dp group, the optimizer's and the clip norm's
  sums over a leaf's shards, the label count, loss and ``ce``. An
  all-gather moves its result less its operand, a reduce-scatter its
  operand less its result, an all-reduce twice its operand (a ring, the
  reference's model). Serving steps gather the parameters and, for decode,
  each rank's rows of the cache along the axes that split its sequence or
  heads (:meth:`Plan.gather`); the port has no sharded serving step, so
  these are the figures of a gather-before-use scheme applied to it.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Iterable, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_shape

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")


@dataclasses.dataclass
class StepCosts:
    dot_flops: float
    collective_bytes: Dict[str, float]
    collective_counts: Dict[str, float]
    while_loops: int = 0  # the port's layer loops are Python loops: no device-side loop to correct for


def dot_flops(fn: Callable, *args) -> int:
    """The products' FLOPs of ``fn(*args)`` (2 M N K a product, as
    ``hlo_costs`` counts a dot), with any backward it runs."""
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args)
    return counter.get_total_flops()


def depth_period(cfg: ModelConfig) -> Tuple[int, int]:
    """(layers a period of the layer pattern, trailing layers): the hybrid's
    (rec, rec, attn) groups and the recurrent layers after the last one;
    one layer, none trailing, for the others."""
    if cfg.rglru is not None:
        p = len(cfg.rglru.pattern)
        return p, cfg.num_layers % p
    return 1, 0


def depth_flops(cfg: ModelConfig, count: Callable[[ModelConfig], int]) -> int:
    """``count(cfg)`` at the published depth from ``count`` at one and two
    periods of the layer pattern: every period adds the same products."""
    p, r = depth_period(cfg)
    n = (cfg.num_layers - r) // p
    one = count(dataclasses.replace(cfg, num_layers=p + r))
    if n <= 1:
        return one
    two = count(dataclasses.replace(cfg, num_layers=2 * p + r))
    return one + (n - 1) * (two - one)


def _bytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


def gathered_shape(shape, sharding, keep_dims: Iterable[int] = ()) -> Tuple[int, ...]:
    """The shape a rank holds after gathering a leaf over every axis that
    splits it, except those of ``keep_dims``."""
    shard = sharding.shard_shape(shape)
    return tuple(shard[d] if d in keep_dims else n for d, n in enumerate(shape))


class Plan:
    """Collective bytes and counts a device moves in one step, by kind."""

    def __init__(self, mesh):
        self.sizes = mesh_shape(mesh).shape
        self.bytes = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0.0 for k in COLLECTIVES}

    def gather(self, shape, dtype, sharding, keep_dims: Iterable[int] = ()) -> int:
        """One all-gather per mesh axis of size > 1 that splits the leaf
        (outside ``keep_dims``), moving the gathered size less the shard.
        Returns the bytes the gathered copy adds on the device."""
        keep = tuple(keep_dims)
        axes = [a for d in range(len(shape)) if d not in keep for a in sharding.axes(d) if self.sizes[a] > 1]
        if not axes:
            return 0
        moved = _bytes(gathered_shape(shape, sharding, keep), dtype) - _bytes(sharding.shard_shape(shape), dtype)
        self.bytes["all-gather"] += moved
        self.counts["all-gather"] += len(axes)
        return moved

    def note(self, kind: str, operand: int, result: int) -> None:
        """One collective of ``kind`` over an axis of size > 1, from
        ``operand`` bytes to ``result`` bytes on this device."""
        moved = {"all-gather": result - operand, "reduce-scatter": operand - result,
                 "all-reduce": 2 * operand}[kind]
        self.bytes[kind] += moved
        self.counts[kind] += 1

    def costs(self, flops: int) -> StepCosts:
        return StepCosts(float(flops), dict(self.bytes), dict(self.counts))
