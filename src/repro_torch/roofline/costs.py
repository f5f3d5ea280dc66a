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
* collective bytes and counts by kind: every collective that one rank's
  sharded step issues (``launch/steps.py``, ``sharding/fsdp.py``), noted
  as the dry-run's memory pass runs the step on meta (``fsdp.recording``
  into :meth:`Plan.note`). For training, remat's replay and its early stop
  included: the leaves' gathers (over ``data``, and over ``model`` where a
  layer computes with the whole leaf), their gradients' reduce-scatters
  and all-reduces, the activations' sums and gathers over ``model`` where
  a product is split over it (two all-reduces a transformer layer forward
  and two backward, the K/V gathers, the RG-LRU's gate inputs gathered,
  the SSM's projection exchanged and its gated norm's sums of squares,
  the embedding's and the cross-entropy's sums), MoE's count tables and
  load-balance sums over the dp group, the optimizer's and the clip
  norm's sums over a leaf's shards, the label count, loss and ``ce``. For
  serving, rank 0's sharded prefill and decode
  (``launch/steps.make_sharded_prefill_step`` and
  ``make_sharded_serve_step``), every family: each layer's leaves gathered
  over ``data``, the products' sums, gathers and exchanges over ``model``,
  the cache heads and conv channels a prefill gathers, a decode token's q
  / k / v gathered whole and its attention merged over ``model``, the SSM
  decode's conv history gathered, the logits' vocabulary gathered. An
  all-gather moves its result less its operand, a reduce-scatter its
  operand less its result, an all-reduce twice its operand (a ring, the
  reference's model), an all-to-all what it sends to the other ranks.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ModelConfig

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


class Plan:
    """Collective bytes and counts a device moves in one step, by kind."""

    def __init__(self):
        self.bytes = {k: 0.0 for k in COLLECTIVES}
        self.counts = {k: 0.0 for k in COLLECTIVES}

    def note(self, kind: str, operand: int, result: int) -> None:
        """One collective of ``kind`` over an axis of size > 1, from
        ``operand`` bytes to ``result`` bytes on this device (for an
        all-to-all, those sent to and received from the other ranks)."""
        moved = {"all-gather": result - operand, "reduce-scatter": operand - result,
                 "all-reduce": 2 * operand, "all-to-all": operand}[kind]
        self.bytes[kind] += moved
        self.counts[kind] += 1

    def costs(self, flops: int) -> StepCosts:
        return StepCosts(float(flops), dict(self.bytes), dict(self.counts))
