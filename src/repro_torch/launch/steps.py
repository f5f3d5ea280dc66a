"""Step builders: the counterparts of the JAX package's ``make_train_state``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``
(``launch/steps.py``), and :func:`make_sharded_train_step`,
:func:`make_sharded_prefill_step` and :func:`make_sharded_serve_step`, the
counterparts of jitting them under shardings.

Each returns a plain function over the port's params, cache and batch; the
device is that of the tensors it is given. ``prefill_step`` also takes the
cache size ``max_seq``, which the reference's leaves at the prompt length
(its decode then clamps the write into the last slot; the port's raises).
The train step runs eagerly: it is not compiled as the reference's
``jax.jit`` compiles it (capturing it is ROADMAP.md §1 item 3).
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any, Callable, Dict

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.common import SHAPES_ONLY
from repro_torch.models.model import build_model, loss_tokens, prefill_slots
from repro_torch.optim import get_optimizer, get_schedule
from repro_torch.roofline import memory
from repro_torch.sharding import fsdp
from repro_torch.sharding.specs import batch_shardings, cache_shardings, leaf_split, local
from repro_torch.tree import leaves, tree_map, unflatten_like


def make_train_state(cfg: ModelConfig, generator: torch.Generator):
    """``{"params", "opt", "step"}``: params drawn from ``generator`` on its
    device, the config's optimizer state, ``step`` a 0-d int32 tensor. With
    ``models.common.SHAPES_ONLY`` for the generator, every tensor is on
    the meta device: shapes and dtypes, nothing drawn or allocated."""
    params = build_model(cfg).init(generator)
    opt = get_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=generator.device)}


def abstract_train_state(cfg: ModelConfig):
    """The train state on the meta device (the dry-run: no allocation)."""
    return make_train_state(cfg, SHAPES_ONLY)


def value_and_grad(fns, params, batch, split=None):
    """(loss, aux dict, gradients in flatten order) of ``fns.loss`` at
    ``params``, all detached; the gradients come out in the params' dtypes,
    zeros where a leaf took no part (the reference's ``jax.value_and_grad``
    with ``has_aux``).

    ``split`` (:class:`_Split`, the sharded step's): ``params`` are local
    shards and the gradients come out as shards (``sharding.fsdp``). Where
    it splits the batch, the loss is over this rank's rows, weighted before
    the backward by the rank's share of the labels (:func:`loss_tokens`
    over their sum on the dp group), so that the gradients' sums over the
    group, and the returned loss and ``ce``, are the global token-mean's."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    if split is None:
        loss, aux = fns.loss(unflatten_like(params, flat), batch)
        grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)
    axes = split.batch
    if axes:
        batch = split.rows(batch)
    with split.install(flat):
        loss, aux = fns.loss(unflatten_like(params, flat), batch)
        w = None
        if axes:
            n = loss_tokens(fns.cfg, batch).float()
            w = n / fsdp.batch_sum(n, axes).clamp(min=1.0)
        grads = torch.autograd.grad(loss if w is None else loss * w, flat, allow_unused=True,
                                    materialize_grads=True)
    if w is None:
        return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)

    def total(t):
        return fsdp.batch_sum(t.detach().float() * w, axes)

    return total(loss), {"ce": total(aux["ce"]), "aux": aux["aux"].detach()}, list(grads)


@dataclasses.dataclass(frozen=True)
class _Split:
    """How the sharded step cuts one call: each param leaf's
    ``fsdp.LeafAxes`` in flatten order, the axes of size > 1 that split the
    batch (major first), ``rows(batch)``, this rank's rows, ``tp``, the
    ``model`` axis where it has more than one rank (else None), and, for
    the serving steps, ``seq``, the axis that splits the KV cache's
    sequence (else None), and ``share``, the batch axes along which the
    cache is whole (:func:`serve_rows`)."""

    leaves: tuple
    batch: tuple
    rows: Callable
    tp: Any = None
    seq: Any = None
    share: tuple = ()

    def install(self, shards):
        """``fsdp.use_fsdp`` of this cut over ``shards``, the param leaves
        in flatten order."""
        return fsdp.use_fsdp(fsdp.Fsdp(shards, self.leaves, self.batch, self.tp, self.seq, self.share))


def make_train_step(
    cfg: ModelConfig,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    microbatches: int = 0,
):
    """``train_step(state, batch) -> (state, metrics)``, the reference's: the
    gradients of ``loss`` (with ``microbatches`` > 1, accumulated in f32 over
    that many slices of the batch along dim 0, or dim 1 for a leaf whose dim
    0 does not divide, as ``positions3`` (3, B, S), each divided by the
    count), the config's optimizer at the schedule's learning rate, and the
    metrics ``loss``, ``ce``, ``grad_norm`` (over the gradients in flatten
    order) and ``lr``, all 0-d f32 tensors on the device: nothing waits for
    the device. ``REPRO_MICROBATCH`` overrides a ``microbatches`` of 0, as in
    the reference. The optimizer updates the state's tensors in place (the
    reference's jitted step donates them) and the step returns them.

    With microbatches the reference reports ``ce`` as 0: its scan carries
    the loss but not the aux dict, and the port reports the same."""
    gradients, apply = _train_step_parts(cfg, peak_lr, warmup, total_steps, microbatches)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        loss, aux, grads = gradients(state["params"], batch)
        return apply(state, loss, aux, grads, grad_norm(grads))

    return train_step


def _train_step_parts(cfg: ModelConfig, peak_lr, warmup, total_steps, microbatches):
    """(gradients, apply) of :func:`make_train_step`'s step:
    ``gradients(params, batch, split=None) -> (loss, aux, grads)`` (grads in
    flatten order; ``split`` as :func:`value_and_grad`'s) and
    ``apply(state, loss, aux, grads, gnorm, splits=None) -> (state,
    metrics)``, the optimizer at the schedule's learning rate (``splits``:
    the optimizer's, for a state of shards). For the dry-run's memory pass
    (``roofline/memory.py``) the gradients are ``gradients`` and the
    optimizer's temporaries ``optimizer``."""
    fns = build_model(cfg)
    opt = get_optimizer(cfg.optimizer)
    sched = get_schedule(cfg.schedule, peak_lr, warmup, total_steps)
    n_micro = microbatches or int(os.environ.get("REPRO_MICROBATCH", "0") or 0)

    def _split(batch, i):
        def per(v):
            if v.dim() >= 1 and v.shape[0] % n_micro == 0:
                mb = v.shape[0] // n_micro
                return v[i * mb : (i + 1) * mb]
            if v.dim() >= 2 and v.shape[1] % n_micro == 0:  # positions3 (3, B, S)
                mb = v.shape[1] // n_micro
                return v[:, i * mb : (i + 1) * mb]
            return v

        return {k: per(v) for k, v in batch.items()}

    def gradients(params, batch, split=None):
        loss, aux, grads = _gradients(params, batch, split)
        memory.mark(grads, "gradients")
        return loss, aux, grads

    def _gradients(params, batch, split):
        if n_micro <= 1:
            return value_and_grad(fns, params, batch, split)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        aux = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
        for i in range(n_micro):  # under a split, each rank takes its rows of the reference's microbatch i
            loss_i, _, g = value_and_grad(fns, params, _split(batch, i), split)
            grads = [a + gi.to(a.dtype) / n_micro for a, gi in zip(grads, g)]
            loss = loss + loss_i / n_micro
        return loss, aux, grads

    @memory.kind("optimizer")
    def apply(state, loss, aux, grads, gnorm, splits=None):
        params = state["params"]
        lr = sched(state["step"])
        new_params, new_opt = opt.update(unflatten_like(params, grads), state["opt"], params, lr, splits)
        metrics = {"loss": loss.float(), "ce": aux["ce"].float(), "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return gradients, apply


@memory.kind("optimizer")
def grad_norm(grads, splits=None) -> torch.Tensor:
    """The f32 norm of the gradients in flatten order; with ``splits``
    (``sharding.specs.LeafSplit`` or None a leaf) each gradient is a shard,
    its sum of squares summed over the ranks that split its leaf: each holds
    a distinct part of it. A rank holds the whole gradient of a leaf that
    an axis does not split (the sharded step's gathers sum it over the
    batch and ``model``), so that axis is not summed over: the leaf counts
    once."""
    splits = splits or [None] * len(grads)
    return torch.sqrt(sum(_square_sum(g) if s is None else s.reduce(_square_sum(g)) for g, s in zip(grads, splits)))


def make_sharded_train_step(
    cfg: ModelConfig,
    mesh,
    peak_lr: float = 3e-4,
    warmup: int = 100,
    total_steps: int = 10_000,
    microbatches: int = 0,
):
    """``train_step(state, batch) -> (state, metrics)`` over a state placed on
    ``mesh`` (a ``DeviceMesh``; ``sharding.specs.place``), the global
    function of :func:`make_train_step` on every rank, holding what the
    reference's FSDP holds:

    * the model's ``loss`` gets each parameter's local shard and gathers one
      layer's leaves (one hybrid group's) at a time, inside remat's unit, so
      that the replay gathers them again; the head's leaves where they are
      used (``sharding.fsdp``). Each gathered leaf's gradient is cut to this
      rank's shard and summed over the batch axes as its backward ends, so
      that no rank holds the whole parameters or gradients;
    * each rank takes its rows of the global ``batch`` (of each of the
      reference's microbatches) along the axes that ``batch_shardings``
      splits it over (pod and data, or data alone), and weights its loss by
      its share of the labels before the backward (:func:`value_and_grad`):
      the sums over the ranks are the global token-mean's, not a mean of the
      ranks' means. MoE routes over the dp group's tokens and takes its
      load-balance term over them (``models/layers.moe_dispatch``);
    * every family's products (``models/model.py``) are split over ``model``
      as the reference's GSPMD splits them: a layer's leaves that ``model``
      splits are gathered over ``data`` only, each rank computes its part
      (its attention heads, its slice of the FFN hidden, its experts or its
      slice of each expert's hidden, its SSM heads, its RG-LRU channels,
      its slice of the vocabulary) and the parts are summed, gathered or
      exchanged over ``model`` (``sharding.fsdp``'s modes and conjugates,
      ``models/layers.tp_modes``); the cross-entropy is taken over the
      vocabulary's slices (``models/model.cross_entropy``). A leaf that
      ``model`` does not split (``sharding.specs``' ``tp_ok``), and a block
      whose heads or channels it does not divide, are gathered whole and
      computed alike on every rank of ``model``;
    * microbatches accumulate the f32 gradient on the shards; ``grad_norm``
      sums the shards' squares over the ranks that hold distinct parts of
      each leaf, and takes a leaf that ``model`` does not split once (every
      rank along it holds its whole gradient); the optimizer updates this
      rank's shards of the parameters and of its state in place (Adafactor
      sums its row and column statistics and its RMS over the same ranks:
      ``sharding.specs.LeafSplit``).

    Where nothing splits the batch or a leaf, as on a one-rank mesh, the
    step is the unsharded one, bit for bit; where ``model`` splits a
    product, the ranks' parts are summed in another order than the
    unsharded product's."""
    step = shard_step(cfg, peak_lr, warmup, total_steps, microbatches)

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        splits = [leaf_split(t) for t in leaves(state["params"])]
        metrics = step(tree_map(local, state), batch, sharded_split(cfg, mesh, state["params"], batch), splits)
        return state, metrics

    return train_step


def shard_step(cfg: ModelConfig, peak_lr=3e-4, warmup=100, total_steps=10_000, microbatches=0):
    """``step(shards, batch, split, splits) -> metrics``, the body of
    :func:`make_sharded_train_step`'s step: the gradients over a state of
    this rank's shards with its ``split`` (:class:`_Split`), ``grad_norm``
    and the optimizer over the shards with their ``splits``, the state
    updated in place. The dry-run's memory pass runs it on meta shards
    with the cuts of a mesh that has no process group."""
    gradients, apply = _train_step_parts(cfg, peak_lr, warmup, total_steps, microbatches)

    def step(shards: Dict[str, Any], batch: Dict[str, Any], split, splits):
        loss, aux, grads = gradients(shards["params"], batch, split)
        new, metrics = apply(shards, loss, aux, grads, grad_norm(grads, splits), splits)
        shards["step"].copy_(new["step"])
        return metrics

    return step


def sharded_split(cfg: ModelConfig, mesh, params, batch: Dict[str, Any]) -> "_Split | None":
    """The :class:`_Split` of one call of :func:`make_sharded_train_step`'s
    gradients over ``params`` placed on ``mesh`` and the global ``batch``;
    None where nothing splits the batch or a leaf."""
    ms = mesh_shape(mesh)
    coords = dict(zip(ms.axis_names, mesh.get_coordinate()))
    axes = batch_split_axes(cfg, batch, ms)
    tp = fsdp.mesh_axes(mesh, ("model",))
    split = _Split(tuple(fsdp.leaf_axes(t) for t in leaves(params)), fsdp.mesh_axes(mesh, axes),
                   lambda b: split_batch(b, axes, ms, coords), tp[0] if tp else None)
    return split if split.batch or any(a.split for a in split.leaves) else None


def batch_split_axes(cfg: ModelConfig, batch: Dict[str, Any], mesh) -> tuple:
    """The mesh axes ``batch_shardings`` splits the batch's rows over (those
    of ``frames`` or ``tokens``), major first; () where it stays whole."""
    first = "frames" if "frames" in batch else "tokens"
    spec = {first: (tuple(batch[first].shape), batch[first].dtype)}
    spec.update((k, (tuple(v.shape), v.dtype)) for k, v in batch.items() if k != first)
    return batch_shardings(cfg, spec, mesh)[first].axes(0)


def split_batch(batch: Dict[str, Any], axes, mesh, coords) -> Dict[str, Any]:
    """This rank's rows of each input (dim 1 of ``positions3``): the
    ranks along ``axes`` cut the rows into equal runs, major first. Raises
    ValueError where an input's rows do not divide."""
    sizes = mesh_shape(mesh).shape
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + coords[a]

    def rows(name, v):
        dim = 1 if name == "positions3" else 0
        if v.shape[dim] % n:
            raise ValueError(f"{name}: {v.shape[dim]} rows do not split {n} ways over {tuple(axes)}")
        size = v.shape[dim] // n
        return v.narrow(dim, i * size, size)

    return {k: rows(k, v) for k, v in batch.items()}


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    """The f32 sum of g's squares; a leaf of three or more axes (layers,
    experts) one slice over its leading axes at a time, so that no f32 copy
    of a whole stacked expert leaf is made (arctic-480b's w1 is 17.8 GB in
    f32 at one layer). Only the order of the sum changes."""
    if g.dim() < 3:
        return g.float().square().sum()
    return sum(s.float().square().sum() for s in g.reshape(-1, *g.shape[-2:]))


def make_prefill_step(cfg: ModelConfig):
    """Prefill: ``prefill_step(params, batch, max_seq=None) -> (last_logits, cache)``."""
    return build_model(cfg).prefill


def make_serve_step(cfg: ModelConfig):
    """Decode: ``serve_step(params, cache, batch) -> (logits, cache)``, one new
    token per row against the cache, which it updates in place."""
    return build_model(cfg).decode_step


def make_sharded_prefill_step(cfg: ModelConfig, mesh):
    """``prefill_step(params, batch, max_seq=None) -> (logits, cache)`` over
    params placed on ``mesh`` (``sharding.specs.param_shardings``) and the
    global ``batch``: the counterpart of the reference's
    ``jit(make_prefill_step(cfg))`` over placed parameters, every family:

    * each rank takes its rows of the batch along the axes that
      ``batch_shardings`` splits it over (:func:`serve_rows`): its run of
      the rows of its cache shard, which ``cache_shardings`` cuts over
      ``data`` only, so the ranks along ``pod`` each compute their own run
      of one shard and join their cache rows into it;
    * the model gathers each layer's leaves over ``data`` one layer at a
      time and computes the rank's part of each product that ``model``
      splits, as the sharded train step does (``sharding.fsdp``); MoE
      routes over the dp group's tokens;
    * ``logits`` are the last position's, (the rank's rows, 1, V), whole
      over the vocabulary; ``cache`` its tensors as DTensors placed by
      ``cache_shardings`` (each rank its rows and, where ``model`` divides
      them, its slots of every KV head (the hybrid's ring's too), its SSM
      heads and conv channels, its RG-LRU channels), and ``host_index``.
      :func:`make_sharded_serve_step` reads it as it is.

    On a one-rank mesh it is ``make_prefill_step``'s step, bit for bit."""
    fns, body = build_model(cfg), shard_prefill(cfg)

    def prefill_step(params, batch, max_seq=None):
        b = batch["frames" if "frames" in batch else "tokens"].shape[0]
        s = sum(batch[k].shape[1] for k in ("frames", "vision_embeds", "tokens") if k in batch)
        whole = fns.init_cache(b, prefill_slots(cfg, s, max_seq), "meta")
        cshard = cache_shardings(cfg, whole, mesh, b)
        split = serve_split(cfg, mesh, params, cshard, batch)
        shards = tree_map(local, params)
        if split is None:
            logits, cache = fns.prefill(shards, batch, max_seq)
        else:
            logits, cache = body(shards, batch, split, max_seq)
        return logits, _placed_cache(cache, cshard, whole)

    return prefill_step


def make_sharded_serve_step(cfg: ModelConfig, mesh):
    """``serve_step(params, cache, batch) -> (logits, cache)``: one token a
    row against a cache placed on ``mesh`` by ``cache_shardings`` (as
    :func:`make_sharded_prefill_step` returns it), over params placed by
    ``param_shardings``, the counterpart of the reference's
    ``jit(make_serve_step(cfg))``, every family. Each rank takes its rows
    as the prefill does, and writes the new cache rows of every rank along
    ``pod``; where ``model`` splits the cache's sequence (the hybrid's
    ring's slots) the token's k / v are written by the rank that owns its
    slot only (from ``host_index``: no device sync), each rank attends over
    its slots and the parts are merged over ``model``
    (``models/layers.attention_decode``); where the sequence is whole on
    each rank, every rank attends over all of it. The SSM and RG-LRU
    states and conv histories are the rank's heads and channels
    (``models/ssm.ssm_decode``, ``models/rglru.rec_block_decode``). Logits
    (the rank's rows, 1, V), whole over the vocabulary; the cache updated
    in place. On a one-rank mesh, ``make_serve_step``'s step, bit for
    bit."""
    fns, body = build_model(cfg), shard_decode(cfg)

    def serve_step(params, cache, batch):
        tensors = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
        cshard = cache_shardings(cfg, tensors, mesh, _cache_rows(tensors).shape[1])
        split = serve_split(cfg, mesh, params, cshard, batch)
        shards = tree_map(local, params)
        local_cache = dict(tree_map(local, tensors), host_index=cache["host_index"])
        if split is None:
            logits, new = fns.decode_step(shards, local_cache, batch)
        else:
            logits, new = body(shards, local_cache, batch, split)
        index = DTensor.from_local(new["index"], mesh, cshard["index"].placements(), run_check=False)
        return logits, dict(cache, index=index, host_index=new["host_index"])

    return serve_step


def shard_prefill(cfg: ModelConfig):
    """``prefill(shards, batch, split, max_seq=None) -> (logits, cache)``,
    the body of :func:`make_sharded_prefill_step`'s step over this rank's
    param shards, with no autograd; the cache is the rank's shard. The
    dry-run's memory pass runs it on meta shards with the cuts of a mesh
    that has no process group."""
    fns = build_model(cfg)

    def prefill(shards, batch, split, max_seq=None):
        flat = leaves(shards)
        with torch.no_grad(), split.install(flat):
            return fns.prefill(unflatten_like(shards, flat), split.rows(batch), max_seq)

    return prefill


def shard_decode(cfg: ModelConfig):
    """``decode(shards, cache, batch, split) -> (logits, cache)``, the body
    of :func:`make_sharded_serve_step`'s step over this rank's param shards
    and cache shard, with no autograd (as :func:`shard_prefill`)."""
    fns = build_model(cfg)

    def decode(shards, cache, batch, split):
        flat = leaves(shards)
        with torch.no_grad(), split.install(flat):
            return fns.decode_step(unflatten_like(shards, flat), cache, split.rows(batch))

    return decode


def _cache_rows(cache):
    """A leaf of ``cache`` (tensors or their placements) whose dim 1 is the
    rows: ``k`` for the attention families and the hybrid, ``state`` for
    the SSM (``cache_shardings`` cuts every leaf's rows alike)."""
    return cache["k" if "k" in cache else "state"]


def serve_rows(cfg: ModelConfig, batch: Dict[str, Any], mesh, cache_specs) -> tuple:
    """(the axes a serving rank's rows of ``batch`` are cut over, major
    first; those of them along which it shares its cache shard): the axes
    of size > 1 that ``cache_specs`` (``cache_shardings``) splits the
    cache's rows over, then those of ``batch_shardings`` that the cache is
    whole along (``pod``). So each rank's rows are a run of its cache
    shard's, and the ranks along ``pod`` compute distinct runs of it."""
    ms = mesh_shape(mesh)
    own = tuple(a for a in _cache_rows(cache_specs).axes(1) if ms.shape[a] > 1)
    share = tuple(a for a in batch_split_axes(cfg, batch, ms) if a not in own and ms.shape[a] > 1)
    return own + share, share


def serve_split(cfg: ModelConfig, mesh, params, cache_specs, batch) -> "_Split | None":
    """The :class:`_Split` of a serving call of ``batch`` over ``params``
    placed on ``mesh`` and a cache placed by ``cache_specs``
    (``cache_shardings``): the rows and ``share`` of :func:`serve_rows`,
    ``seq`` the ``model`` axis where it splits the KV cache's sequence.
    None where nothing splits the rows, a leaf or the sequence."""
    ms = mesh_shape(mesh)
    coords = dict(zip(ms.axis_names, mesh.get_coordinate()))
    rows, share = serve_rows(cfg, batch, ms, cache_specs)
    axes = {a.name: a for a in fsdp.mesh_axes(mesh, rows)}
    tp = fsdp.mesh_axes(mesh, ("model",))
    tp = tp[0] if tp else None
    seq = tp if tp is not None and "k" in cache_specs and "model" in cache_specs["k"].axes(2) else None
    split = _Split(tuple(fsdp.leaf_axes(t) for t in leaves(params)), tuple(axes[a] for a in rows),
                   lambda b: split_batch(b, rows, ms, coords), tp, seq, tuple(axes[a] for a in share))
    return split if split.batch or seq is not None or any(a.split for a in split.leaves) else None


def _placed_cache(cache, cache_specs, whole):
    """The rank's cache shard as DTensors placed by ``cache_specs``, of the
    global shapes of ``whole`` (on meta), and its ``host_index``."""
    def placed(t, spec, w):
        return DTensor.from_local(t, spec.mesh, spec.placements(), run_check=False, shape=w.shape, stride=w.stride())

    tensors = {k: v for k, v in cache.items() if isinstance(v, torch.Tensor)}
    return dict(tree_map(placed, tensors, cache_specs, {k: whole[k] for k in tensors}),
                host_index=cache["host_index"])
