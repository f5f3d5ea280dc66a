"""Step builders: the counterparts of the JAX package's ``make_train_state``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``
(``launch/steps.py``), and :func:`make_sharded_train_step`, the
counterpart of jitting ``make_train_step`` under shardings.

Each returns a plain function over the port's params, cache and batch; the
device is that of the tensors it is given. ``prefill_step`` also takes the
cache size ``max_seq``, which the reference's leaves at the prompt length
(its decode then clamps the write into the last slot; the port's raises).
The train step runs eagerly: it is not compiled as the reference's
``jax.jit`` compiles it (capturing it is ROADMAP.md §1 item 3).
"""
from __future__ import annotations

import math
import os
from typing import Any, Dict

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import mesh_shape
from repro_torch.models.common import SHAPES_ONLY
from repro_torch.models.model import build_model, loss_tokens
from repro_torch.optim import get_optimizer, get_schedule
from repro_torch.sharding.specs import batch_shardings, gather, leaf_split, local, shard_of
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


def value_and_grad(fns, params, batch):
    """(loss, aux dict, gradients in flatten order) of ``fns.loss`` at
    ``params``, all detached; the gradients come out in the params' dtypes,
    zeros where a leaf took no part (the reference's ``jax.value_and_grad``
    with ``has_aux``)."""
    flat = [p.detach().requires_grad_() for p in leaves(params)]
    loss, aux = fns.loss(unflatten_like(params, flat), batch)
    grads = torch.autograd.grad(loss, flat, allow_unused=True, materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, list(grads)


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
    ``gradients(params, batch) -> (loss, aux, grads)`` (grads in flatten
    order) and ``apply(state, loss, aux, grads, gnorm, splits=None) ->
    (state, metrics)``, the optimizer at the schedule's learning rate
    (``splits``: the optimizer's, for a state of shards)."""
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

    def gradients(params, batch):
        if n_micro <= 1:
            return value_and_grad(fns, params, batch)
        grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)]
        loss = torch.zeros((), dtype=torch.float32, device=grads[0].device)
        aux = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
        for i in range(n_micro):
            loss_i, _, g = value_and_grad(fns, params, _split(batch, i))
            grads = [a + gi.to(a.dtype) / n_micro for a, gi in zip(grads, g)]
            loss = loss + loss_i / n_micro
        return loss, aux, grads

    def apply(state, loss, aux, grads, gnorm, splits=None):
        params = state["params"]
        lr = sched(state["step"])
        new_params, new_opt = opt.update(unflatten_like(params, grads), state["opt"], params, lr, splits)
        metrics = {"loss": loss.float(), "ce": aux["ce"].float(), "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return gradients, apply


def grad_norm(grads) -> torch.Tensor:
    """The f32 norm of the gradients in flatten order."""
    return torch.sqrt(sum(_square_sum(g) for g in grads))


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
    function of :func:`make_train_step` on every rank:

    * the parameters are gathered to full for the products (on a one-rank
      mesh each is its local tensor, so the step is the unsharded one, bit
      for bit); the optimizer state is never gathered;
    * each rank takes its rows of the global ``batch`` along the axes that
      ``batch_shardings`` splits it over (pod and data, or data alone);
    * the loss, ``ce`` and every gradient are reduced over those axes as the
      loss over the global batch: each rank's token-mean weighted by its
      share of the labels (:func:`loss_tokens`, summed over the ranks), so
      the sum is the global token-mean, not a mean of the ranks' means; the
      gradients reduce in f32 and return to the leaves' dtypes;
    * ``grad_norm`` is taken over the reduced, whole gradients; each is then
      cut to this rank's shard, the whole one dropped leaf by leaf, and the
      optimizer updates this rank's shards of the parameters and of its
      state in place (Adafactor sums its row and column statistics and its
      RMS over the ranks that split a leaf: ``sharding.specs.LeafSplit``).

    No product is split over ``model``: ranks that share a batch slice
    compute the same thing (tensor-parallel compute is ROADMAP.md §1 item 16),
    and the whole parameters and gradients are held at once (gathering one
    layer at a time is ROADMAP.md §1 item 17). MoE raises
    NotImplementedError where the batch is split: its capacity and
    load-balance term are functions of all the call's tokens, which a rank's
    dispatch does not see."""
    gradients, apply = _train_step_parts(cfg, peak_lr, warmup, total_steps, microbatches)
    ms = mesh_shape(mesh)
    coords = dict(zip(ms.axis_names, mesh.get_coordinate()))

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        axes = batch_split_axes(cfg, batch, ms)
        reduce = None
        if math.prod(ms.shape[a] for a in axes) > 1:
            if cfg.moe is not None:
                raise NotImplementedError(
                    f"{cfg.name}: MoE under a batch split over {axes} (capacity and the load-balance "
                    "term follow all tokens of the call; ROADMAP.md §3)")
            batch = split_batch(batch, axes, ms, coords)
            reduce = _reduce_over(cfg, [mesh.get_group(a) for a in axes if ms.shape[a] > 1], batch)
        loss, aux, grads = gradients(tree_map(gather, state["params"]), batch)
        if reduce is not None:
            loss, aux, grads = reduce(loss, aux, grads)
        gnorm = grad_norm(grads)
        placed = leaves(state["params"])
        for i, t in enumerate(placed):
            grads[i] = shard_of(grads[i], t)
        shards = tree_map(local, state)
        new, metrics = apply(shards, loss, aux, grads, gnorm, [leaf_split(t) for t in placed])
        shards["step"].copy_(new["step"])
        return state, metrics

    return train_step


def batch_split_axes(cfg: ModelConfig, batch: Dict[str, Any], mesh) -> tuple:
    """The mesh axes ``batch_shardings`` splits the batch's rows over (those
    of ``frames`` or ``tokens``), major first; () where it stays whole."""
    first = "frames" if "frames" in batch else "tokens"
    spec = {first: (tuple(batch[first].shape), batch[first].dtype)}
    spec.update((k, (tuple(v.shape), v.dtype)) for k, v in batch.items() if k != first)
    return batch_shardings(cfg, spec, mesh)[first].axes(0)


def split_batch(batch: Dict[str, Any], axes, mesh, coords) -> Dict[str, Any]:
    """This rank's rows of each input (dim 1 of ``positions3``): the
    ranks along ``axes`` cut the rows into equal runs, major first."""
    sizes = mesh_shape(mesh).shape
    n, i = 1, 0
    for a in axes:
        n, i = n * sizes[a], i * sizes[a] + coords[a]

    def rows(name, v):
        dim = 1 if name == "positions3" else 0
        size = v.shape[dim] // n
        return v.narrow(dim, i * size, size)

    return {k: rows(k, v) for k, v in batch.items()}


def _reduce_over(cfg: ModelConfig, groups, batch):
    """The reduce of :func:`make_sharded_train_step` over ``groups``."""
    def all_sum(t):
        for g in groups:
            dist.all_reduce(t, group=g)
        return t

    n = loss_tokens(cfg, batch).float()
    w = n.clamp(min=1.0) / all_sum(n.clone()).clamp(min=1.0)

    def reduce(loss, aux, grads):
        for i, g in enumerate(grads):  # in place, so one leaf's f32 copy at a time
            grads[i] = all_sum(g.float() * w).to(g.dtype)
        ce = all_sum(aux["ce"].float() * w)
        return all_sum(loss.float() * w), {"ce": ce, "aux": aux["aux"]}, grads

    return reduce


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
