"""Step builders: the counterparts of the JAX package's ``make_train_state``,
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``
(``launch/steps.py``).

Each returns a plain function over the port's params, cache and batch; the
device is that of the tensors it is given. ``prefill_step`` also takes the
cache size ``max_seq``, which the reference's leaves at the prompt length
(its decode then clamps the write into the last slot; the port's raises).
The train step runs eagerly: it is not compiled as the reference's
``jax.jit`` compiles it (capturing it is ROADMAP.md §1 item 3).
"""
from __future__ import annotations

import os
from typing import Any, Dict

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import build_model
from repro_torch.optim import get_optimizer, get_schedule
from repro_torch.tree import leaves, unflatten_like


def make_train_state(cfg: ModelConfig, generator: torch.Generator):
    """``{"params", "opt", "step"}``: params drawn from ``generator`` on its
    device, the config's optimizer state, ``step`` a 0-d int32 tensor."""
    params = build_model(cfg).init(generator)
    opt = get_optimizer(cfg.optimizer)
    return {"params": params, "opt": opt.init(params),
            "step": torch.zeros((), dtype=torch.int32, device=generator.device)}


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

    def train_step(state: Dict[str, Any], batch: Dict[str, Any]):
        params = state["params"]
        if n_micro > 1:
            grads = [torch.zeros(p.shape, dtype=torch.float32, device=p.device) for p in leaves(params)]
            loss = torch.zeros((), dtype=torch.float32, device=state["step"].device)
            aux = {"ce": torch.zeros_like(loss), "aux": torch.zeros_like(loss)}
            for i in range(n_micro):
                loss_i, _, g = value_and_grad(fns, params, _split(batch, i))
                grads = [a + gi.to(a.dtype) / n_micro for a, gi in zip(grads, g)]
                loss = loss + loss_i / n_micro
        else:
            loss, aux, grads = value_and_grad(fns, params, batch)
        lr = sched(state["step"])
        gnorm = torch.sqrt(sum(_square_sum(g) for g in grads))
        new_params, new_opt = opt.update(unflatten_like(params, grads), state["opt"], params, lr)
        metrics = {"loss": loss.float(), "ce": aux["ce"].float(), "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt, "step": state["step"] + 1}, metrics

    return train_step


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
