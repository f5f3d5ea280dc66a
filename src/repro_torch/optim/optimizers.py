"""Optimizers as (init, update) pairs over nested dicts of tensors.

Counterpart of the JAX package's ``optim/optimizers.py``: AdamW for most
archs, Adafactor (factored second moment) for the largest MoEs. The state is
f32 whatever the params' dtype; ``count`` is a 0-d int32 tensor on the
params' device and ``lr`` a 0-d f32 tensor there, so an update reads nothing
back from the device. Each leaf's arithmetic is the reference's, term for
term. ``update(grads, state, params, lr)`` writes the new params and state
into the tensors it was given and returns them: the reference's jitted step
donates its state, and in place the card holds one copy of params and
moments (AdamW's moments of a 2 B-parameter model are 16 GB in f32).

``update`` also takes ``splits``, one entry per leaf in flatten order, for
a state cut over ranks (the sharded train step): the tensors are then each
rank's shards, and an entry that is not None says how its leaf is cut
(``sharding.specs.LeafSplit``). AdamW and SGD are elementwise and ignore
it; Adafactor sums its row and column statistics and its RMS over the
ranks that hold the rest of the leaf. A leaf whose entry is None takes the
unsharded arithmetic, bit for bit.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch

from repro_torch.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable  # params -> opt_state
    update: Callable  # (grads, opt_state, params, lr) -> (new_params, new_state)


def _zeros_f32(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def _count(params):
    device = next(iter(leaves(params)), torch.empty(0)).device
    return torch.zeros((), dtype=torch.int32, device=device)


def sgd(momentum: float = 0.0) -> Optimizer:
    def init(params):
        return {"mu": _zeros_f32(params)} if momentum else {}

    @torch.no_grad()
    def update(grads, state, params, lr, splits=None):
        if momentum:
            for p, g, mu in zip(leaves(params), leaves(grads), leaves(state["mu"])):
                mu.copy_(momentum * mu + g.float())
                p.copy_(p - lr * mu)
            return params, state
        for p, g in zip(leaves(params), leaves(grads)):
            p.copy_(p - lr * g.float())
        return params, state

    return Optimizer("sgd", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"m": _zeros_f32(params), "v": _zeros_f32(params), "count": _count(params)}

    @torch.no_grad()
    def update(grads, state, params, lr, splits=None):
        count = state["count"].add_(1)
        c = count.float()
        bc1 = 1 - b1**c
        bc2 = 1 - b2**c
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state["m"]), leaves(state["v"])):
            g = g.float()
            m.copy_(b1 * m + (1 - b1) * g)
            v.copy_(b2 * v + (1 - b2) * g * g)
            step = (m / bc1) / (torch.sqrt(v / bc2) + eps) + weight_decay * p.float()
            p.copy_(p.float() - lr * step)
        return params, state

    return Optimizer("adamw", init, update)


def adafactor(decay: float = 0.8, eps: float = 1e-30, clip_threshold: float = 1.0,
              weight_decay: float = 0.0) -> Optimizer:
    """Factored second-moment estimator (Shazeer & Stern, 2018), no momentum:
    a leaf of two or more axes keeps a row ``vr`` and a column ``vc``
    statistic over its last two axes, any other leaf a full ``v``. A leaf of
    three or more axes (stacked layers, experts) is updated one slice over
    its leading axes at a time, in two passes: the statistics and the sum of
    the update's squares, then the update clipped by the whole leaf's RMS.
    The f32 temporaries are then those of one (K, N) slice, not of the leaf
    (5 x 17.8 GB for arctic-480b's w1 at one layer); only the order of the
    RMS's sum changes."""

    def init(params):
        def per_leaf(p):
            if p.dim() >= 2:
                return {"vr": torch.zeros(p.shape[:-1], dtype=torch.float32, device=p.device),
                        "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], dtype=torch.float32, device=p.device)}
            return {"v": torch.zeros(p.shape, dtype=torch.float32, device=p.device)}

        return {"state": tree_map(per_leaf, params), "count": _count(params)}

    def _mean(x, dim, split, pdim, keepdim=False):
        """The mean of x over its dim ``dim``, which is the leaf's dim
        ``pdim``, over the whole leaf where ranks split that dim."""
        if split is None or not split.groups[pdim]:
            return x.mean(dim=dim, keepdim=keepdim)
        return split.reduce(x.sum(dim=dim, keepdim=keepdim), (pdim,)) / split.shape[pdim]

    def _factored_u(g, vr, vc, split):
        rfac = torch.rsqrt(vr / _mean(vr, -1, split, -2, keepdim=True) + eps)
        cfac = torch.rsqrt(vc + eps)
        return g * rfac[..., None] * cfac[..., None, :]

    def _update_stats(g2, vr, vc, beta, split):
        vr.copy_(beta * vr + (1 - beta) * _mean(g2, -1, split, -1))
        vc.copy_(beta * vc + (1 - beta) * _mean(g2, -2, split, -2))

    def _apply(p, u, denom, lr):
        newp = p.float() - lr * (u / denom)
        if weight_decay:
            newp = newp - lr * weight_decay * p.float()
        p.copy_(newp)

    @torch.no_grad()
    def update(grads, state, params, lr, splits=None):
        count = state["count"].add_(1)
        beta = 1.0 - count.float() ** (-decay)
        per_leaf_state = _leaf_states(params, state["state"])
        splits = splits or [None] * len(per_leaf_state)
        for p, g, s, split in zip(leaves(params), leaves(grads), per_leaf_state, splits):
            if p.dim() >= 3:
                _sliced_update(p, g, s, beta, lr, split)
                continue
            g = g.float()
            g2 = g * g + eps
            if p.dim() >= 2:
                _update_stats(g2, s["vr"], s["vc"], beta, split)
                u = _factored_u(g, s["vr"], s["vc"], split)
            else:
                s["v"].copy_(beta * s["v"] + (1 - beta) * g2)
                u = g * torch.rsqrt(s["v"] + eps)
            # update clipping: RMS(u) <= clip_threshold
            if split is None:
                rms = torch.sqrt((u * u).mean() + eps)
            else:
                rms = torch.sqrt(split.reduce((u * u).sum()) / math.prod(split.shape) + eps)
            _apply(p, u, torch.clamp(rms / clip_threshold, min=1.0), lr)
        return params, state

    def _sliced_update(p, g, s, beta, lr, split):
        """One leaf of three or more axes, one (K, N) slice at a time: first
        the statistics and the sum of u's squares, then the clipped update
        (u again from this step's statistics)."""
        k, n = p.shape[-2:]
        slices = list(zip(p.view(-1, k, n), g.reshape(-1, k, n), s["vr"].view(-1, k), s["vc"].view(-1, n)))
        u2 = 0.0
        for _, gi, vr, vc in slices:
            gi = gi.float()
            _update_stats(gi * gi + eps, vr, vc, beta, split)
            u = _factored_u(gi, vr, vc, split)
            u2 = u2 + (u * u).sum()
        if split is None:
            rms = torch.sqrt(u2 / p.numel() + eps)
        else:
            rms = torch.sqrt(split.reduce(u2) / math.prod(split.shape) + eps)
        denom = torch.clamp(rms / clip_threshold, min=1.0)
        for pi, gi, vr, vc in slices:
            _apply(pi, _factored_u(gi.float(), vr, vc, split), denom, lr)

    return Optimizer("adafactor", init, update)


def _leaf_states(params, state):
    """Adafactor's per-leaf state dicts, in the params' flatten order (a
    param leaf's state is a dict, so the state tree has one level more)."""
    out = []

    def walk(p, s):
        if isinstance(p, dict):
            for key in sorted(p):
                walk(p[key], s[key])
        else:
            out.append(s)

    walk(params, state)
    return out


def get_optimizer(name: str) -> Optimizer:
    if name == "adamw":
        return adamw()
    if name == "adafactor":
        return adafactor()
    if name == "sgd":
        return sgd()
    raise KeyError(name)
