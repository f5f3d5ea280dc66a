"""Gathering one layer at a time: the sharded train step's parameters, and
its batch split (``launch/steps.make_sharded_train_step``).

The reference's GSPMD never holds a whole model on a device: it gathers
each FSDP shard where a product needs it and reduce-scatters its gradient.
The port does the same by hand. The step gives the model's ``loss`` each
leaf's local shard and installs, with :func:`use_fsdp`, how each shard is
cut (:class:`LeafAxes`) and which mesh axes split the batch. The model
calls :func:`gather` on one layer's leaves (one hybrid group's) inside the
function that remat wraps, and on the head's leaves where they are used;
:func:`unbind` cuts a stacked shard into its layers' shards, whose cut is
the stack's without its layer axis (stacked leaves never split that axis).

One gather is one autograd ``Function`` over a group of leaves:

* forward: each split leaf all-gathered over the axes that split it,
  minor axis first, so that a dim split over (pod, data) comes back in the
  reference's major-first order; a leaf that nothing splits is passed
  through;
* backward: each whole gradient cut to this rank's shard and summed over
  the batch axes. An axis that splits only the leaf takes a local slice
  (ranks along ``model`` compute the same gradient, so nothing sums over
  it), one that splits the batch and the leaf a reduce-scatter, one that
  splits only the batch an all-reduce. Slices come first, so that the
  collectives move a slice. The sums are in the gradient's dtype, as the
  reference's partitioned step reduces its bf16 gradients.

With nothing installed, or where neither the batch nor a group's leaves
are split (a one-rank mesh), :func:`gather` returns its tree itself and no
collective runs: the unsharded step's bits.

Under a batch split, :func:`batch_sum` and :func:`batch_all_gather` sum and
gather over the dp group: MoE routes over all of its tokens with them
(``models/layers.moe_dispatch``) and takes its load-balance term over them
(``models/model._load_balance_loss``); ``batch_sum``'s backward is an
all-reduce too. Nothing here reads a tensor's values on the host.

On meta tensors (the dry-run's memory pass, whose axes have no process
group) every buffer is made as on a rank and no collective runs: the
gathered leaves are the dry-run's ``gathers``, the shards of the gradients
its ``gradients`` (``roofline/memory.py``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Any, Iterable, Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.roofline import memory
from repro_torch.tree import flatten, unflatten


@dataclasses.dataclass(frozen=True)
class Axis:
    """A mesh axis of size above 1: its name, process group, size and this
    rank's index along it."""

    name: str
    group: Any
    size: int
    index: int


@dataclasses.dataclass(frozen=True)
class LeafAxes:
    """For each dim of a leaf, the axes that split it, major first."""

    dims: Tuple[Tuple[Axis, ...], ...]

    @property
    def split(self) -> bool:
        return any(self.dims)

    def layer(self) -> "LeafAxes":
        """The cut of one layer of a stacked leaf (dim 0 is never split)."""
        assert not self.dims[0], "a stacked leaf's layer axis is split"
        return LeafAxes(self.dims[1:])


def leaf_axes(t) -> LeafAxes:
    """The :class:`LeafAxes` of a placed leaf (a DTensor; a plain tensor is
    not split)."""
    if not isinstance(t, DTensor):
        return LeafAxes(((),) * t.dim())
    mesh = t.device_mesh
    names = mesh.mesh_dim_names
    coords = mesh.get_coordinate()
    dims = [[] for _ in t.shape]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            dims[p.dim].append(Axis(names[i], mesh.get_group(i), mesh.size(i), coords[i]))
    return LeafAxes(tuple(tuple(d) for d in dims))


def mesh_axes(mesh, names: Iterable[str]) -> Tuple[Axis, ...]:
    """The axes of ``mesh`` among ``names`` whose size is above 1, in the
    mesh's order (major first)."""
    coords = mesh.get_coordinate()
    return tuple(Axis(a, mesh.get_group(i), mesh.size(i), coords[i])
                 for i, a in enumerate(mesh.mesh_dim_names) if a in names and mesh.size(i) > 1)


class Fsdp:
    """What the sharded step installs: each local shard's :class:`LeafAxes`
    by identity, and the axes that split the batch (major first)."""

    def __init__(self, shards, axes, batch: Tuple[Axis, ...]):
        self.axes = WeakIdKeyDictionary()
        for t, a in zip(shards, axes):
            self.axes[t] = a
        self.batch = tuple(batch)


_state = threading.local()


def current() -> Optional[Fsdp]:
    return getattr(_state, "fsdp", None)


@contextlib.contextmanager
def use_fsdp(ctx: Optional[Fsdp]):
    prev = current()
    _state.fsdp = ctx
    try:
        yield
    finally:
        _state.fsdp = prev


def remat_contexts(ctx: Fsdp):
    """``torch.utils.checkpoint``'s ``context_fn`` for a layer under remat:
    the replay, which may run on autograd's own thread, sees ``ctx`` too."""
    return lambda: (contextlib.nullcontext(), use_fsdp(ctx))


def unbind(t: torch.Tensor):
    """``t.unbind(0)``; under an installed split, each layer's shard is
    registered with its stack's cut."""
    views = t.unbind(0)
    ctx = current()
    if ctx is not None and t in ctx.axes:
        layer = ctx.axes[t].layer()
        for v in views:
            ctx.axes[v] = layer
    return views


def batch_axes() -> Tuple[Axis, ...]:
    """The installed axes that split the batch, major first; () where none
    does or nothing is installed."""
    ctx = current()
    return () if ctx is None else ctx.batch


def batch_size(axes) -> int:
    return math.prod(a.size for a in axes)


def batch_index(axes) -> int:
    """This rank's index in the dp group, major first: its rows' place in
    the batch."""
    i = 0
    for a in axes:
        i = i * a.size + a.index
    return i


def _collective(fn, out: torch.Tensor, *args, **kwargs) -> None:
    """``fn(out, *args, **kwargs)``, a collective into ``out``; on meta
    nothing runs."""
    if not out.is_meta:
        fn(out, *args, **kwargs)


def _all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    out = t.new_empty((axis.size * t.shape[0], *t.shape[1:]))
    _collective(dist.all_gather_into_tensor, out, t.contiguous(), group=axis.group)
    if dim == 0:
        return out
    out = out.view(axis.size, *t.shape).movedim(0, dim)
    return out.reshape(*t.shape[:dim], axis.size * t.shape[dim], *t.shape[dim + 1:])


def _reduce_scatter(g: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = axis.size
    src = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = g.new_empty(src.shape[1:])
    _collective(dist.reduce_scatter_tensor, out, src.view(n * out.shape[0], *out.shape[1:]), group=axis.group)
    return out


def gather_leaf(t: torch.Tensor, axes: LeafAxes) -> torch.Tensor:
    """The whole leaf of the local shard ``t`` (``t`` itself where nothing
    splits it), with no autograd."""
    for dim, on in enumerate(axes.dims):
        for axis in reversed(on):  # minor first
            t = _all_gather(t, dim, axis)
    return t


def reduce_leaf(g: torch.Tensor, axes: LeafAxes, batch: Tuple[Axis, ...]) -> torch.Tensor:
    """This rank's shard of the whole gradient ``g``, summed over the
    ``batch`` axes (module docstring); always a new tensor."""
    names = {a.name for a in batch}
    own = {a.name for on in axes.dims for a in on}
    order = sorted(range(len(axes.dims)), key=lambda d: any(a.name in names for a in axes.dims[d]))
    fresh = False
    for dim in order:  # dims split only by non-batch axes first: their slices are free
        for axis in axes.dims[dim]:  # major first
            if axis.name in names:
                g, fresh = _reduce_scatter(g, dim, axis), True
            else:
                size = g.shape[dim] // axis.size
                g = g.narrow(dim, axis.index * size, size)
    if not fresh:
        g = g.clone(memory_format=torch.contiguous_format)
    for axis in batch:
        if axis.name not in own:
            _collective(dist.all_reduce, g, group=axis.group)
    return g


@dataclasses.dataclass(frozen=True)
class _Spec:
    leaves: Tuple[LeafAxes, ...]
    batch: Tuple[Axis, ...]


class _Gather(torch.autograd.Function):
    """A group of leaves: all-gathered forward, each gradient cut to its
    shard and summed over the batch axes backward."""

    @staticmethod
    def forward(ctx, spec: _Spec, *shards):
        ctx.spec = spec
        return tuple(gather_leaf(t, a) for t, a in zip(shards, spec.leaves))

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        memory.mark(grads, "gathers")
        shards = tuple(reduce_leaf(g, a, spec.batch) for g, a in zip(grads, spec.leaves))
        memory.mark(shards, "gradients")
        return (None, *shards)


def gather(tree):
    """``tree`` (a dict of leaves, nested or not) with each installed shard
    replaced by its whole leaf, through one :class:`_Gather`; ``tree``
    itself where nothing is installed or nothing needs it."""
    ctx = current()
    if ctx is None:
        return tree
    pairs = flatten(tree)
    todo = [i for i, (_, t) in enumerate(pairs)
            if isinstance(t, torch.Tensor) and t in ctx.axes and (ctx.batch or ctx.axes[t].split)]
    if not todo:
        return tree
    spec = _Spec(tuple(ctx.axes[pairs[i][1]] for i in todo), ctx.batch)
    with memory.kind("gathers"):
        whole = _Gather.apply(spec, *(pairs[i][1] for i in todo))
    for i, t in zip(todo, whole):
        pairs[i] = (pairs[i][0], t)
    return unflatten(pairs)


def _sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    x = x.clone()
    for a in axes:
        _collective(dist.all_reduce, x, group=a.group)
    return x


class _BatchSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axes, x):
        ctx.axes = axes
        return _sum_over(x, axes)

    @staticmethod
    def backward(ctx, g):
        return None, _sum_over(g, ctx.axes)


def batch_sum(x: torch.Tensor, axes) -> torch.Tensor:
    """The sum of ``x`` over the dp group's ranks, on each of them; its
    gradient is summed the same way."""
    return _BatchSum.apply(tuple(axes), x) if axes else x


def batch_all_gather(x: torch.Tensor, axes) -> torch.Tensor:
    """(n_dp, *x.shape): every dp rank's ``x``, in :func:`batch_index` order."""
    out = x[None]
    for a in reversed(tuple(axes)):  # minor first
        buf = out.new_empty((a.size * out.shape[0], *out.shape[1:]))
        _collective(dist.all_gather_into_tensor, buf, out.contiguous(), group=a.group)
        out = buf
    return out
