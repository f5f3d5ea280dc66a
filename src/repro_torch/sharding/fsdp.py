"""Gathering one layer at a time and the tensor-parallel split: the
sharded train and serving steps' parameters, their batch split and their
``model`` axis (``launch/steps.make_sharded_train_step``,
``make_sharded_prefill_step``, ``make_sharded_serve_step``).

The reference's GSPMD never holds a whole model on a device: it gathers
each FSDP shard where a product needs it, reduce-scatters its gradient,
and splits every product whose weight is placed over ``model`` across the
ranks of that axis. The port does the same by hand. The step gives the
model's ``loss`` each leaf's local shard and installs, with
:func:`use_fsdp`, how each shard is cut (:class:`LeafAxes`), which mesh
axes split the batch and the ``model`` axis (:func:`tp`). The model calls
:func:`gather` on one layer's leaves (one hybrid group's) inside the
function that remat wraps, and on the head's leaves where they are used;
:func:`unbind` cuts a stacked shard into its layers' shards, whose cut is
the stack's without its layer axis (stacked leaves never split that axis).

One gather is one autograd ``Function`` over a group of leaves, each in a
mode that the model gives (``models/layers.tp_modes``):

* ``whole`` (the default): forward, the leaf all-gathered over every axis
  that splits it, minor axis first, so that a dim split over (pod, data)
  comes back in the reference's major-first order; backward, its whole
  gradient cut to this rank's shard and summed over the batch axes. The
  rank computes with the whole leaf what every rank along ``model``
  computes, so the gradient is whole on each of them and nothing sums it
  over ``model``: a local slice;
* ``local``: the rank keeps its ``model`` shard and computes its part of
  the product with it (:func:`is_tp_shard` says so). Forward, the shard
  gathered over its other axes only; backward, its gradient, already the
  shard's, cut and summed over the batch axes alone;
* ``sum``: the whole leaf, used in the rank's part of a product (the
  per-head norms on its heads): its gradient holds that part only, so it
  is also summed over ``model`` (a reduce-scatter where ``model`` splits
  the leaf, an all-reduce where not).

In the backward an axis that splits only the leaf takes a local slice, one
that is summed over and splits the leaf a reduce-scatter, one summed over
that does not split it an all-reduce. Slices come first, so that the
collectives move a slice. The sums are in the gradient's dtype, as the
reference's partitioned step reduces its bf16 gradients.

Activations follow Megatron's conjugates over ``model``. Every activation
that all ranks of the axis hold alike (the residual stream, the router's
logits) carries its whole gradient on each of them. :func:`tp_copy`
(identity forward, all-reduce backward) stands in front of a rank's part
of a product, :func:`tp_sum` (all-reduce forward, identity backward)
after it, and :func:`tp_all_gather` (all-gather forward, reduce-scatter
backward) brings a split activation whole to an op that reads more than
the rank's part of it (a KV head two ranks share, the RG-LRU's gates).
:func:`tp_exchange` (an all-to-all, whose backward is the reverse one)
hands each rank the columns it reads of an activation whose columns the
ranks hold in runs that do not line up with what they read (the SSM's
packed projection).

With nothing installed, or where neither the batch nor a group's leaves
are split (a one-rank mesh), :func:`gather` returns its tree itself and no
collective runs: the unsharded step's bits.

The sharded serving steps install the same split with ``seq``, the axis
that splits the KV cache's sequence (:func:`seq_axis`): a decode rank
attends over its slots only, and :func:`tp_merge_attention` merges the
ranks' parts from their log-sum-exps (:func:`merge_attention`). Where
the batch is split along an axis that the cache is whole along (``pod``:
``cache_shardings`` splits the cache's rows over ``data`` only), the ranks
along it (``share``) compute distinct runs of the rows of one cache shard:
:func:`share_rows` is the rank's run and :func:`share_all_gather` joins the
runs' new k / v into the shard.

Under a batch split, :func:`batch_sum` and :func:`batch_all_gather` sum and
gather over the dp group: MoE routes over all of its tokens with them
(``models/layers.moe_dispatch``) and takes its load-balance term over them
(``models/model._load_balance_loss``); ``batch_sum``'s backward is an
all-reduce too. Nothing here reads a tensor's values on the host.

On meta tensors (the dry-run's passes, whose axes have no process group)
every buffer is made as on a rank and no collective runs: the gathered
leaves are the dry-run's ``gathers``, the shards of the gradients its
``gradients`` (``roofline/memory.py``); under :func:`recording` each
collective is noted instead, with its operand and result bytes, for the
dry-run's collective plan (``roofline/costs.Plan``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
import time
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

    def dim_of(self, name: str) -> Optional[int]:
        """The dim that the axis ``name`` splits; None where it splits none."""
        return next((d for d, on in enumerate(self.dims) if any(a.name == name for a in on)), None)

    def without(self, name: str) -> "LeafAxes":
        """The cut with the axis ``name`` taken out: what a gather that
        keeps that axis's shard gathers over."""
        return LeafAxes(tuple(tuple(a for a in on if a.name != name) for on in self.dims))


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
    by identity, the axes that split the batch (major first), ``tp``, the
    ``model`` axis where it has more than one rank (else None), and, for
    the serving steps, ``seq``, the axis that splits the KV cache's
    sequence (the ``model`` axis where ``cache_shardings`` splits it, else
    None). The gathers note here each leaf they hand over as a ``model``
    shard, and ``share``, the batch axes along which the KV cache is whole
    (the minor end of ``batch``)."""

    def __init__(self, shards, axes, batch: Tuple[Axis, ...], tp: Optional[Axis] = None,
                 seq: Optional[Axis] = None, share: Tuple[Axis, ...] = ()):
        self.axes = WeakIdKeyDictionary()
        for t, a in zip(shards, axes):
            self.axes[t] = a
        self.batch = tuple(batch)
        self.tp = tp
        self.seq = seq
        self.share = tuple(share)
        self.tp_shards = WeakIdKeyDictionary()


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


def tp() -> Optional[Axis]:
    """The installed ``model`` axis, where it has more than one rank; None
    where it has one or nothing is installed."""
    ctx = current()
    return None if ctx is None else ctx.tp


def seq_axis() -> Optional[Axis]:
    """The installed axis that splits the KV cache's sequence; None where
    the cache is whole on each rank or nothing is installed."""
    ctx = current()
    return None if ctx is None else ctx.seq


def share_size() -> int:
    """How many ranks compute distinct runs of the rows of this rank's KV
    cache shard (the ranks along the installed ``share`` axes); 1 where
    none do or nothing is installed."""
    ctx = current()
    return 1 if ctx is None else math.prod(a.size for a in ctx.share)


def share_rows(t: torch.Tensor) -> torch.Tensor:
    """This rank's run of the rows (dim 0) of a KV cache shard ``t``: run
    :func:`batch_index` over the ``share`` axes of ``share_size()`` equal
    runs; ``t`` itself where none is installed."""
    n = share_size()
    if n == 1:
        return t
    rows = t.shape[0] // n
    return t.narrow(0, batch_index(current().share) * rows, rows)


def share_all_gather(x: torch.Tensor) -> torch.Tensor:
    """The rows (dim 0) of every rank along the ``share`` axes, joined in
    :func:`batch_index` order: the cache shard's rows of which ``x`` is
    this rank's run; ``x`` itself where none is installed. No gradient."""
    if share_size() == 1:
        return x
    return batch_all_gather(x, current().share).flatten(0, 1)


def model_dims(tree) -> dict:
    """For each installed shard in ``tree`` (a dict of leaves, nested or
    not), by path, the dim that the ``model`` axis splits, or None; {}
    where no ``model`` axis is installed."""
    ctx = current()
    if ctx is None or ctx.tp is None:
        return {}
    return {path: ctx.axes[t].dim_of(ctx.tp.name) for path, t in flatten(tree)
            if isinstance(t, torch.Tensor) and t in ctx.axes}


def is_tp_shard(t: torch.Tensor) -> bool:
    """Whether ``t`` is a leaf that a gather handed over as this rank's
    ``model`` shard (mode ``local``): the rank computes its part of the
    product with it."""
    ctx = current()
    return ctx is not None and t in ctx.tp_shards


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


_recorders: list = []


@contextlib.contextmanager
def recording(plan):
    """Notes every collective that the code inside issues with
    ``plan.note(kind, operand bytes, result bytes)`` (``roofline.costs.Plan``),
    beside running it (on meta nothing runs)."""
    _recorders.append(plan)
    try:
        yield
    finally:
        _recorders.pop()


def _nbytes(t) -> int:
    return t if isinstance(t, int) else t.numel() * t.element_size()


def note(kind: str, operand, result) -> None:
    """Notes one collective for every :func:`recording`: its operand and
    result, tensors or byte counts."""
    for plan in _recorders:
        plan.note(kind, _nbytes(operand), _nbytes(result))


def _collective(fn, kind: str, out: torch.Tensor, src: torch.Tensor, axis: Axis, noted=None, **kwargs) -> None:
    """``fn`` over ``axis``'s group from ``src`` into ``out`` (the same
    tensor for an all-reduce), noted for :func:`recording` (as ``noted``,
    an (operand, result) pair of byte counts, where given); on meta
    nothing runs. Under a count of real tensors (``roofline.memory``) it
    returns only once the process group has let go of both: gloo's worker
    thread drops its references after the caller has woken, so a buffer
    the caller frees at once would otherwise die on that thread, whenever
    it runs, and the count's peak would depend on the threads' timing."""
    note(kind, *((src, out) if noted is None else noted))
    if out.is_meta:
        return
    refs = _refs(out, src) if memory.counting() is not None else None
    if out is src:
        fn(out, group=axis.group, **kwargs)
    else:
        fn(out, src, group=axis.group, **kwargs)
    if refs is not None:
        deadline = time.monotonic() + 1.0
        while _refs(out, src) != refs and time.monotonic() < deadline:
            time.sleep(1e-5)  # lets the worker take the GIL


def _refs(*ts) -> list:
    """The reference counts of ``ts``' tensors and of their storages."""
    return [n for t in ts for n in (t._use_count(), torch._C._storage_Use_Count(t.untyped_storage()._cdata))]


def _all_reduce(x: torch.Tensor, axis: Axis, op=None) -> None:
    _collective(dist.all_reduce, "all-reduce", x, x, axis, **({} if op is None else {"op": op}))


def _all_gather(t: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    out = t.new_empty((axis.size * t.shape[0], *t.shape[1:]))
    _collective(dist.all_gather_into_tensor, "all-gather", out, t.contiguous(), axis)
    if dim == 0:
        return out
    out = out.view(axis.size, *t.shape).movedim(0, dim)
    return out.reshape(*t.shape[:dim], axis.size * t.shape[dim], *t.shape[dim + 1:])


def _reduce_scatter(g: torch.Tensor, dim: int, axis: Axis) -> torch.Tensor:
    n = axis.size
    src = g.unflatten(dim, (n, g.shape[dim] // n)).movedim(dim, 0).contiguous()
    out = g.new_empty(src.shape[1:])
    _collective(dist.reduce_scatter_tensor, "reduce-scatter", out, src.view(n * out.shape[0], *out.shape[1:]), axis)
    return out


def gather_leaf(t: torch.Tensor, axes: LeafAxes) -> torch.Tensor:
    """The whole leaf of the local shard ``t`` (``t`` itself where nothing
    splits it), with no autograd."""
    for dim, on in enumerate(axes.dims):
        for axis in reversed(on):  # minor first
            t = _all_gather(t, dim, axis)
    return t


def reduce_leaf(g: torch.Tensor, axes: LeafAxes, sums: Tuple[Axis, ...]) -> torch.Tensor:
    """This rank's shard of the gradient ``g`` over ``axes``, summed over
    the ``sums`` axes (module docstring); always a new tensor."""
    names = {a.name for a in sums}
    own = {a.name for on in axes.dims for a in on}
    order = sorted(range(len(axes.dims)), key=lambda d: any(a.name in names for a in axes.dims[d]))
    fresh = False
    for dim in order:  # dims split only by axes not summed over first: their slices are free
        for axis in axes.dims[dim]:  # major first
            if axis.name in names:
                g, fresh = _reduce_scatter(g, dim, axis), True
            else:
                size = g.shape[dim] // axis.size
                g = g.narrow(dim, axis.index * size, size)
    if not fresh:
        g = g.clone(memory_format=torch.contiguous_format)
    for axis in sums:
        if axis.name not in own:
            _all_reduce(g, axis)
    return g


@dataclasses.dataclass(frozen=True)
class _Spec:
    """Each leaf of one gather: the axes it is gathered over, and those its
    gradient is summed over."""

    leaves: Tuple[LeafAxes, ...]
    sums: Tuple[Tuple[Axis, ...], ...]


class _Gather(torch.autograd.Function):
    """A group of leaves: all-gathered forward, each gradient cut to its
    shard and summed backward."""

    @staticmethod
    def forward(ctx, spec: _Spec, *shards):
        ctx.spec = spec
        return tuple(gather_leaf(t, a) for t, a in zip(shards, spec.leaves))

    @staticmethod
    def backward(ctx, *grads):
        spec = ctx.spec
        memory.mark(grads, "gathers")
        shards = tuple(reduce_leaf(g, a, s) for g, a, s in zip(grads, spec.leaves, spec.sums))
        memory.mark(shards, "gradients")
        return (None, *shards)


def gather(tree, modes: Optional[dict] = None):
    """``tree`` (a dict of leaves, nested or not) with each installed shard
    replaced by the leaf its mode asks for (``modes``: path -> ``"local"``
    or ``"sum"``, ``"whole"`` where missing; module docstring), through one
    :class:`_Gather`; ``tree`` itself where nothing is installed or nothing
    needs it. The modes count only under a ``model`` axis (:func:`tp`)."""
    ctx = current()
    if ctx is None:
        return tree
    modes = modes if ctx.tp is not None and modes else {}
    pairs = flatten(tree)
    todo, cuts, sums, local = [], [], [], []
    for i, (path, t) in enumerate(pairs):
        if not (isinstance(t, torch.Tensor) and t in ctx.axes):
            continue
        axes, over = ctx.axes[t], ctx.batch
        mode = modes.get(path, "whole")
        if mode == "local":
            axes = axes.without(ctx.tp.name)
            local.append(i)
        elif mode == "sum":
            over = over + (ctx.tp,)
        if axes.split or over:
            todo.append(i)
            cuts.append(axes)
            sums.append(over)
    if todo:
        with memory.kind("gathers"):
            whole = _Gather.apply(_Spec(tuple(cuts), tuple(sums)), *(pairs[i][1] for i in todo))
        for i, t in zip(todo, whole):
            pairs[i] = (pairs[i][0], t)
    for i in local:
        ctx.tp_shards[pairs[i][1]] = True
    return unflatten(pairs) if todo else tree


def _sum_over(x: torch.Tensor, axes) -> torch.Tensor:
    x = x.clone()
    for a in axes:
        _all_reduce(x, a)
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
        _collective(dist.all_gather_into_tensor, "all-gather", buf, out.contiguous(), a)
        out = buf
    return out


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return None, _sum_over(g, (ctx.axis,))


class _Sum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, x):
        return _sum_over(x, (axis,))

    @staticmethod
    def backward(ctx, g):
        return None, g


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, axis, dim, x):
        ctx.axis, ctx.dim = axis, dim
        return _all_gather(x, dim, axis)

    @staticmethod
    def backward(ctx, g):
        return None, None, _reduce_scatter(g, ctx.dim, ctx.axis)


def tp_copy(x: torch.Tensor) -> torch.Tensor:
    """``x``, which every rank along ``model`` holds alike, in front of the
    rank's part of a product: its gradient is summed over ``model``. ``x``
    itself where no ``model`` axis is installed."""
    axis = tp()
    return x if axis is None else _Copy.apply(axis, x)


def tp_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of the ranks' parts ``x`` over ``model``, on each of them;
    the gradient of the sum passes to each part as it is."""
    axis = tp()
    return x if axis is None else _Sum.apply(axis, x)


def tp_all_gather(x: torch.Tensor, dim: int) -> torch.Tensor:
    """The ranks' parts ``x`` along ``model`` joined along ``dim`` (in rank
    order), on each of them; its gradient is reduce-scattered back."""
    axis = tp()
    return x if axis is None else _AllGather.apply(axis, dim % x.dim(), x)


def _all_to_all(src: torch.Tensor, sends, recvs, axis: Axis) -> torch.Tensor:
    """Rows ``sends[q]`` of ``src`` (runs in rank order) to rank q of
    ``axis``, and ``recvs[q]`` rows from each, joined in rank order; noted
    as the bytes sent to and received from the other ranks."""
    out = src.new_empty((sum(recvs), *src.shape[1:]))
    row = src[0].numel() * src.element_size() if src.shape[0] else 0
    noted = ((sum(sends) - sends[axis.index]) * row, (sum(recvs) - recvs[axis.index]) * row)
    _collective(dist.all_to_all_single, "all-to-all", out, src, axis, noted,
                output_split_sizes=list(recvs), input_split_sizes=list(sends))
    return out


class _Exchange(torch.autograd.Function):
    """Columns of an activation to the ranks along ``model`` that read
    them: forward an all-to-all, backward the reverse all-to-all and each
    rank's gradients added into the columns they came from."""

    @staticmethod
    def forward(ctx, axis, x, send, sends, recvs):
        ctx.axis, ctx.sends, ctx.recvs, ctx.shape = axis, sends, recvs, x.shape
        ctx.save_for_backward(send)
        rows = x.reshape(-1, x.shape[-1]).t()  # (columns, rows): a rank's columns are rows of the buffers
        out = _all_to_all(rows.index_select(0, send), sends, recvs, axis)
        return out.t().reshape(*x.shape[:-1], out.shape[0])

    @staticmethod
    def backward(ctx, g):
        (send,) = ctx.saved_tensors
        back = _all_to_all(g.reshape(-1, g.shape[-1]).t().contiguous(), ctx.recvs, ctx.sends, ctx.axis)
        grad = back.new_zeros((ctx.shape[-1], back.shape[1]))
        start = 0
        for n in ctx.sends:  # a column goes to a rank once: each add has distinct indices, so any order gives one sum
            grad.index_add_(0, send[start : start + n], back[start : start + n])
            start += n
        return None, grad.t().reshape(ctx.shape), None, None, None


def tp_exchange(x: torch.Tensor, send: torch.Tensor, sends, recvs) -> torch.Tensor:
    """The columns this rank reads of an activation whose columns ``model``
    splits: ``x`` (..., n) holds the rank's own; ``send`` (int64, on x's
    device) the indices of those each rank reads, rank 0's first,
    ``sends[q]`` of them for rank q; ``recvs[q]`` columns come from rank
    q. Returns (..., sum(recvs)), the columns in rank order: an all-to-all
    over ``model`` (a column may go to several ranks), whose backward sums
    each column's gradients from the ranks that read it. ``x`` itself
    where no ``model`` axis is installed."""
    axis = tp()
    return x if axis is None else _Exchange.apply(axis, x, send, tuple(sends), tuple(recvs))


def tp_max(x: torch.Tensor) -> torch.Tensor:
    """The elementwise max of ``x`` over ``model``, with no gradient."""
    axis = tp()
    if axis is None:
        return x
    x = x.detach().clone()
    _all_reduce(x, axis, dist.ReduceOp.MAX)
    return x


def merge_attention(out: torch.Tensor, lse: torch.Tensor, max_over, sum_over) -> torch.Tensor:
    """The attention over a whole sequence from parts over pieces of it
    (flash-decoding's merge): ``out`` (..., H, D), each part's attention
    over its piece, and ``lse`` (..., H) f32, the log-sum-exp of its
    scaled scores there (-inf where it holds no valid slot). In f32: m,
    ``max_over(lse)`` (the max over the parts), each part weighted by
    exp(lse - m) (0 where lse is -inf), the weighted parts and the weights
    summed by ``sum_over``, divided; in ``out``'s dtype."""
    m = max_over(lse)
    w = torch.where(lse == float("-inf"), 0.0, torch.exp(lse - m))
    parts = sum_over(torch.cat([(out.float() * w[..., None]).flatten(-2), w], dim=-1))
    h, d = out.shape[-2:]
    return (parts[..., : h * d].unflatten(-1, (h, d)) / parts[..., h * d :, None]).to(out.dtype)


def tp_merge_attention(out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
    """:func:`merge_attention` over the ``model`` ranks, each holding its
    part over its shard of the sequence (flash-decoding over ranks): the
    max by :func:`tp_max`, the weighted parts and weights in one
    all-reduce. ``out`` itself where no ``model`` axis is installed. No
    gradient."""
    axis = tp()
    if axis is None:
        return out

    def summed(x):
        _all_reduce(x, axis)
        return x

    return merge_attention(out, lse, tp_max, summed)
