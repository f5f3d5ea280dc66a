"""Sharding rules: parameter / optimizer-state / batch / cache placements,
the JAX package's ``sharding/specs.py`` rule for rule.

Strategy, as the reference's:
  * TP over ``model``: attention heads, FFN hidden, vocab, SSM heads,
    RG-LRU channels; experts over ``model`` (EP) when E divides |model|,
    else per-expert tensor parallelism on the hidden dim.
  * FSDP over ``data``: the non-TP dimension of every large matrix
    (optimizer state follows parameters).
  * DP over ``(pod, data)``: the global batch; gradients reduce over both.
  * SP: decode-time KV caches shard the sequence dim over ``model``.

A rule gives a :class:`LeafSharding`: a mesh and a spec that names, for each
tensor dim, the mesh axes it is split over (None, one name, or a tuple of
names, major first), as a ``PartitionSpec`` does. The rules read only the
mesh's axis names and sizes, so they take a ``DeviceMesh`` or a
``MeshShape`` alike. :func:`place` puts a tree on a ``DeviceMesh`` as
DTensors with these placements, so that each rank holds exactly the
shard the reference's ``NamedSharding`` gives its device; :func:`gather`
is a placed tree's whole values (the checkpoint's), and :func:`leaf_split`
how the sharded train step's optimizer sums over a leaf's shards (its
per-layer gathers are ``sharding/fsdp.py``'s).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import dp_axes, mesh_shape
from repro_torch.sharding import fsdp
from repro_torch.tree import flatten, tree_map, unflatten


def P(*dims) -> tuple:
    """A spec: one entry per tensor dim (missing trailing dims are None)."""
    return tuple(dims)


@dataclasses.dataclass(frozen=True)
class LeafSharding:
    """One leaf's placement over ``mesh``: the counterpart of
    ``NamedSharding(mesh, PartitionSpec(*spec))``."""

    mesh: Any
    spec: tuple

    def axes(self, dim: int) -> Tuple[str, ...]:
        a = self.spec[dim] if dim < len(self.spec) else None
        return () if a is None else (a,) if isinstance(a, str) else tuple(a)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        """The shape of one device's shard; raises where a dim does not
        divide by its axes' sizes."""
        sizes = mesh_shape(self.mesh).shape
        out = []
        for dim, n in enumerate(shape):
            k = math.prod(sizes[a] for a in self.axes(dim))
            if n % k:
                raise ValueError(f"dim {dim} of {tuple(shape)} does not split {k} ways ({self.spec})")
            out.append(n // k)
        return tuple(out)

    def placements(self) -> list:
        """DTensor placements, one per mesh dim. A tensor dim split over
        several axes takes them in mesh order, which is DTensor's order of
        nested shards and the reference's major-first order."""
        names = mesh_shape(self.mesh).axis_names
        out = [Replicate() for _ in names]
        for dim in range(len(self.spec)):
            idx = [names.index(a) for a in self.axes(dim)]
            if idx != sorted(idx):
                raise ValueError(f"spec {self.spec}: axes of dim {dim} out of the mesh's order {names}")
            for i in idx:
                out[i] = Shard(dim)
        return out


def _param_spec(cfg: ModelConfig, name: str, ndim: int, shape, mesh) -> tuple:
    """The spec of one parameter leaf (without the stacked-layer axis:
    callers prepend None for leaves living under 'layers')."""
    sizes = mesh_shape(mesh).shape
    model_n = sizes["model"]
    leaf = name.rsplit("/", 1)[-1]

    def fsdp_ok(dim_size) -> bool:
        return dim_size % sizes["data"] == 0

    def tp_ok(dim_size) -> bool:
        return dim_size % model_n == 0

    if leaf == "embed":  # (V, D)
        return P("model" if tp_ok(shape[0]) else None, None)
    if leaf == "lm_head":  # (D, V)
        return P("data" if fsdp_ok(shape[0]) else None, "model" if tp_ok(shape[1]) else None)
    if leaf in ("wq", "wk", "wv", "w1", "w3", "in_proj", "w_in", "w_gate_branch", "w_a", "w_x"):
        return P("data" if fsdp_ok(shape[0]) else None, "model" if tp_ok(shape[1]) else None)
    if leaf in ("wo", "w2", "out_proj", "w_out"):
        return P("model" if tp_ok(shape[0]) else None, "data" if fsdp_ok(shape[1]) else None)
    if leaf in ("bq", "bk", "bv"):
        return P("model" if tp_ok(shape[0]) else None)
    if leaf == "router":  # (D, E)
        return P("data" if fsdp_ok(shape[0]) else None, None)
    if leaf == "conv_w":  # (W, C)
        return P(None, "model" if tp_ok(shape[1]) else None)
    if leaf in ("conv_b", "gate_norm", "lam"):
        return P("model" if tp_ok(shape[0]) else None)
    if leaf in ("A_log", "D", "dt_bias"):
        return P("model" if tp_ok(shape[0]) else None)
    # moe experts handled by caller (3D); norms and scalars replicate
    return P(*([None] * ndim))


def _moe_expert_spec(cfg: ModelConfig, shape, mesh) -> tuple:
    """(E, D, F) or (E, F, D): EP over model when E divides, else TP on the
    hidden dim (per-expert tensor parallelism, e.g. grok-1's 8 experts on a
    16-way model axis)."""
    sizes = mesh_shape(mesh).shape
    model_n, data_n = sizes["model"], sizes["data"]
    e, a, b = shape
    if e % model_n == 0:
        return P("model", "data" if a % data_n == 0 else None, None)
    if b == cfg.moe.d_ff:  # the hidden dim is whichever of a / b is moe.d_ff
        return P(None, "data" if a % data_n == 0 else None, "model" if b % model_n == 0 else None)
    return P(None, "model" if a % model_n == 0 else None, "data" if b % data_n == 0 else None)


def _is_stacked(name: str) -> bool:
    return "layers/" in name or name.startswith("layers") or "rec_layers" in name or "attn_layers" in name


def param_shardings(cfg: ModelConfig, params: Any, mesh) -> Any:
    """A LeafSharding tree matching the params tree (tensors or meta)."""

    def leaf_spec(name, leaf):
        shape = tuple(leaf.shape)
        stacked = _is_stacked(name)
        inner = shape[1:] if stacked else shape
        lname = name.rsplit("/", 1)[-1]
        if cfg.moe is not None and lname in ("w1", "w2", "w3") and len(inner) == 3:
            spec = _moe_expert_spec(cfg, inner, mesh)
        else:
            spec = _param_spec(cfg, name, len(inner), inner, mesh)
        return LeafSharding(mesh, P(None, *spec) if stacked else spec)

    return unflatten([(name, leaf_spec(name, leaf)) for name, leaf in flatten(params)])


def opt_state_shardings(cfg: ModelConfig, opt_state: Any, pspecs: Any, mesh) -> Any:
    """Optimizer state follows parameters: AdamW's m / v mirror them;
    Adafactor's factored moments drop the reduced axis (``vr`` the last,
    ``vc`` the second to last); SGD's ``mu`` mirrors them."""
    if isinstance(opt_state, dict) and "m" in opt_state:
        return {"m": pspecs, "v": pspecs, "count": LeafSharding(mesh, P())}
    if isinstance(opt_state, dict) and "state" in opt_state:
        def leaf_state(param_sharding, state_leaf):
            spec = param_sharding.spec
            if "vr" in state_leaf:
                return {"vr": LeafSharding(mesh, P(*spec[:-1])),
                        "vc": LeafSharding(mesh, P(*(tuple(spec[:-2]) + (spec[-1],))))}
            return {"v": param_sharding}

        paths = [path for path, _ in flatten(pspecs)]
        states = _at_paths(opt_state["state"], paths)
        state = unflatten([(p, leaf_state(s, st)) for (p, s), st in zip(flatten(pspecs), states)])
        return {"state": state, "count": LeafSharding(mesh, P())}
    if isinstance(opt_state, dict) and "mu" in opt_state:
        return {"mu": pspecs}
    return tree_map(lambda _: LeafSharding(mesh, P()), opt_state)


def _at_paths(tree, paths):
    out = []
    for path in paths:
        node = tree
        for key in path.split("/"):
            node = node[key]
        out.append(node)
    return out


def state_shardings(cfg: ModelConfig, state: Any, mesh) -> Dict[str, Any]:
    """``{"params", "opt", "step"}`` of a train state, as the reference's
    launchers assemble them."""
    pspecs = param_shardings(cfg, state["params"], mesh)
    return {"params": pspecs, "opt": opt_state_shardings(cfg, state["opt"], pspecs, mesh),
            "step": LeafSharding(mesh, P())}


def batch_shardings(cfg: ModelConfig, spec: Dict[str, Any], mesh) -> Dict[str, LeafSharding]:
    """Input batch over (pod, data); ``spec`` maps a name to ``(shape,
    dtype)`` (``launch/specs.batch_spec``). As in the reference, the dp axes
    fall back to ``data`` alone when (pod, data) outnumber the first input's
    rows, and each input is split where its dim 0 divides: so
    ``positions3`` (3, B, S) stays whole unless its 3 divides."""
    sizes = mesh_shape(mesh).shape
    dp = dp_axes(mesh)
    first = list(spec.values())[0][0][0]
    dp = dp if math.prod(sizes[a] for a in dp) <= first else ("data",)
    n = math.prod(sizes[a] for a in dp)
    out = {}
    for name, (shape, _) in spec.items():
        dpa = dp if shape[0] % n == 0 else None
        if name == "positions3":  # (3, B, S)
            out[name] = LeafSharding(mesh, P(None, dpa, None))
        else:  # tokens / labels / frame_mask (B, S); frames / vision_embeds (B, S, D)
            out[name] = LeafSharding(mesh, P(dpa, *([None] * (len(shape) - 1))))
    return out


def cache_shardings(cfg: ModelConfig, cache: Any, mesh, batch: int) -> Any:
    """Decode caches: the KV sequence dim over ``model`` (SP), the batch over
    ``data`` where it divides. Only tensor leaves get one (the port's cache
    also carries ``host_index``, a Python int)."""
    sizes = mesh_shape(mesh).shape
    model_n = sizes["model"]
    b_ax = "data" if batch % sizes["data"] == 0 else None

    def leaf(name, shape):
        if name in ("k", "v"):  # (L, B, S, Hkv, hd)
            return P(None, b_ax, "model" if shape[2] % model_n == 0 else None, None, None)
        if name == "state":  # ssm: (L, B, nh, hd, ns)
            return P(None, b_ax, "model" if shape[2] % model_n == 0 else None, None, None)
        if name == "conv":  # ssm: (L, B, W, C) / hybrid: (n_rec, B, W, D)
            return P(None, b_ax, None, "model" if shape[-1] % model_n == 0 else None)
        if name == "h":  # hybrid rec state (n_rec, B, D)
            return P(None, b_ax, "model" if shape[2] % model_n == 0 else None)
        if name == "index":
            return P()
        return P(*([None] * len(shape)))

    return unflatten([(name, LeafSharding(mesh, leaf(name, tuple(l.shape))))
                      for name, l in flatten(cache) if isinstance(l, torch.Tensor)])


def replicated(mesh, tree: Any) -> Any:
    return tree_map(lambda _: LeafSharding(mesh, P()), tree)


# ---------------------------------------------------------------------------
# DTensor trees
# ---------------------------------------------------------------------------


def place(tree: Any, shardings: Any) -> Any:
    """``tree`` (the same full tensors on every rank, as one seed draws
    them) as DTensors on the shardings' ``DeviceMesh``: each rank keeps its
    shard, cut locally with no communication."""
    return tree_map(lambda t, s: distribute_tensor(t, s.mesh, s.placements(), src_data_rank=None),
                    tree, shardings)


def _whole_locally(t: DTensor) -> bool:
    mesh = t.device_mesh
    return all(isinstance(p, Replicate) or mesh.size(i) == 1 for i, p in enumerate(t.placements))


def gather(t):
    """The full tensor of a DTensor (an all-gather over the axes it is split
    over); where no axis splits it, as on a one-rank mesh, its local tensor
    itself, so that an update in place lands in the state. A plain tensor
    is returned as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.to_local() if _whole_locally(t) else t.full_tensor()


def local(t):
    """A DTensor's local shard, a view that an update in place writes
    through; a plain tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


@dataclasses.dataclass(frozen=True)
class LeafSplit:
    """How one leaf is cut over the ranks: its full ``shape`` and, for each
    of its dims, the process groups of the mesh axes of size > 1 that split
    it. The optimizer's reductions over a split leaf read it."""

    shape: Tuple[int, ...]
    groups: Tuple[Tuple[Any, ...], ...]

    def reduce(self, x: torch.Tensor, dims=None) -> torch.Tensor:
        """Sums x over the ranks that split the leaf's ``dims`` (default
        all), in place; returns x. Each sum is noted for
        ``sharding.fsdp.recording``; on meta (the dry-run) nothing runs."""
        for d in range(len(self.shape)) if dims is None else dims:
            for g in self.groups[d]:
                fsdp.note("all-reduce", x, x)
                if not x.is_meta:
                    dist.all_reduce(x, group=g)
        return x


def leaf_split(t) -> "LeafSplit | None":
    """The :class:`LeafSplit` of a DTensor; None where no axis splits it."""
    if not isinstance(t, DTensor) or _whole_locally(t):
        return None
    mesh = t.device_mesh
    groups = [[] for _ in t.shape]
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard) and mesh.size(i) > 1:
            groups[p.dim].append(mesh.get_group(i))
    return LeafSplit(tuple(t.shape), tuple(tuple(g) for g in groups))
