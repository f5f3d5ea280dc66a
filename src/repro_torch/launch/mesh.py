"""Meshes, the counterpart of the JAX package's ``launch/mesh.py``.

Single pod: (data=16, model=16), 256 devices. Multi-pod: (pod=2, data=16,
model=16), 512 devices; ``pod`` composes with ``data`` for the batch and the
gradient reduction.

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over an initialised
process group (:func:`init_ranks`): gloo ranks on the CPU, the counterpart
of the reference's fake host devices, or one NCCL rank on the card. The
sharding rules read only a mesh's axis names and sizes, as the reference's
read ``mesh.shape``, so they also take a :class:`MeshShape`, a description
with no process group behind it: the dry-run applies them to the production
meshes from one host.

Meshes come from functions, never module-level constants: importing this
module touches no process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's axis names and sizes, major first; ``shape`` maps a name to
    its size, as a JAX mesh's does."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        return math.prod(self.sizes)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.sizes)


def mesh_axes(n_dims: int) -> Tuple[str, ...]:
    """The axis names of a mesh of 2 or 3 dims, as the CLIs name them."""
    if n_dims not in (2, 3):
        raise ValueError(f"a mesh has 2 (data, model) or 3 (pod, data, model) axes, not {n_dims}")
    return ("data", "model") if n_dims == 2 else ("pod", "data", "model")


def parse_mesh(text: str) -> MeshShape:
    """``"2x4"`` -> (data=2, model=4); ``"2x16x16"`` -> (pod, data, model)."""
    sizes = tuple(int(x) for x in text.split("x"))
    if any(n < 1 for n in sizes):
        raise ValueError(f"mesh {text!r}: every axis needs a size of at least 1")
    return MeshShape(mesh_axes(len(sizes)), sizes)


def production_mesh_shape(*, multi_pod: bool = False) -> MeshShape:
    return parse_mesh("2x16x16" if multi_pod else "16x16")


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (or of a MeshShape)."""
    if isinstance(mesh, MeshShape):
        return mesh
    return MeshShape(tuple(mesh.mesh_dim_names), tuple(int(n) for n in mesh.shape))


def init_ranks(rank: int, world_size: int, store_path: str, device="cpu") -> None:
    """Joins this process to a group of ``world_size`` ranks through a
    ``FileStore`` at ``store_path`` (no network): gloo on the CPU, NCCL on
    the card (``device``, made the current one)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev.index or 0)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            store=dist.FileStore(store_path, world_size), rank=rank, world_size=world_size)


def make_mesh(shape, axes, device="cpu"):
    """A ``DeviceMesh`` of ``shape`` over the initialised group, whose size
    must be the mesh's (elastic re-mesh, tests on gloo ranks, the card's
    1 x 1)."""
    shape, axes = tuple(shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh {shape} with axes {axes}")
    if math.prod(shape) != dist.get_world_size():
        raise ValueError(f"mesh {shape} needs {math.prod(shape)} ranks; the group has {dist.get_world_size()}")
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(torch.device(device).type, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cpu"):
    """The production mesh over a group of 256 (512) ranks."""
    ms = production_mesh_shape(multi_pod=multi_pod)
    return make_mesh(ms.sizes, ms.axis_names, device)


def dp_axes(mesh) -> tuple:
    """Axes that carry the global batch (pod composes with data)."""
    names = mesh_shape(mesh).axis_names
    return tuple(a for a in ("pod", "data") if a in names)
