"""Checkpoints: one ``.npy`` file a leaf plus a msgpack manifest, in the JAX
package's on-disk format (``checkpointing/checkpoint.py``), so that either
package restores what the other saved.

``step_{step:08d}/leaf_{i:05d}.npy`` holds leaf i in ``jax.tree.flatten``
order (sorted keys), and ``manifest.msgpack`` its path (the keys joined by
``/``), file, dtype name and shape. bf16 leaves are stored as a uint16 view
with the dtype name ``bfloat16``, as the reference stores ml_dtypes arrays.
``save`` writes into ``<dir>.tmp`` and renames it into place, then keeps the
newest ``keep`` steps; ``AsyncCheckpointer`` copies the tree to the host on
the caller's thread and writes the files on a worker thread, overlapping the
next steps. The manifest goes through the port's own coder
(``manifest.py``): the port does not import msgpack.

A tree of DTensors (a state placed on a mesh) is saved whole: every
rank gathers each leaf (a collective, so every rank of the group calls the
save), rank 0 alone writes the files, and the ranks meet at a barrier once
they are written. ``restore`` into DTensors cuts each rank's shard from the
whole array, so a checkpoint restores onto any mesh, or onto none (the
elastic re-mesh).
"""
from __future__ import annotations

import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor

from repro_torch.checkpointing import manifest
from repro_torch.sharding.specs import gather
from repro_torch.tree import flatten, tree_map

MANIFEST = "manifest.msgpack"


def _host(leaf):
    """(array to save, dtype name) of a tensor or numpy leaf."""
    if isinstance(leaf, torch.Tensor):
        t = gather(leaf).detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    if arr.dtype.kind == "V" or arr.dtype.name not in np.sctypeDict:  # ml_dtypes arrays: a uint view
        view = {1: np.uint8, 2: np.uint16, 4: np.uint32}[arr.dtype.itemsize]
        return arr.view(view), arr.dtype.name
    return arr, arr.dtype.name


def save(ckpt_dir: str, step: int, tree: Any, keep: int = 3) -> str:
    """Synchronous atomic save of a tree of tensors, DTensors or numpy
    arrays; returns the final directory."""
    pairs = [(path, _host(leaf)) for path, leaf in flatten(tree)]
    final = _write(ckpt_dir, step, pairs, keep) if _writes() else _final(ckpt_dir, step)
    _barrier()
    return final


def _final(ckpt_dir: str, step: int) -> str:
    return os.path.join(ckpt_dir, f"step_{step:08d}")


def _writes() -> bool:
    """Only rank 0 of a process group writes: every rank holds the same
    gathered arrays."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def _write(ckpt_dir: str, step: int, pairs, keep: int) -> str:
    """Writes (path, (array, dtype name)) pairs into ``<dir>.tmp``, renames
    it into place and keeps the newest ``keep`` steps."""
    final = _final(ckpt_dir, step)
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    meta = {"step": step, "leaves": []}
    for i, (path, (arr, dtype_name)) in enumerate(pairs):
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), arr)
        meta["leaves"].append({"path": path, "file": fname, "dtype": dtype_name, "shape": list(arr.shape)})
    with open(os.path.join(tmp, MANIFEST), "wb") as f:
        f.write(manifest.packb(meta))
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(d for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def _tensor(arr: np.ndarray, dtype_name: str) -> torch.Tensor:
    if dtype_name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    want = np.dtype(dtype_name)
    if arr.dtype != want:
        arr = arr.view(want) if arr.dtype.itemsize == want.itemsize else arr.astype(want)
    return torch.from_numpy(np.array(arr, copy=True))


def restore(ckpt_dir: str, step: int, target: Any) -> Any:
    """Fills ``target``, a tree of tensors, DTensors or numpy arrays, from the
    checkpoint of ``step``: each leaf, found by its path, is copied into the
    target's tensor on that tensor's device (a DTensor gets this rank's shard
    of it, under the target's placements). A numpy leaf (a host target) comes
    back as a new array of the checkpoint's dtype, as the reference's
    ``restore`` keeps it: int64 stays int64. Raises where a path is missing,
    a shape differs, a tensor's dtype differs, or a numpy leaf would be
    bf16. Returns a tree of the target's paths holding the restored leaves
    (the target's own tensors)."""
    d = _final(ckpt_dir, step)
    with open(os.path.join(d, MANIFEST), "rb") as f:
        meta = manifest.unpackb(f.read())
    by_path = {e["path"]: e for e in meta["leaves"]}
    out = []
    for path, leaf in flatten(target):
        entry = by_path[path]
        arr = np.load(os.path.join(d, entry["file"]))
        if isinstance(leaf, (np.ndarray, np.generic)):
            # a bf16 leaf is stored as a uint16 view, and numpy has no bf16
            if arr.shape != leaf.shape or arr.dtype.name != entry["dtype"]:
                raise ValueError(f"restore {path}: checkpoint {arr.shape} {entry['dtype']}, "
                                 f"target {leaf.shape} {leaf.dtype}")
            out.append(arr)
            continue
        src = _tensor(arr, entry["dtype"])
        if src.shape != leaf.shape or src.dtype != leaf.dtype:
            raise ValueError(f"restore {path}: checkpoint {tuple(src.shape)} {src.dtype}, "
                             f"target {tuple(leaf.shape)} {leaf.dtype}")
        with torch.no_grad():
            local = leaf
            if isinstance(leaf, DTensor):
                src = distribute_tensor(src, leaf.device_mesh, leaf.placements, src_data_rank=None).to_local()
                local = leaf.to_local()
            local.copy_(src)
        out.append(leaf)
    restored = iter(out)
    return tree_map(lambda _: next(restored), target)


class AsyncCheckpointer:
    """Overlaps checkpoint serialization with training compute."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save_async(self, step: int, tree: Any) -> None:
        self.wait()
        # the host copy on the caller's thread (ordered with the steps that
        # update the tree in place), the file IO on the worker
        host_tree = _copy_to_host(tree)

        if not _writes():
            return
        pairs = [(path, _host(leaf)) for path, leaf in flatten(host_tree)]

        def work():
            try:
                _write(self.ckpt_dir, step, pairs, self.keep)
            except BaseException as e:  # noqa: BLE001
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        """Waits for the save in flight; on a process group, every rank
        then meets the others, so none reads a checkpoint before rank 0
        has written it."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        _barrier()
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _copy_to_host(tree):
    if isinstance(tree, dict):
        return {k: _copy_to_host(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return gather(tree).detach().to("cpu", copy=True)
    return np.array(tree, copy=True)
