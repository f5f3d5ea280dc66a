"""Reference params, caches and train states (nested dicts of numpy arrays)
-> the port's tensors, and train states back.

The JAX package's ``build_model(cfg).init(PRNGKey(seed))`` gives a tree whose
bf16 leaves come out of ``np.asarray`` as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; their bits go through ``uint16 -> int16 ->
torch.bfloat16``. Keys, shapes and dtypes are kept (bf16 weights, f32 norms).
The way back gives a bf16 tensor's bits as a uint16 array, or viewed as the
numpy dtype the caller names (``ml_dtypes.bfloat16``, which the port itself
does not import).
"""
from __future__ import annotations

import numpy as np
import torch


def to_tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def params_from_reference(tree):
    if isinstance(tree, dict):
        return {k: params_from_reference(v) for k, v in tree.items()}
    return to_tensor(tree)


def cache_from_reference(cache):
    """A reference decode cache (``{"k", "v", "index"}`` of the attention
    families, ``{"state", "conv", "index"}`` of the SSM family or ``{"h",
    "conv", "k", "v", "index"}`` of the hybrid, its k/v rings in ring order;
    numpy arrays) as the port's: tensors of the same shapes and dtypes,
    ``index`` a 0-d int32 tensor and ``host_index`` its value as an int. On
    the CPU; move the tensors with ``.to`` where needed."""
    index = int(np.asarray(cache["index"]))
    out = {key: to_tensor(val) for key, val in cache.items() if key != "index"}
    out["index"] = torch.tensor(index, dtype=torch.int32)
    out["host_index"] = index
    return out


def to_numpy(t: torch.Tensor, bf16_dtype=None) -> np.ndarray:
    """A host copy of ``t``; a bf16 tensor's bits as uint16, viewed as
    ``bf16_dtype`` when given."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy().view(np.uint16).copy()
        return bits.view(bf16_dtype) if bf16_dtype is not None else bits
    return t.numpy().copy()


def train_state_from_reference(state):
    """A reference train state ``{"params", "opt", "step"}`` (numpy trees,
    the optimizer's ``count`` and ``step`` 0-d int32) as the port's, on the
    CPU; move it with ``tree_map(lambda t: t.to(device), ...)``."""
    return params_from_reference(state)


def train_state_to_reference(state, bf16_dtype=None):
    """The port's train state as the reference's: the same tree of numpy
    arrays (:func:`to_numpy` for each leaf)."""
    if isinstance(state, dict):
        return {k: train_state_to_reference(v, bf16_dtype) for k, v in state.items()}
    return to_numpy(state, bf16_dtype)
