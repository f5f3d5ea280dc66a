"""Reference params (nested dict of numpy arrays) -> the port's tensors.

The JAX package's ``build_model(cfg).init(PRNGKey(seed))`` gives a tree whose
bf16 leaves come out of ``np.asarray`` as ``ml_dtypes.bfloat16`` arrays, which
``torch.from_numpy`` refuses; their bits go through ``uint16 -> int16 ->
torch.bfloat16``. Keys, shapes and dtypes are kept (bf16 weights, f32 norms).
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
