"""Int8 gradient compression with error feedback for the DP axis: the JAX
package's ``runtime/compression.py`` on nested dicts of tensors.

Quantizing each gradient leaf to int8 with one f32 scale cuts the all-reduce
traffic 4x against f32 (2x against bf16); the error-feedback accumulator
carries what the rounding dropped into the next step. The quantize ->
dequantize round trip models the wire format.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.tree import leaves, tree_map, unflatten_like


def quantize_int8(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    g = g.float()
    scale = g.abs().max() / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)  # half to even, as jnp.round
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


def compress_grads(grads: Any, error: Any) -> Tuple[Any, Any, dict]:
    """(the decompressed grads as the optimizer sees them, the new error
    feedback, stats): each leaf plus its carried error is quantized, and what
    the quantization lost is carried on."""
    new_g, new_e = [], []
    flat_g = leaves(grads)
    for g, e in zip(flat_g, leaves(error)):
        corrected = g.float() + e
        q, scale = quantize_int8(corrected)
        deq = dequantize_int8(q, scale)
        new_g.append(deq.to(g.dtype))
        new_e.append(corrected - deq)
    orig_bytes = sum(g.numel() * g.element_size() for g in flat_g)
    wire_bytes = sum(g.numel() * 1 + 4 for g in flat_g)
    return unflatten_like(grads, new_g), unflatten_like(error, new_e), {"compression_ratio": orig_bytes / max(wire_bytes, 1)}
