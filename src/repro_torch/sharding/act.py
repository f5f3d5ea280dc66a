"""Activation sharding constraints, the counterpart of the JAX package's
``sharding/act.py``.

In the reference, launchers install the mesh with
:func:`use_activation_mesh` and model code marks activations with
``constrain`` over logical axes, "dp" (the batch: pod and data), "tp"
(model) or None; the marks guide GSPMD and change no value. The port's
sharded step computes every product whole on each rank (its batch split
over the dp axes, ``launch/steps.py``), so here :func:`constrain` returns
``x`` itself, and :func:`axis_size` answers what the reference's answers,
for code that picks a layout by it. What the step gathers, and the dp
group MoE routes over, it installs itself (``sharding/fsdp.py``).
"""
from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional

from repro_torch.launch.mesh import mesh_shape

_state = threading.local()


def _current():
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def use_activation_mesh(mesh):
    prev = _current()
    _state.mesh = mesh
    try:
        yield
    finally:
        _state.mesh = prev


def _resolve(names, axis: Optional[str]):
    if axis is None:
        return None
    if axis == "dp":
        axes = tuple(a for a in ("pod", "data") if a in names)
        return axes if len(axes) > 1 else axes[0]
    if axis == "tp":
        return "model" if "model" in names else None
    return axis if axis in names else None


def axis_size(axis: str) -> int:
    """Size of a logical axis in the installed mesh (0 when no mesh)."""
    mesh = _current()
    if mesh is None:
        return 0
    ms = mesh_shape(mesh)
    r = _resolve(ms.axis_names, axis)
    if r is None:
        return 0
    return math.prod(ms.shape[a] for a in (r if isinstance(r, tuple) else (r,)))


def constrain(x, *logical_axes):
    """``x`` itself, with or without an installed mesh: the port places no
    activation (module docstring), and the reference's constraint changes
    no value either."""
    return x
