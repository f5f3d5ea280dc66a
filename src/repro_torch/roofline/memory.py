"""Live bytes of a step, storage by storage: the dry-run's memory pass.

The reference's ``temp_bytes`` is what XLA's compiled step allocates beside
its arguments and outputs (``memory_analysis().temp_size_in_bytes``). The
port's step runs eagerly, so :func:`count` runs it, on the meta device for
the dry-run, under :class:`LiveBytes`, a ``TorchDispatchMode`` that adds a
storage's ``nbytes`` when an op makes it and takes them off when its last
tensor dies (a weakref's finalizer on the storage). Views share their
storage and are counted once; storages that were there before the step (its
arguments) are never counted. The peak, less the storages the step returns,
is the step's ``temp_bytes``; what was alive at that moment, by kind, is its
breakdown.

With ``card=True`` the kernel wrappers (``repro_torch.kernels``) treat meta
tensors as CUDA ones: the model takes the path it takes on the card (flash
attention instead of the masked plain attention), and each wrapper runs its
CUDA path up to the launch, allocating what the card allocates (outputs,
saved statistics, split-K workspaces) by the same route rules, and launches
nothing. Without it a wrapper on meta takes its plain version, as the
FLOP count does.

Each storage has a kind, the last one given to it:

* ``gathers``: the sharded step's gathered leaves and the whole gradients
  their backward receives (``sharding/fsdp.py``), and a serving cell's
  gathered copies;
* ``gradients``: the step's gradients (shards under a split), from their
  making to the optimizer;
* ``residuals``: under remat, what each checkpointed layer keeps for its
  replay (its input and positions);
* ``layer``: made by the layers, forward, replay or backward: saved
  activations, the FFN and expert hidden, the MoE dispatch buffer, SSM and
  RG-LRU states, the activation gradients; and whatever no other kind
  covers (the embedding's output, the loss's scalars);
* ``attention``: the flash kernel's output and its rows' statistics
  (``lse2``), saved for the backward;
* ``logits``: the LM head and the loss, and their gradients;
* ``optimizer``: the clip norm's and the optimizer's temporaries;
* ``workspace``: the kernels' work buffers.

Code gives a kind with :func:`kind` (what the ops inside make) or
:func:`mark` (tensors already made). In the backward, a storage that no
:func:`kind` covers takes the kind under which the forward made the
autograd node that is running (nodes are numbered in the order they are
made). Both are no-ops unless a :class:`LiveBytes` is counting.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, Iterable, List, Tuple

import torch
from torch.utils._python_dispatch import (
    TorchDispatchMode,
    _get_current_dispatch_mode_stack,
    is_traceable_wrapper_subclass,
)
from torch.utils.weak import WeakIdKeyDictionary

KINDS = ("gathers", "gradients", "residuals", "layer", "attention", "logits", "optimizer", "workspace")
DEFAULT = "layer"


class LiveBytes(TorchDispatchMode):
    """Counts the storages the ops under it make, while they live. ``card``:
    meta tensors take the kernels' CUDA paths (module docstring)."""

    def __init__(self, card: bool = False):
        super().__init__()
        self.card = card
        self.keys = WeakIdKeyDictionary()  # storage -> key
        self.sizes: List[int] = []  # by key
        self.kinds: List[str] = []  # by key
        self.events: List[Tuple[int, int]] = []  # (key, +nbytes made or -nbytes freed), in order
        self.stack: List[str] = []
        self.bound_nr: List[int] = []  # autograd node numbers where the forward's kind changed
        self.bound_kind: List[str] = []
        self.open = True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        made = _plain(out)
        if made:
            given = {id(t.untyped_storage()) for t in _plain((args, kwargs))}
            for t in made:
                st = t.untyped_storage()
                if id(st) not in given and st not in self.keys:
                    self._add(st)
        return out

    def _add(self, st) -> None:
        key, nbytes = len(self.sizes), st.nbytes()
        self.keys[st] = key
        self.sizes.append(nbytes)
        self.kinds.append(self._kind())
        self.events.append((key, nbytes))
        weakref.finalize(st, self._free, key, nbytes)

    def _free(self, key: int, nbytes: int) -> None:
        if self.open:
            self.events.append((key, -nbytes))

    def _kind(self) -> str:
        if self.stack:
            return self.stack[-1]
        node = torch._C._current_autograd_node()
        if node is None:
            return DEFAULT
        i = bisect.bisect_right(self.bound_nr, node._sequence_nr()) - 1
        return self.bound_kind[i] if i >= 0 else DEFAULT

    def push(self, name: str) -> None:
        self.stack.append(name)
        self._bound()

    def pop(self) -> None:
        self.stack.pop()
        self._bound()

    def _bound(self) -> None:
        """Notes the forward's kind from the next autograd node on."""
        nr = torch._C._autograd._get_sequence_nr()
        top = self.stack[-1] if self.stack else DEFAULT
        if self.bound_nr and self.bound_nr[-1] == nr:
            self.bound_kind[-1] = top
        else:
            self.bound_nr.append(nr)
            self.bound_kind.append(top)

    def mark(self, tensors: Iterable, name: str) -> None:
        for t in tensors:
            key = self.keys.get(t.untyped_storage())
            if key is not None:
                self.kinds[key] = name


def _plain(tree) -> List[torch.Tensor]:
    """The tensors in ``tree`` (nested lists, tuples and dicts) that hold a
    storage of their own: a wrapper subclass (a DTensor) is counted through
    its local tensor's ops."""
    out, todo = [], [tree]
    while todo:
        x = todo.pop()
        if isinstance(x, torch.Tensor):
            if type(x) is torch.Tensor or not is_traceable_wrapper_subclass(x):
                out.append(x)
        elif isinstance(x, (list, tuple)):
            todo.extend(reversed(x))
        elif isinstance(x, dict):
            todo.extend(reversed(list(x.values())))
    return out


def counting() -> "LiveBytes | None":
    """The :class:`LiveBytes` counting now, or None."""
    if not torch._C._len_torch_dispatch_stack():
        return None
    for mode in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(mode, LiveBytes):
            return mode
    return None


def card_shapes() -> bool:
    """Whether meta tensors stand for CUDA ones now (a ``card`` count)."""
    live = counting()
    return live is not None and live.card


@contextlib.contextmanager
def kind(name: str):
    """Gives ``name`` to the storages the ops inside make, and, in the
    backward, to those that the nodes they make make."""
    live = counting()
    if live is None:
        yield
        return
    live.push(name)
    try:
        yield
    finally:
        live.pop()


def mark(tree: Any, name: str) -> None:
    """Gives ``name`` to the storages of the tensors in ``tree`` (nested
    dicts, lists, tuples) that the step made."""
    live = counting()
    if live is not None:
        live.mark(_plain(tree), name)


@dataclasses.dataclass(frozen=True)
class Count:
    """What a step held: ``peak``, the most bytes at once beside its
    arguments and outputs; ``breakdown``, those bytes by kind (every kind of
    KINDS, summing to ``peak``); ``held``, by kind, the most each kind held
    at any moment; ``output``, the bytes of the storages it made and
    returned; ``made``, by kind, how many storages of each size (bytes) it
    made."""

    peak: int
    breakdown: Dict[str, int]
    held: Dict[str, int]
    output: int
    made: Dict[str, Dict[int, int]]


def _summary(live: LiveBytes, result) -> Count:
    """The :class:`Count` of what ``live`` saw of a step that returned
    ``result``."""
    outputs = {live.keys[t.untyped_storage()] for t in _plain(result) if t.untyped_storage() in live.keys}
    total = best = best_at = 0
    held = {k: 0 for k in KINDS}
    now = dict(held)
    for i, (key, delta) in enumerate(live.events):
        if key in outputs:
            continue
        total += delta
        k = live.kinds[key]
        now[k] += delta
        held[k] = max(held[k], now[k])
        if total > best:
            best, best_at = total, i + 1
    alive: Dict[int, int] = {}
    for key, delta in live.events[:best_at]:
        if key not in outputs:
            if delta > 0:
                alive[key] = delta
            else:
                alive.pop(key, None)
    breakdown = {k: 0 for k in KINDS}
    for key, nbytes in alive.items():
        breakdown[live.kinds[key]] += nbytes
    made: Dict[str, Dict[int, int]] = {k: {} for k in KINDS}
    for k, nbytes in zip(live.kinds, live.sizes):
        made[k][nbytes] = made[k].get(nbytes, 0) + 1
    return Count(best, breakdown, held, sum(live.sizes[k] for k in outputs), made)


def count(fn: Callable, *args, card: bool = False, **kwargs) -> Tuple[Any, Count]:
    """``fn(*args, **kwargs)`` under a :class:`LiveBytes`: (its result, its
    :class:`Count`)."""
    live = LiveBytes(card)
    with live:
        result = fn(*args, **kwargs)
    live.open = False
    return result, _summary(live, result)
