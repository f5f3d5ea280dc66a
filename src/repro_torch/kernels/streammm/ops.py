"""Wrappers of the CUDA weight-streaming matmuls (``csrc/streammm.cu``,
``csrc/streammm_int8.cu``).

A CPU or meta tensor goes to the plain version in ``ref.py``; a CUDA tensor launches
the kernel on the current stream or raises. Under the dry-run's memory pass
(``roofline/memory.py``) a meta tensor takes the CUDA path instead, up to
the launch: it allocates what the launch would, by the same route rules,
and launches nothing. ``stream_matmul.launches`` and
``stream_matmul_int8.launches`` count the kernels' launches;
``stream_matmul.wgmma_launches`` and ``stream_matmul_int8.wgmma_launches``
count those of them that took the tensor-core route.

``stream_matmul`` replaces the JAX package's ``stream_matmul``
(``src/repro/kernels/streammm/kernel.py:50``) and has four routes, which
:func:`mm_route` picks from dtype and shape alone (a rule, not a fallback: a
route that fails raises): ``gemv`` for M <= 8, bound by the weight bytes over
HBM (the live and decode steps), one launch that streams each weight row's
slabs and, where :func:`k_splits` cuts K, adds the splits' sums in a
thread-block cluster in rank order (no workspace; weights whose rows
16-byte loads cannot walk take the older scalar kernel, K whole, by the same
rule of shape); ``wgmma`` for bf16 with M > 8 where TMA can
describe both operands, bound by the bf16 tensor-core rate at prefill, which
it approaches with TMA-fed wgmma tiles (with x given as (K, M), every dW, a
persistent kernel that stores through TMA); ``narrow`` for f32 with M > 8
and a narrow side (N <= 128 of a (K, N) weight, K <= 128 of an (N, K) one,
rows of 16-byte multiples): the MoE routers' x @ w_router, their dW and
their dX, in exact f32 FFMA on tiles shaped to the narrow side, K cut across
blocks where the output's tiles are too few to fill the SMs
(:func:`narrow_splits`; ``stream_matmul.narrow_launches`` counts the
route's launches); ``simt`` for the rest (other f32, which stays exact f32,
and ragged K or N). With ``w_layout="nk"`` it computes
``x @ w.T`` for a K-major w of shape (N, K), the tied LM head ``x @
embed^T``, on the same routes without copying w (``stream_matmul.
nk_launches`` counts those launches). ``stream_matmul_int8`` replaces
``stream_matmul_int8`` (``kernel.py:101``) with the gemv, wgmma and simt
routes, picked by :func:`int8_route`; its ``wgmma`` route keeps the int8
products exact (bf16 x times the unscaled weight, the scale applied to each
group's f32 sum).

With x (E, C, K) and w (E, K, N), ``stream_matmul`` is the expert-batched
form that the MoE layer's expert products take (the reference's
``einsum("ecd,edf->ecf")``, ``src/repro/models/layers.py:241-243``): one
launch, the experts on the grid's z axis, the route picked by
:func:`mm_route` from each expert's (C, K, N). An optional int32 ``rows``
(E,) gives each expert's filled slots: rows at or past ``rows[e]`` come out
0, and an expert with none reads no weight. An optional ``experts_hit``
bounds the experts that hold a row (the MoE layer passes min(E, top_k x
tokens)): on the gemv route the grid's z axis is that many slots, each
walking the non-empty experts in turn, found on the device, so the bound
moves the speed and never the result. ``stream_matmul.batched_launches``
counts those launches; their checks run on both devices.

With ``x_layout="km"``, x is given as (K, M), or (E, K, M), and the product
is ``x.T @ w`` for a (K, N) weight: x is read in place as an MN-major
operand (on the wgmma route, the transpose bit of wgmma's A); ``rows`` then
bounds each expert's terms of the sum over K, so slots past ``rows[e]`` add
nothing, whatever they hold, and an expert with none gives an exact zero.

Gradients: on CUDA, with grad mode on and x or w requiring grad, the 2-D
form runs inside an ``autograd.Function`` whose forward is the same launch
and whose backward is ``stream_matmul`` itself, on contiguous operands read
in place: for a (K, N) weight dX = ``stream_matmul(dY, w, w_layout="nk")``
(w read as the K-major weight of ``dY @ w.T``) and dW = ``stream_matmul(x,
dY, x_layout="km")``; for an (N, K) weight (``w_layout="nk"``, the tied
head) dX = ``stream_matmul(dY, w)`` and dW = ``stream_matmul(dY, x,
x_layout="km")``, or, where dY's rows are no multiple of 16 bytes (bf16 at
an odd vocabulary, which TMA cannot stride), ``stream_matmul(dY.T, x)`` on a
transposed copy, so that it stays on the tensor cores. The expert-batched
form (E, C, K) @ (E, K, N) has the same pair, each one launch over the
experts: dX[e] = dY[e] @ W[e]^T (``w_layout="nk"`` over the stack, rows
past ``rows[e]`` written as 0) and dW[e] = X[e]^T @ dY[e] over the filled
slots only (``x_layout="km"`` with ``rows``), counted in ``stream_matmul.
batched_grad_launches``. Each gradient comes out in its operand's dtype, and
f32 stays exact f32. Without grad (every serving path) nothing changes: the
same launch, route, bits and counts. ``stream_matmul_int8`` has no backward
yet: on CUDA under grad, with an input that requires grad, it raises.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import _build, on_card, takes_plain
from repro_torch.kernels.streammm.ref import stream_matmul_int8_ref, stream_matmul_ref
from repro_torch.roofline import memory

DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
GEMV_MAX_M = 8  # rows of x the kernel's gemv path takes (kGemvMaxM)
GEMV_COLS = 256  # output columns per block of the int8 gemv (kGemvCols)
GEMV_ROW_BYTES = 256  # bytes of each weight row a streaming gemv block owns (kGemvRowBytes)
GEMV_MAX_SPLITS = 8  # K splits of a gemv slab: one thread-block cluster (kGemvMaxSplits)
GEMV_EXPERT_ROWS = 4096  # K rows a split of an expert-batched gemv streams at most: 1 MB of a slab
ROUTE_CODES = {"gemv": 0, "simt": 1, "wgmma": 2, "narrow": 3}  # the C entry points' route argument
NARROW_MAX = 128  # the narrow side the f32 narrow route takes: the routers' E of 8 and 128
NARROW_THIN_N = 8  # N of a (K, N) weight at or under which it takes the 256 x 8 tiles (kThinMaxN)
INT8_TILE_K = 64  # K rows of a stage of the int8 wgmma route (kI8BK)
INT8_TILE_M, INT8_TILE_N = 192, 128  # rows and columns of an int8 wgmma output tile (kI8BM, kI8BN)
W_LAYOUT_CODES = {"kn": 0, "nk": 1}  # the C entry point's w_layout argument
X_LAYOUT_CODES = {"mk": 0, "km": 1}  # and its x_layout argument
_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
_INT8_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8 + [ctypes.c_void_p]


def mm_route(m: int, n: int, k: int, dtype: torch.dtype, aligned: bool, w_layout: str = "kn",
             x_layout: str = "mk") -> str:
    """The kernel route of an (m, k) @ (k, n) product: "gemv" for m <= 8
    (an x given as (K, M), ``x_layout="km"``, never: its rows are the sum's
    terms); "wgmma" for bf16 at m > 8 where TMA can describe both operands
    (16-byte aligned base pointers, ``aligned``, and rows that each start 16
    bytes on: k a multiple of 8, n too for a (K, N) weight; for a (K, M) x m
    and n, and any k, the rows TMA zero-fills past it; a K-major (N, K)
    weight, ``w_layout="nk"``, takes any n, which TMA zero-fill and the
    masked store handle); "narrow" for f32 at m > 8 with a
    narrow side, n <= NARROW_MAX for a (K, N) weight or k <= NARROW_MAX for
    an (N, K) one (the MoE routers' product, dW and dX), where every
    operand's rows are multiples of 16 bytes (k for an (M, K) x or an (N, K)
    weight, n for a (K, N) weight, m for a (K, M) x) and ``aligned``;
    "simt" otherwise, which keeps f32 in exact f32."""
    km = x_layout == "km"
    if m <= GEMV_MAX_M:
        return "simt" if km else "gemv"
    if dtype == torch.bfloat16 and (k % 8 == 0 or km) and (n % 8 == 0 or w_layout == "nk") \
            and (m % 8 == 0 or not km) and aligned:
        return "wgmma"
    if dtype == torch.float32 and aligned and (n <= NARROW_MAX if w_layout == "kn" else k <= NARROW_MAX) \
            and (k % 4 == 0 or km) and (n % 4 == 0 or w_layout == "nk") and (m % 4 == 0 or not km):
        return "narrow"
    return "simt"


def k_splits(m: int, n: int, k: int, sm_count: int, experts: int = 1, elem: int = 2) -> int:
    """How many K chunks the gemv path cuts a (K, N) weight's product into:
    the fewest of 1, 2, 4 or 8 (one thread-block cluster) that give a block
    to all but a sixteenth of the SMs, counting a slab of GEMV_ROW_BYTES of
    each weight row (128 bf16 or 64 f32 columns, ``elem`` bytes an element)
    for each of ``experts`` experts, and, for more than one expert, chunks of
    at most GEMV_EXPERT_ROWS rows; each chunk at least 64 rows deep; 0 where
    m > GEMV_MAX_M, which is not the gemv route's. More splits than that
    read slower on the H100 at every 2-D live and decode shape (each block
    then streams less and adds a cluster barrier and x's staging). An
    expert-batched call's working blocks are known only on the device (the
    experts that hold a row), so a block there streams at most 1 MB: a
    block that waits for a second wave then costs little (grok-1-314b's w2
    at decode, 8 MB blocks unsplit, read 1.24x slower with 6 experts hit
    than with 4 splits). A rule of shapes: for the expert-batched form
    ``experts`` is the bound on the experts a call hits (its grid's slots),
    never a count read from ``rows``."""
    if m > GEMV_MAX_M:
        return 0
    slabs = -(-n // (GEMV_ROW_BYTES // elem)) * experts
    rows_cap = GEMV_EXPERT_ROWS if experts > 1 else k
    splits = 1
    while splits < GEMV_MAX_SPLITS and 128 * splits <= k and (
            slabs * splits < sm_count - sm_count // 16 or -(-k // splits) > rows_cap):
        splits *= 2
    return splits


def narrow_tile(n: int, w_layout: str = "kn") -> tuple:
    """(rows, columns, K depth) of the narrow route's output tile and K tile:
    256 x 8 by 16 for a (K, N) weight of n <= 8 columns, else 128 x 128 by 8
    (the kernel's "thin" and "wide" tiles)."""
    return (256, 8, 16) if w_layout == "kn" and n <= NARROW_THIN_N else (128, 128, 8)


def narrow_splits(m: int, n: int, k: int, sm_count: int, experts: int = 1, w_layout: str = "kn") -> int:
    """How many K chunks the narrow route cuts a product into: 1 where the
    output's tiles (every expert's) fill the SMs; else about two blocks an
    SM (the kernel's occupancy), each chunk at least 8 K tiles deep. A rule
    of shapes: the router at M = 4096 makes 16 (grok-1-314b, E = 8) or 32
    (arctic-480b, E = 128) tiles, so 16 or 8 chunks; its dW's d x E output
    24 or 56, so 11 or 4."""
    bm, bn, bk = narrow_tile(n, w_layout)
    tiles = -(-m // bm) * -(-n // bn) * experts
    if tiles >= sm_count:
        return 1
    return max(1, min(2 * sm_count // tiles, k // (8 * bk)))


def stream_matmul(
    x: torch.Tensor, w: torch.Tensor, out_dtype=torch.bfloat16, w_layout: str = "kn",
    rows: Optional[torch.Tensor] = None, x_layout: str = "mk", experts_hit: Optional[int] = None,
) -> torch.Tensor:
    """``x @ w`` for x (M, K) and w (K, N) of one dtype, ``x @ w.T`` for w
    (N, K) with ``w_layout="nk"``, or ``x.T @ w`` for x (K, M) with
    ``x_layout="km"``; f32 accumulation, result in ``out_dtype`` (bfloat16
    or float32). For x and w stacked on a leading E, the expert-batched form
    (module docstring), with ``rows`` and ``experts_hit`` optional."""
    if w_layout not in W_LAYOUT_CODES or x_layout not in X_LAYOUT_CODES:
        raise ValueError(f"stream_matmul: w_layout {w_layout!r}, x_layout {x_layout!r}; need 'kn' or 'nk', "
                         "'mk' or 'km'")
    if x_layout == "km" and w_layout != "kn":
        raise ValueError("stream_matmul: an x given as (K, M) takes (K, N) weights only")
    if x.dim() == 3 or w.dim() == 3 or rows is not None or experts_hit is not None:
        return _stream_matmul_batched(x, w, out_dtype, w_layout, rows, x_layout, experts_hit)
    if takes_plain(x, w):
        return stream_matmul_ref(x, w, out_dtype, w_layout, x_layout=x_layout)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if x_layout != "mk":
            raise RuntimeError("stream_matmul: gradients are taken of the (M, K) @ (K, N) and (N, K) forms")
        return _StreamMatmul.apply(x, w, out_dtype, w_layout)
    return _stream_matmul_2d(x, w, out_dtype, w_layout, x_layout)


def _mkn(x, w, w_layout, x_layout):
    """(m, k, n, k of w) of a product from its operands' last two axes."""
    m, k = (x.shape[-1], x.shape[-2]) if x_layout == "km" else (x.shape[-2], x.shape[-1])
    n, kw = (w.shape[-2], w.shape[-1]) if w_layout == "nk" else (w.shape[-1], w.shape[-2])
    return m, k, n, kw


def _stream_matmul_2d(x, w, out_dtype, w_layout, x_layout="mk"):
    """The 2-D form on CUDA: checks, the route and one launch."""
    if not (on_card(x) and on_card(w) and x.device == w.device):
        raise ValueError(f"stream_matmul: x on {x.device}, w on {w.device}")
    m, k, n, kw = _mkn(x, w, w_layout, x_layout)
    if x.dim() != 2 or w.dim() != 2 or k != kw or 0 in (*x.shape, *w.shape):
        raise ValueError(f"stream_matmul: shapes {tuple(x.shape)} @ {tuple(w.shape)} ({x_layout}, {w_layout})")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"stream_matmul: dtypes {x.dtype} @ {w.dtype} -> {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stream_matmul: x and w must be contiguous")
    return _route_and_launch(x, w, out_dtype, w_layout, None, x_layout, 1, 1, m, n, k)


class _StreamMatmul(torch.autograd.Function):
    """The 2-D form with gradients through ``stream_matmul`` (module
    docstring)."""

    @staticmethod
    def forward(ctx, x, w, out_dtype, w_layout):
        ctx.save_for_backward(x, w)
        ctx.w_layout = w_layout
        return _stream_matmul_2d(x, w, out_dtype, w_layout)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.w_layout == "kn":  # y = x @ w, w (K, N)
            if ctx.needs_input_grad[0]:
                dx = stream_matmul(dy, w, out_dtype=x.dtype, w_layout="nk")
            if ctx.needs_input_grad[1]:
                dw = stream_matmul(x, dy, out_dtype=w.dtype, x_layout="km")
        else:  # y = x @ w.T, w (N, K)
            if ctx.needs_input_grad[0]:
                dx = stream_matmul(dy, w, out_dtype=x.dtype)
            if ctx.needs_input_grad[1]:
                if dy.dtype == torch.bfloat16 and dy.shape[1] % 8:  # rows TMA cannot stride
                    dw = stream_matmul(dy.T.contiguous(), x, out_dtype=w.dtype)
                else:
                    dw = stream_matmul(dy, x, out_dtype=w.dtype, x_layout="km")
        return dx, dw, None, None


class _StreamMatmulBatched(torch.autograd.Function):
    """The expert-batched (E, C, K) @ (E, K, N) form with gradients, two
    launches over the experts (module docstring). Rows past ``rows[e]`` of
    the output are 0 whatever x holds, so they pass no gradient back."""

    @staticmethod
    def forward(ctx, x, w, rows, out_dtype, slots):
        ctx.save_for_backward(x, w, rows)
        return _batched_launch(x, w, out_dtype, "kn", rows, "mk", slots)

    @staticmethod
    def backward(ctx, dy):
        x, w, rows = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:  # dY[e] @ W[e]^T: W[e] (K, N) read as the K-major weight
            dx = _batched_launch(dy, w, x.dtype, "nk", rows, "mk", x.shape[0], grad=True)
        if ctx.needs_input_grad[1]:  # X[e]^T @ dY[e] over the filled slots
            dw = _batched_launch(x, dy, w.dtype, "kn", rows, "km", x.shape[0], grad=True)
        return dx, dw, None, None, None


def _no_grad_on_cuda(what: str, tensors) -> None:
    """Raises for a CUDA call under grad with an input that requires grad: the
    kernel has no backward, and its result would carry no ``grad_fn``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(f"{what} has no backward on CUDA yet (ROADMAP.md §1); "
                           "call it under torch.no_grad() or on the CPU")


def _stream_matmul_batched(x, w, out_dtype, w_layout, rows, x_layout, experts_hit):
    """The expert-batched form: checks on both devices, the plain version on
    the CPU, on CUDA one launch, under autograd for the (E, C, K) @ (E, K,
    N) form. ``experts_hit`` (default E) bounds the experts that hold a row,
    a rule of shapes from the caller (the MoE layer's min(E, top_k x
    tokens)): the gemv route's grid walks them in that many slots and its K
    splits count their slabs. It never changes the result: more experts
    with rows than slots are walked in turn."""
    tensors = (x, w) if rows is None else (x, w, rows)
    plain = takes_plain(*tensors)
    if not plain and not all(on_card(t) and t.device == x.device for t in tensors):
        raise ValueError("stream_matmul: x, w, rows on " + ", ".join(str(t.device) for t in tensors))
    m, k, n, kw = _mkn(x, w, w_layout, x_layout)
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] or k != kw or 0 in (*x.shape, *w.shape):
        raise ValueError(f"stream_matmul: expert shapes {tuple(x.shape)} @ {tuple(w.shape)} "
                         f"({x_layout}, {w_layout})")
    if x.dtype != w.dtype or x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"stream_matmul: dtypes {x.dtype} @ {w.dtype} -> {out_dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("stream_matmul: x and w must be contiguous (a whole expert stack)")
    e = x.shape[0]
    if rows is not None:
        if rows.dtype != torch.int32:
            raise TypeError(f"stream_matmul: rows {rows.dtype}, need int32")
        if tuple(rows.shape) != (e,) or not rows.is_contiguous():
            raise ValueError(f"stream_matmul: rows {tuple(rows.shape)}, need a contiguous ({e},)")
    if experts_hit is not None and not (isinstance(experts_hit, int) and experts_hit >= 1):
        raise ValueError(f"stream_matmul: experts_hit {experts_hit!r}, need an int >= 1")
    slots = e if experts_hit is None else min(e, experts_hit)
    if plain:
        return stream_matmul_ref(x, w, out_dtype, w_layout, rows, x_layout)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        if (w_layout, x_layout) != ("kn", "mk"):
            raise RuntimeError("stream_matmul: gradients are taken of the (E, C, K) @ (E, K, N) form")
        return _StreamMatmulBatched.apply(x, w, rows, out_dtype, slots)
    return _batched_launch(x, w, out_dtype, w_layout, rows, x_layout, slots)


def _batched_launch(x, w, out_dtype, w_layout, rows, x_layout, slots, grad=False):
    """One launch of the expert-batched form on checked operands, counted in
    ``batched_launches``, or in ``batched_grad_launches`` for a gradient."""
    m, k, n, _ = _mkn(x, w, w_layout, x_layout)
    out = _route_and_launch(x, w, out_dtype, w_layout, rows, x_layout, x.shape[0], slots, m, n, k)
    if grad:
        stream_matmul.batched_grad_launches += 1
    else:
        stream_matmul.batched_launches += 1
    return out


def _route_and_launch(x, w, out_dtype, w_layout, rows, x_layout, e, slots, m, n, k):
    """The route of each expert's (m, k) @ (k, n), the gemv and narrow
    routes' K splits (the gemv's over ``slots`` experts' slabs), and one
    launch into a new output of x's rank: (m, n), or (e, m, n)."""
    route = mm_route(m, n, k, x.dtype, x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0, w_layout, x_layout)
    if route == "narrow":
        splits = narrow_splits(m, n, k, _build.sm_count(x.device), experts=e, w_layout=w_layout)
    elif route != "gemv":
        splits = 0
    else:  # a K-major row is one warp's dot product: no split-K
        splits = 1 if w_layout == "nk" else k_splits(m, n, k, _build.sm_count(x.device), slots, x.element_size())
    out = torch.empty((e, m, n) if x.dim() == 3 else (m, n), dtype=out_dtype, device=x.device)
    _launch(x, w, out, rows, e, slots, m, n, k, route, splits, w_layout, x_layout)
    return out


def _launch(x, w, out, rows, e, slots, m, n, k, route, splits, w_layout, x_layout):
    """One call of the C entry point, with a split-K workspace where the
    narrow route cuts K (the gemv's splits meet in a cluster and need none);
    raises on a CUDA error; counts the launch."""
    work = None
    if route == "narrow" and splits > 1:
        work = torch.empty((splits, e, m, n), dtype=torch.float32, device=x.device)
    if x.is_meta:  # the dry-run's memory pass: the launch's allocations, no launch
        memory.mark(work, "workspace")
        return
    fn = _build.function("streammm", "stream_matmul", _ARGTYPES)
    err = fn(
        x.data_ptr(), w.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        rows.data_ptr() if rows is not None else None,
        e, m, n, k, ROUTE_CODES[route], splits, slots, DTYPE_CODES[x.dtype], DTYPE_CODES[out.dtype],
        W_LAYOUT_CODES[w_layout], X_LAYOUT_CODES[x_layout], torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"stream_matmul ({route}, {x_layout}, {w_layout}, {e} experts)")
    stream_matmul.launches += 1
    if route == "wgmma":
        stream_matmul.wgmma_launches += 1
    elif route == "narrow":
        stream_matmul.narrow_launches += 1
    if w_layout == "nk":
        stream_matmul.nk_launches += 1


stream_matmul.launches = 0
stream_matmul.wgmma_launches = 0
stream_matmul.narrow_launches = 0
stream_matmul.nk_launches = 0
stream_matmul.batched_launches = 0
stream_matmul.batched_grad_launches = 0


def int8_k_splits(m: int, n: int, k: int, block_k: int, sm_count: int) -> int:
    """How many runs of whole k-groups (``block_k`` rows, one scale row) the
    int8 gemv path cuts a product into: enough blocks for about four per SM,
    each run at least 64 rows deep, no run empty; 0 where m > GEMV_MAX_M,
    which is not the gemv route's."""
    if m > GEMV_MAX_M:
        return 0
    groups = k // block_k
    col_blocks = -(-n // GEMV_COLS)
    want = max(1, min(-(-4 * sm_count // col_blocks), groups))
    per_split = max(-(-groups // want), -(-64 // block_k))
    return -(-groups // min(per_split, groups))


def int8_route(m: int, n: int, k: int, block_k: int, dtype: torch.dtype, aligned: bool) -> str:
    """The kernel route of an int8 (m, k) @ (k, n) product with scale groups of
    ``block_k`` rows: "gemv" for m <= 8; "wgmma" for bf16 x where TMA can
    describe the operands (n a multiple of 16, so that an int8 row is a
    multiple of 16 bytes; k a multiple of 8; ``block_k`` a multiple of the
    64-row k-tile, so that a scale group holds whole tiles; 16-byte aligned
    x, w_q and scales: ``aligned``); "simt" otherwise (f32 x, ragged shapes,
    ``block_k`` such as 100)."""
    if m <= GEMV_MAX_M:
        return "gemv"
    if dtype == torch.bfloat16 and n % 16 == 0 and k % 8 == 0 and block_k % INT8_TILE_K == 0 and aligned:
        return "wgmma"
    return "simt"


def int8_wgmma_splits(m: int, n: int, k: int, block_k: int, sm_count: int) -> int:
    """How many runs of whole scale groups the int8 wgmma route cuts K into:
    1 where the output tiles fill half the SMs, else enough runs for about
    that many tiles, at most one a group."""
    tiles = -(-m // INT8_TILE_M) * -(-n // INT8_TILE_N)
    return max(1, min(k // block_k, sm_count // (2 * tiles)))


def stream_matmul_int8(
    x: torch.Tensor, w_q: torch.Tensor, scales: torch.Tensor, block_k: int,
    out_dtype=torch.bfloat16,
) -> torch.Tensor:
    """``x @ (float(w_q) * scale)`` for x (M, K) bf16 or f32, w_q (K, N) int8
    and scales (K // block_k, N) f32, one scale per (k-group of ``block_k``
    rows, column); f32 accumulation, result in ``out_dtype`` (bfloat16 or
    float32). ``block_k`` is the scales' group and part of the contract; the
    JAX signature's ``block_m``/``block_n`` are TPU tile sizes and are
    dropped. Any M and N. The checks run on both devices."""
    tensors = (x, w_q, scales)
    plain = takes_plain(*tensors)
    if not plain and not all(on_card(t) and t.device == x.device for t in tensors):
        raise ValueError("stream_matmul_int8: x, w_q, scales on " + ", ".join(str(t.device) for t in tensors))
    if x.dim() != 2 or w_q.dim() != 2 or x.shape[1] != w_q.shape[0] or 0 in (*x.shape, w_q.shape[1]):
        raise ValueError(f"stream_matmul_int8: shapes {tuple(x.shape)} @ {tuple(w_q.shape)}")
    m, k = x.shape
    n = w_q.shape[1]
    if block_k <= 0 or k % block_k:
        raise ValueError(f"stream_matmul_int8: K = {k} is not a multiple of block_k = {block_k}")
    if tuple(scales.shape) != (k // block_k, n):
        raise ValueError(f"stream_matmul_int8: scales {tuple(scales.shape)}, need {(k // block_k, n)}")
    if w_q.dtype != torch.int8 or scales.dtype != torch.float32:
        raise TypeError(f"stream_matmul_int8: w_q {w_q.dtype}, scales {scales.dtype}; need int8, float32")
    if x.dtype not in DTYPE_CODES or out_dtype not in DTYPE_CODES:
        raise TypeError(f"stream_matmul_int8: x {x.dtype} -> {out_dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("stream_matmul_int8: x, w_q and scales must be contiguous")
    if plain:
        return stream_matmul_int8_ref(x, w_q, scales, block_k, out_dtype)
    _no_grad_on_cuda("stream_matmul_int8", tensors)
    route = int8_route(m, n, k, block_k, x.dtype, all(t.data_ptr() % 16 == 0 for t in tensors))
    if route == "gemv":
        splits = int8_k_splits(m, n, k, block_k, _build.sm_count(x.device))
    elif route == "wgmma":
        splits = int8_wgmma_splits(m, n, k, block_k, _build.sm_count(x.device))
    else:
        splits = 1
    out = torch.empty((m, n), dtype=out_dtype, device=x.device)
    work = torch.empty((splits, m, n), dtype=torch.float32, device=x.device) if splits > 1 else None
    if x.is_meta:
        memory.mark(work, "workspace")
        return out
    fn = _build.function("streammm_int8", "stream_matmul_int8", _INT8_ARGTYPES)
    err = fn(
        x.data_ptr(), w_q.data_ptr(), scales.data_ptr(), out.data_ptr(),
        work.data_ptr() if work is not None else None,
        m, n, k, block_k, ROUTE_CODES[route], splits, DTYPE_CODES[x.dtype], DTYPE_CODES[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream,
    )
    _build.check(err, f"stream_matmul_int8 ({route})")
    stream_matmul_int8.launches += 1
    if route == "wgmma":
        stream_matmul_int8.wgmma_launches += 1
    return out


stream_matmul_int8.launches = 0
stream_matmul_int8.wgmma_launches = 0
