"""Template-based memory prediction — the offline Memory Analyzer (paper §5.2).

Given profiled (launch args → touched extents) traces, the analyzer derives a
per-kernel, per-pointer *formula* mapping argument values to accessed byte
ranges, by matching three templates:

  T1 fixed   — region size invariant across invocations          (~77%)
  T2 linear  — contiguous region, size = c × Π(selected int args) (~18%)
  T3 strided — k equal chunks at a regular stride; chunk size,
               stride and count each fixed or linear in args      (~5%)

Remaining cases (pointer-chasing, <1%) are classified ``opaque`` and fall
back to demand paging at runtime (paper: 0.25% false negatives on average).

The analyzer never sees the workload generators' access closures: it works
purely from the recorded traces, exactly like the paper's NVBit-based flow.
"""
from __future__ import annotations

import dataclasses
import itertools
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.pages import Extent
from repro_torch.core.trace import Invocation, TraceStore

PTR_MIN = 1 << 32  # values below this are treated as 32-bit scalars

T1_FIXED = "fixed"
T2_LINEAR = "linear"
T3_STRIDED = "strided"
OPAQUE = "opaque"

MAX_PRODUCT_ARGS = 3


@dataclasses.dataclass(frozen=True)
class LinearTerm:
    """value = coeff × Π args[idx] (coeff a positive rational)."""

    coeff_num: int
    coeff_den: int
    arg_idxs: Tuple[int, ...]  # empty tuple => constant (coeff itself)

    def evaluate(self, args: Sequence[int]) -> int:
        prod = 1
        for i in self.arg_idxs:
            prod *= int(args[i])
        return (self.coeff_num * prod) // self.coeff_den


@dataclasses.dataclass(frozen=True)
class RegionFormula:
    """Prediction rule for one pointer argument of one kernel."""

    ptr_arg: int
    kind: str  # fixed | linear | strided | opaque
    size: Optional[LinearTerm] = None  # chunk size (or whole region size)
    stride: Optional[LinearTerm] = None  # T3 only
    count: Optional[LinearTerm] = None  # T3 only

    def predict_extents(self, args: Sequence[int]) -> List[Extent]:
        base = int(args[self.ptr_arg])
        if self.kind == OPAQUE:
            return []  # runtime falls back to demand paging
        size = self.size.evaluate(args)
        if self.kind in (T1_FIXED, T2_LINEAR):
            return [(base, size)] if size > 0 else []
        stride = self.stride.evaluate(args)
        count = self.count.evaluate(args)
        return [(base + i * stride, size) for i in range(count) if size > 0]


@dataclasses.dataclass
class KernelDescriptor:
    name: str
    formulas: List[RegionFormula]
    latency_us: float
    template_mix: Dict[str, int]  # counts per template kind (Table 2)

    def predict_extents(self, args: Sequence[int]) -> List[Extent]:
        out: List[Extent] = []
        for f in self.formulas:
            out.extend(f.predict_extents(args))
        return out

    def has_opaque(self) -> bool:
        return any(f.kind == OPAQUE for f in self.formulas)


# --------------------------------------------------------------------------
# Fitting
# --------------------------------------------------------------------------


def _pointer_args(invocations: List[Invocation]) -> List[int]:
    """Arg indices whose value is always the start of an observed extent."""
    if not invocations:
        return []
    n_args = len(invocations[0].args)
    out = []
    for i in range(n_args):
        ok = True
        for inv in invocations:
            v = inv.args[i]
            if v < PTR_MIN or not any(s == v for s, _ in inv.extents):
                ok = False
                break
        if ok:
            out.append(i)
    return out


def _attribute_extents(
    inv: Invocation, ptr_values: List[int]
) -> Tuple[Dict[int, List[Extent]], List[Extent]]:
    """Assign each raw extent to the largest pointer value <= its start that
    lies within the *same allocation* (the OS tracks cudaMalloc, §5.1).

    Returns (per-pointer merged regions, unattributed extents). Unattributed
    extents are indirect accesses: their base never appears among the launch
    arguments — the "Others" residue of Table 2.
    """
    from repro_torch.core.pages import merge_extents

    svals = sorted(ptr_values)
    allocs = sorted(inv.alloc_ranges or [])

    def alloc_of(addr: int) -> Optional[Extent]:
        lo, hi = 0, len(allocs) - 1
        best = None
        while lo <= hi:
            mid = (lo + hi) // 2
            if allocs[mid][0] <= addr:
                best = allocs[mid]
                lo = mid + 1
            else:
                hi = mid - 1
        if best is not None and best[0] <= addr < best[0] + best[1]:
            return best
        return None

    raw: Dict[int, List[Extent]] = {v: [] for v in ptr_values}
    unattributed: List[Extent] = []
    for ext in inv.extents:
        base = None
        for v in svals:
            if v <= ext[0]:
                base = v
            else:
                break
        if base is not None and allocs:
            a_ext = alloc_of(ext[0])
            a_ptr = alloc_of(base)
            if a_ext is None or a_ext != a_ptr:
                base = None
        if base is None:
            unattributed.append(ext)
        else:
            raw[base].append(ext)
    return {v: merge_extents(es) for v, es in raw.items()}, unattributed


def _scalar_candidates(invocations: List[Invocation], ptr_idxs: List[int]) -> List[int]:
    n_args = len(invocations[0].args)
    ptr_set = set(ptr_idxs)
    cands = []
    for i in range(n_args):
        if i in ptr_set:
            continue
        vals = [inv.args[i] for inv in invocations]
        if all(0 < v < PTR_MIN for v in vals):
            cands.append(i)
    return cands


def _fit_linear(
    values: List[int], invocations: List[Invocation], scalar_idxs: List[int]
) -> Optional[LinearTerm]:
    """Find value = c × Π args[subset] holding exactly for every invocation."""
    if all(v == values[0] for v in values):
        return LinearTerm(values[0], 1, ())
    for r in range(1, MAX_PRODUCT_ARGS + 1):
        for combo in itertools.combinations(scalar_idxs, r):
            prods = []
            for inv in invocations:
                prod = 1
                for i in combo:
                    prod *= int(inv.args[i])
                prods.append(prod)
            if any(p == 0 for p in prods):
                continue
            c = Fraction(values[0], prods[0])
            if c <= 0:
                continue
            if all(
                Fraction(v, p) == c for v, p in zip(values[1:], prods[1:])
            ):
                # require the product to actually vary (else it's T1)
                if len(set(prods)) > 1:
                    return LinearTerm(c.numerator, c.denominator, combo)
    return None


def _verify(
    formula: RegionFormula,
    invocations: List[Invocation],
    regions: List[List[Extent]],
) -> bool:
    """A formula is accepted only if it *exactly* reproduces the observed
    (merged) extents of every profiled invocation — strict template matching
    is what gives the paper its 0.00% false-positive rate."""
    from repro_torch.core.pages import merge_extents

    for inv, obs in zip(invocations, regions):
        pred = merge_extents(formula.predict_extents(inv.args))
        if pred != merge_extents(list(obs)):
            return False
    return True


def _fit_pointer(
    ptr_idx: int,
    invocations: List[Invocation],
    regions: List[List[Extent]],
    scalar_idxs: List[int],
) -> RegionFormula:
    # ---- contiguous region: T1 / T2 ---------------------------------------
    if all(len(r) == 1 for r in regions):
        sizes = [r[0][1] for r in regions]
        if all(s == sizes[0] for s in sizes):
            f = RegionFormula(ptr_idx, T1_FIXED, size=LinearTerm(sizes[0], 1, ()))
            if _verify(f, invocations, regions):
                return f
        term = _fit_linear(sizes, invocations, scalar_idxs)
        if term is not None:
            f = RegionFormula(ptr_idx, T2_LINEAR, size=term)
            if _verify(f, invocations, regions):
                return f
        return RegionFormula(ptr_idx, OPAQUE)

    # ---- strided: T3 -------------------------------------------------------
    # Fit chunk size / stride / count from the multi-chunk invocations, then
    # verify the formula against *all* invocations (single-chunk cases arise
    # when stride == chunk size and the trace merges into one extent).
    chunk_sizes: List[int] = []
    strides: List[int] = []
    counts: List[int] = []
    multi_invs: List[Invocation] = []
    regular = True
    for inv, r in zip(invocations, regions):
        if len(r) <= 1:
            continue
        starts = [s for s, _ in r]
        sizes = [sz for _, sz in r]
        st = starts[1] - starts[0]
        if any(sizes[0] != sz for sz in sizes) or any(
            starts[i + 1] - starts[i] != st for i in range(len(starts) - 1)
        ):
            regular = False
            break
        chunk_sizes.append(sizes[0])
        strides.append(st)
        counts.append(len(r))
        multi_invs.append(inv)
    if regular and multi_invs:
        size_t = _fit_linear(chunk_sizes, multi_invs, scalar_idxs)
        cnt_t = _fit_linear(counts, multi_invs, scalar_idxs)
        stride_t = _fit_linear(strides, multi_invs, scalar_idxs)
        if size_t is not None and cnt_t is not None and stride_t is not None:
            f = RegionFormula(
                ptr_idx, T3_STRIDED, size=size_t, stride=stride_t, count=cnt_t
            )
            if _verify(f, invocations, regions):
                return f
        # fall through: maybe the *total* region is linear (count folded in)
    return RegionFormula(ptr_idx, OPAQUE)


def analyze_kernel(name: str, invocations: List[Invocation]) -> KernelDescriptor:
    ptr_idxs = _pointer_args(invocations)
    scalar_idxs = _scalar_candidates(invocations, ptr_idxs)
    # deduplicate pointer args aliasing the same value stream
    seen_value_streams = set()
    uniq_ptrs = []
    for i in ptr_idxs:
        stream = tuple(inv.args[i] for inv in invocations)
        if stream not in seen_value_streams:
            seen_value_streams.add(stream)
            uniq_ptrs.append(i)

    attributed = [
        _attribute_extents(inv, [inv.args[i] for i in uniq_ptrs])
        for inv in invocations
    ]
    formulas = []
    mix: Dict[str, int] = {T1_FIXED: 0, T2_LINEAR: 0, T3_STRIDED: 0, OPAQUE: 0}
    for i in uniq_ptrs:
        regions = [attributed[j][0][inv.args[i]] for j, inv in enumerate(invocations)]
        if all(not r for r in regions):
            continue
        f = _fit_pointer(i, invocations, regions, scalar_idxs)
        formulas.append(f)
        mix[f.kind] += 1
    # extents whose base never appears among the args => indirect access
    if any(unattr for _, unattr in attributed):
        mix[OPAQUE] += 1
        formulas.append(RegionFormula(-1, OPAQUE))

    import statistics

    lat = statistics.fmean(i.latency_us for i in invocations)
    return KernelDescriptor(name, formulas, lat, mix)


def analyze_traces(store: TraceStore) -> Dict[str, KernelDescriptor]:
    """The offline phase output: one descriptor file entry per kernel."""
    return {
        name: analyze_kernel(name, invs)
        for name, invs in store.by_kernel.items()
    }


def template_mix_table(
    descriptors: Dict[str, KernelDescriptor], store: TraceStore
) -> Dict[str, float]:
    """Invocation-weighted template share (reproduces paper Table 2)."""
    totals = {T1_FIXED: 0, T2_LINEAR: 0, T3_STRIDED: 0, OPAQUE: 0}
    for name, desc in descriptors.items():
        n_inv = len(store.by_kernel[name])
        region_total = sum(desc.template_mix.values()) or 1
        for kind, cnt in desc.template_mix.items():
            totals[kind] += n_inv * cnt / region_total
    s = sum(totals.values()) or 1.0
    return {k: 100.0 * v / s for k, v in totals.items()}
