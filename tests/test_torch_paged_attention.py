"""The port's paged-KV decode attention against the JAX package's: the plain
PyTorch version (``ref.py``) against the Pallas kernel in interpret mode and
against the JAX ``paged_attention_ref``, on the same numpy inputs, and the
wrapper's CPU dispatch. Tolerance: rtol = atol = 5e-2, the reference's own
(tests/kernels/test_kernels.py), since bf16 rounds at other places in the two
frameworks. The CUDA kernel itself is held against ``ref.py`` on the card by
``test_torch_cuda.py``; here the split rule ``pa_splits`` and a plain
emulation of the kernel's split-KV algorithm (each run of pages reduced to
an f32 (m, l, acc), the runs merged in order) are held against both
references."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import paged_attention as jax_paged  # noqa: E402
from repro.kernels.paged_attention.ref import paged_attention_ref as jax_paged_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402

RTOL = ATOL = 5e-2
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
PA_CASES = [
    # (B, H, Hkv, D, page_tokens, max_pages): the reference's PA_CASES, then
    # a group of g = 3 query heads (llama3.2's H 24 / Hkv 8, narrowed) and the
    # hybrid's shape
    (2, 4, 2, 32, 16, 4),
    (3, 8, 1, 64, 32, 3),
    (1, 4, 4, 32, 16, 8),
    (2, 6, 2, 32, 16, 4),
    # recurrentgemma-9b's local attention: MQA with g = 16 at head dim 256
    (2, 16, 1, 256, 16, 4),
]


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


def _inputs(b, h, hkv, d, pt, n_pool, dtype, seed):
    """q and the two pools, the same values as JAX arrays and torch tensors."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    arrays = [
        rng.standard_normal(shape, np.float32)
        for shape in ((b, h, d), (n_pool, pt, hkv, d), (n_pool, pt, hkv, d))
    ]
    return [jnp.asarray(a).astype(jd) for a in arrays], [torch.from_numpy(a).to(td) for a in arrays]


def _check_against_pallas(jx, tx, table, lengths):
    table, lengths = np.asarray(table, np.int32), np.asarray(lengths, np.int32)
    ours = paged_attention_ref(*tx, torch.from_numpy(table), torch.from_numpy(lengths))
    ref = jax_paged(*jx, jnp.asarray(table), jnp.asarray(lengths), interpret=True)
    assert ours.shape == tuple(ref.shape) and ours.dtype == tx[0].dtype
    _close(ours, ref)
    return ours


@pytest.mark.parametrize("b,h,hkv,d,pt,mp", PA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_pallas(b, h, hkv, d, pt, mp, dtype):
    # the reference test's table and lengths: mp distinct pages a sequence,
    # lengths somewhere mid-page
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp + 2, dtype, seed=3)
    table = np.arange(b * mp).reshape(b, mp)
    lengths = [1 + (i * 7) % (pt * mp - 1) for i in range(b)]
    _check_against_pallas(jx, tx, table, lengths)


@pytest.mark.parametrize("length", [1, 16, 17, 32, 64])
def test_ref_matches_pallas_growing_length(length):
    """Decode realism: a growing length touches one more page at each page
    boundary (the reference's growing-length case, page_tokens 16)."""
    b, h, hkv, d, pt, mp = 1, 4, 2, 32, 16, 4
    jx, tx = _inputs(b, h, hkv, d, pt, mp, "bfloat16", seed=4)
    _check_against_pallas(jx, tx, np.arange(mp)[None], [length])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_ref_matches_pallas_permuted_table(dtype):
    b, h, hkv, d, pt, mp = 3, 6, 2, 32, 8, 5
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp + 3, dtype, seed=5)
    table = np.random.default_rng(6).permutation(b * mp + 3)[: b * mp].reshape(b, mp)
    _check_against_pallas(jx, tx, table, [37, 9, 40])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_length_zero_gives_zeros_like_the_kernel(dtype):
    b, h, hkv, d, pt, mp = 3, 4, 2, 32, 16, 2
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp, dtype, seed=7)
    ours = _check_against_pallas(jx, tx, np.arange(b * mp).reshape(b, mp), [5, 0, 32])
    assert not ours[1].any() and ours[0].abs().sum() > 0 and ours[2].abs().sum() > 0


@pytest.mark.parametrize("b,h,hkv,d,pt,mp", PA_CASES)
def test_ref_matches_jax_ref_for_nonzero_lengths(b, h, hkv, d, pt, mp):
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp, "float32", seed=8)
    table = np.random.default_rng(9).permutation(b * mp).reshape(b, mp).astype(np.int32)
    lengths = np.asarray([pt * mp - 3 * i for i in range(b)], np.int32)
    ours = paged_attention_ref(*tx, torch.from_numpy(table), torch.from_numpy(lengths))
    _close(ours, jax_paged_ref(*jx, jnp.asarray(table), jnp.asarray(lengths)))


def test_cpu_dispatch_takes_plain_path():
    _, (q, pk, pv) = _inputs(2, 6, 2, 16, 4, 6, "bfloat16", seed=10)
    table = torch.tensor([[0, 2, 4], [5, 3, 1]], dtype=torch.int32)
    lengths = torch.tensor([11, 3], dtype=torch.int32)
    before = pa_ops.paged_attention.launches
    out = pa_ops.paged_attention(q, pk, pv, table, lengths)
    assert pa_ops.paged_attention.launches == before
    assert torch.equal(out, paged_attention_ref(q, pk, pv, table, lengths))


def _split_merge(q, pool_k, pool_v, table, lengths, splits):
    """The CUDA kernel's algorithm in plain f32 PyTorch: each row's pages cut
    into ``splits`` runs of ceil(max_pages / splits) pages; each run reduced
    over its tokens below the row's length to (m, l, acc), scores in log2
    units, an empty run giving (-1e30, 0, 0); the runs merged in run order;
    the output acc / max(l, 1e-30)."""
    b, h, d = q.shape
    _, pt, hkv, _ = pool_k.shape
    g = h // hkv
    mp = table.shape[1]
    pps = -(-mp // splits)
    neg = torch.tensor(-1e30)
    k = pool_k[table.long()].reshape(b, mp * pt, hkv, d).float()
    v = pool_v[table.long()].reshape(b, mp * pt, hkv, d).float()
    qf = q.float().reshape(b, hkv, g, d) * (math.log2(math.e) / math.sqrt(d))
    s = torch.einsum("bkgd,btkd->bkgt", qf, k)
    lens = lengths.long().clamp(0, mp * pt)[:, None, None, None]
    pos = torch.arange(mp * pt)[None, None, None, :]
    runs = []
    for i in range(splits):
        lo, hi = i * pps * pt, min(mp, (i + 1) * pps) * pt
        valid = (pos[..., lo:hi] < lens) if lo < hi else torch.zeros((1, 1, 1, 0), dtype=torch.bool)
        sc = torch.where(valid, s[..., lo:hi], neg)
        m = sc.amax(-1, keepdim=True) if lo < hi else neg.expand(b, hkv, g, 1)
        p = torch.where(valid, torch.exp2(sc - m), torch.zeros(()))
        runs.append((m, p.sum(-1, keepdim=True), torch.einsum("bkgt,btkd->bkgd", p, v[:, lo:hi])))
    m_all = torch.stack([m for m, _, _ in runs]).amax(0)
    l_all, acc = torch.zeros_like(m_all), torch.zeros((b, hkv, g, d))
    for m, l, a in runs:
        f = torch.exp2(m - m_all)
        l_all, acc = l_all + l * f, acc + a * f
    return (acc / l_all.clamp_min(1e-30)).reshape(b, h, d)


@pytest.mark.parametrize(
    "b,hkv,max_pages,sm_count,want",
    [
        (4, 8, 17, 132, 9),  # the dense decode shapes: runs of 2 pages, the last of 1
        (4, 2, 8, 132, 8),  # the kernel bench's shape: one page a run
        (1, 1, 1, 132, 1),  # one page: nothing to split
        (128, 8, 17, 132, 1),  # B * Hkv already >= 4 * SMs
        (32, 8, 17, 132, 2),
        (1, 8, 1000, 132, 33),
        (600, 1, 1000, 132, 16),  # runs capped at 64 pages
    ],
)
def test_pa_splits(b, hkv, max_pages, sm_count, want):
    splits = pa_ops.pa_splits(b, hkv, max_pages, sm_count)
    assert splits == want
    per = -(-max_pages // splits)
    assert 1 <= splits <= max_pages and per <= pa_ops.PA_MAX_SPLIT_PAGES
    assert (splits - 1) * per < max_pages  # no run lies past the table


SPLIT_CASES = [
    # (B, H, Hkv, D, page_tokens, max_pages, lengths): g = 3 with a row that
    # ends inside the first run (the other runs empty), a row of length 0
    # (every run empty) and a row on a run boundary (3 pages of 8 at 2 pages
    # a run ends the second run); max_pages not a multiple of the run
    (3, 6, 2, 32, 8, 5, (5, 0, 24)),
    (2, 4, 2, 32, 16, 4, (16, 64)),
    (2, 4, 4, 16, 3, 7, (21, 2)),
]


@pytest.mark.parametrize("b,h,hkv,d,pt,mp,lengths", SPLIT_CASES)
@pytest.mark.parametrize("splits", [1, 2, 3, "pages", "rule"])
def test_split_merge_matches_both_references(b, h, hkv, d, pt, mp, lengths, splits):
    splits = {"pages": mp, "rule": pa_ops.pa_splits(b, hkv, mp, 132)}.get(splits, splits)
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp + 2, "float32", seed=11)
    table = np.random.default_rng(12).permutation(b * mp + 2)[: b * mp].reshape(b, mp).astype(np.int32)
    tt, lt = torch.from_numpy(table), torch.tensor(lengths, dtype=torch.int32)
    ours = _split_merge(*tx, tt, lt, splits)
    ref = paged_attention_ref(*tx, tt, lt)
    # the same f32 function up to the order of sums and exp2 against exp
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-6)
    for row, n in enumerate(lengths):
        if n == 0:
            assert not ours[row].any()
    _close(ours, jax_paged(*jx, jnp.asarray(table), jnp.asarray(np.asarray(lengths, np.int32)), interpret=True))


@pytest.mark.parametrize("splits", [1, 2, 3, "pages", "rule"])
def test_split_merge_at_head_dim_256(splits):
    """The hybrid's ring decode (g = 16, D = 256): a full ring of 64 slots
    (min(index + 1, w) = w) beside one that has not wrapped yet. The same
    check as above, with atol 1e-5: each score is a 256-term f32 dot product
    whose sums run in another order (errors ~sqrt(256) x 2^-24 of terms of
    order 1), and the outputs (rms ~0.06) are small differences of weighted
    sums of V; 1.3e-6 was measured."""
    b, h, hkv, d, pt, mp, lengths = 2, 16, 1, 256, 16, 4, (64, 37)
    splits = {"pages": mp, "rule": pa_ops.pa_splits(b, hkv, mp, 132)}.get(splits, splits)
    jx, tx = _inputs(b, h, hkv, d, pt, b * mp + 2, "float32", seed=11)
    table = np.random.default_rng(12).permutation(b * mp + 2)[: b * mp].reshape(b, mp).astype(np.int32)
    tt, lt = torch.from_numpy(table), torch.tensor(lengths, dtype=torch.int32)
    ours = _split_merge(*tx, tt, lt, splits)
    torch.testing.assert_close(ours, paged_attention_ref(*tx, tt, lt), rtol=1e-5, atol=1e-5)
    _close(ours, jax_paged(*jx, jnp.asarray(table), jnp.asarray(np.asarray(lengths, np.int32)), interpret=True))
