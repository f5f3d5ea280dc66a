"""The port's paged-KV decode attention against the JAX package's: the plain
PyTorch version (``ref.py``) against the Pallas kernel in interpret mode and
against the JAX ``paged_attention_ref``, on the same numpy inputs, and the
wrapper's CPU dispatch. Tolerance: rtol = atol = 5e-2, the reference's own
(tests/kernels/test_kernels.py), since bf16 rounds at other places in the two
frameworks. The CUDA kernel itself is held against ``ref.py`` on the card by
``test_torch_cuda.py``."""
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
    # a group of g = 3 query heads (llama3.2's H 24 / Hkv 8, narrowed)
    (2, 4, 2, 32, 16, 4),
    (3, 8, 1, 64, 32, 3),
    (1, 4, 4, 32, 16, 8),
    (2, 6, 2, 32, 16, 4),
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
