"""``paged_attention(..., return_lse=True)`` and the merge of the sharded
decode (``sharding.fsdp.merge_attention``) on the CPU.

The plain version's ``lse`` is ``torch.logsumexp`` of the scaled scores
over each row's valid slots (-inf for a row of length 0, whose output stays
zeros), computed here from the pools directly. A cache cut into 2, 4 and 8
pieces of its sequence, each attended alone with its ``lse`` (lengths
``clamp(len - start, 0, n)``, as a rank of the sharded decode takes them:
pieces past a row's length hold no valid slot) and merged, gives the JAX
``paged_attention`` over the whole cache, run in interpret mode as
``tests/test_torch_paged_attention.py`` runs it: within 1e-5 in f32 (the
merge's exponentials and sums in another order), 5e-2 in bf16 (each
piece's output rounded to bf16 before the merge; the reference's kernel
tolerance). The CUDA kernel's ``lse`` against this plain version:
``tests/test_torch_cuda.py``."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.paged_attention.kernel import paged_attention as jax_paged  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.sharding.fsdp import merge_attention  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5), "bfloat16": (jnp.bfloat16, torch.bfloat16, 5e-2)}
# (B, H, Hkv, D, slots, page_tokens, lengths): a length of 0, of 1 (every
# piece but the first empty), across piece boundaries, and the whole cache
CASES = [
    (4, 4, 2, 32, 64, 8, (0, 1, 29, 64)),
    (3, 8, 1, 64, 64, 4, (33, 8, 57)),
    (2, 6, 2, 32, 32, 4, (17, 32)),
]


def _inputs(b, h, hkv, d, slots, dtype, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d), np.float32)
    k = rng.standard_normal((b, slots, hkv, d), np.float32)
    v = rng.standard_normal((b, slots, hkv, d), np.float32)
    td = DTYPES[dtype][1]
    return (q, k, v), tuple(torch.from_numpy(a).to(td) for a in (q, k, v))


def _pieces(k, v, lengths, n_pieces, pt):
    """Each piece's (pool_k, pool_v, table, lengths) of a cache (B, S, Hkv,
    D) cut into ``n_pieces`` runs of slots, as a rank's shard is viewed."""
    b, slots, hkv, d = k.shape
    n = slots // n_pieces
    table = torch.arange(b * n // pt, dtype=torch.int32).reshape(b, n // pt)
    out = []
    for p in range(n_pieces):
        ks, vs = (t[:, p * n : (p + 1) * n].contiguous().view(b * n // pt, pt, hkv, d) for t in (k, v))
        lens = (torch.tensor(lengths, dtype=torch.int32) - p * n).clamp(0, n)
        out.append((ks, vs, table, lens))
    return out


@pytest.mark.parametrize("b,h,hkv,d,slots,pt,lengths", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_lse_is_the_logsumexp_of_the_scaled_scores(b, h, hkv, d, slots, pt, lengths, dtype):
    _, (q, k, v) = _inputs(b, h, hkv, d, slots, dtype)
    table = torch.arange(b * slots // pt, dtype=torch.int32).reshape(b, slots // pt)
    lens = torch.tensor(lengths, dtype=torch.int32)
    pools = (t.view(b * slots // pt, pt, hkv, d) for t in (k, v))
    out, lse = pa_ops.paged_attention(q, *pools, table, lens, return_lse=True)
    assert lse.shape == (b, h) and lse.dtype == torch.float32
    assert torch.equal(out, paged_attention_ref(q, *(t.view(-1, pt, hkv, d) for t in (k, v)), table, lens))
    scale = 1.0 / math.sqrt(d)
    for row, n in enumerate(lengths):
        if n == 0:
            assert torch.isneginf(lse[row]).all() and not out[row].any()
            continue
        kh = k[row, :n].float().repeat_interleave(h // hkv, dim=1)  # (n, H, D)
        scores = torch.einsum("hd,nhd->hn", q[row].float() * scale, kh)
        torch.testing.assert_close(lse[row], torch.logsumexp(scores, dim=-1), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("b,h,hkv,d,slots,pt,lengths", CASES)
@pytest.mark.parametrize("n_pieces", [2, 4, 8])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_merged_pieces_equal_the_whole_cache(b, h, hkv, d, slots, pt, lengths, n_pieces, dtype):
    jd, _, tol = DTYPES[dtype]
    (qn, kn, vn), (q, k, v) = _inputs(b, h, hkv, d, slots, dtype, seed=1)
    n = slots // n_pieces
    pieces = _pieces(k, v, lengths, n_pieces, min(pt, n))
    outs, lses = zip(*(paged_attention_ref(q, *piece, return_lse=True) for piece in pieces))
    got = merge_attention(torch.stack(outs), torch.stack(lses), lambda t: t.amax(0, keepdim=True),
                          lambda t: t.sum(0))
    table = np.arange(b * slots // pt, dtype=np.int32).reshape(b, slots // pt)
    pools = [jnp.asarray(a.reshape(b * slots // pt, pt, hkv, d)).astype(jd) for a in (kn, vn)]
    lens = jnp.asarray(np.array(lengths, np.int32))
    want = jax_paged(jnp.asarray(qn).astype(jd), *pools, jnp.asarray(table), lens, interpret=True)
    want = np.asarray(want, np.float32)
    assert got.shape == (b, h, d) and got.dtype == q.dtype
    for row, length in enumerate(lengths):
        if length == 0:  # every piece empty: the merge divides 0 by 0, as no row of the decode can
            continue
        np.testing.assert_allclose(got[row].float().numpy(), want[row], rtol=tol, atol=tol)


def test_meta_wrapper_allocates_lse_under_the_memory_pass():
    """On meta under a card count the wrapper takes its CUDA path up to the
    launch: it allocates the output and, with ``return_lse``, the (B, H) f32
    ``lse``, and launches nothing."""
    from repro_torch.roofline import memory

    q = torch.empty((2, 4, 32), device="meta")
    pool = torch.empty((8, 16, 2, 32), device="meta")
    table = torch.empty((2, 4), dtype=torch.int32, device="meta")
    lens = torch.empty((2,), dtype=torch.int32, device="meta")
    before = pa_ops.paged_attention.launches
    (out, lse), count = memory.count(lambda: pa_ops.paged_attention(q, pool, pool, table, lens, return_lse=True),
                                     card=True)
    assert out.shape == (2, 4, 32) and lse.shape == (2, 4) and lse.dtype == torch.float32
    assert count.output == 2 * 4 * 32 * 4 + 2 * 4 * 4
    assert pa_ops.paged_attention.launches == before
