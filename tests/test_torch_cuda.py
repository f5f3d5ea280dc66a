"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a card; on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed. Tolerance: rtol = atol = 5e-2,
the reference's kernel-test tolerance (tests/kernels/test_kernels.py): the
kernels accumulate in f32 in another order than the plain versions and
round to bf16 at other places. ``paged_attention`` is also held to a gate
scaled to its output: over a thousand slots its outputs have an rms near
0.05, so 5e-2 alone would pass a dropped page.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_ref  # noqa: E402

RTOL = ATOL = 5e-2
# max |out - ref| <= PA_REL * rms(ref): about 10x the measured bf16 error at
# the decode shapes (2.4e-4 against an rms of 0.05), while a page dropped or
# read from a wrong slot moves outputs by a share of their size
PA_REL = 5e-2
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
FA_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window): the reference's FA_CASES, then
    # the live step, a ragged prefill with a window, and odd sizes
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (2, 128, 128, 4, 1, 32, True, 64),
    (1, 128, 128, 4, 4, 32, False, 0),
    (1, 1, 1, 16, 8, 128, True, 0),
    (1, 300, 300, 24, 8, 128, True, 100),
    (1, 5, 77, 6, 2, 80, False, 0),
    (2, 70, 40, 4, 2, 64, True, 16),  # Sq > Skv: no tile skipping
]

PA_CASES = [
    # (B, H, Hkv, D, page_tokens, max_pages, lengths, permuted table): the
    # reference's PA_CASES with its lengths, its growing-length case, g = 3,
    # a permuted table with a row of length 0, the decode shapes of qwen3-1.7b
    # and llama3.2-3b (B = 4, Smax = 1088 in pages of 64), odd sizes, and a
    # group wider than one block's 8 heads
    (2, 4, 2, 32, 16, 4, (1, 8), False),
    (3, 8, 1, 64, 32, 3, (1, 8, 15), False),
    (1, 4, 4, 32, 16, 8, (1,), False),
    (5, 4, 2, 32, 16, 4, (1, 16, 17, 32, 64), False),
    (2, 6, 2, 32, 16, 4, (37, 9), False),
    (3, 6, 2, 32, 8, 5, (37, 0, 40), True),
    (4, 16, 8, 128, 64, 17, (1025, 1046, 1067, 1088), False),
    (4, 24, 8, 128, 64, 17, (1025, 1046, 1067, 1088), True),
    (2, 10, 2, 30, 5, 7, (33, 35), True),
    (2, 20, 1, 80, 3, 9, (27, 14), False),
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: run on a machine with an H100 (README, 'PyTorch port')")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _randn(shape, dtype, dev, seed, scale=1.0):
    a = np.random.default_rng(seed).standard_normal(shape, np.float32) * scale
    return torch.from_numpy(a).to(dev).to(dtype)


def _close(a, b):
    torch.testing.assert_close(a.float(), b.float(), rtol=RTOL, atol=ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize(
    "m,k,n",
    [(1, 2048, 2048), (1, 3072, 1024), (1, 8192, 3072), (1, 2048, 151936),
     (3, 300, 1001), (8, 64, 7), (9, 300, 1001), (256, 2048, 2048)],
)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_kernel(cuda, m, k, n, dtype):
    dt = DTYPES[dtype]
    x = _randn((m, k), dt, cuda, 0)
    w = _randn((k, n), dt, cuda, 1, scale=k ** -0.5)
    before = mm_ops.stream_matmul.launches
    out = mm_ops.stream_matmul(x, w, out_dtype=dt)
    assert mm_ops.stream_matmul.launches == before + 1
    _close(out, stream_matmul_ref(x, w, out_dtype=dt))
    assert torch.equal(out, mm_ops.stream_matmul(x, w, out_dtype=dt))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_kernel(cuda, b, sq, skv, h, hkv, d, causal, window, dtype):
    dt = DTYPES[dtype]
    q = _randn((b, sq, h, d), dt, cuda, 2)
    k = _randn((b, skv, hkv, d), dt, cuda, 3)
    v = _randn((b, skv, hkv, d), dt, cuda, 4)
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_ops.flash_attention.launches == before + 1
    _close(out, attention_ref(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul(x, torch.zeros((4, 3), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, torch.zeros((4, 6), device=cuda)[:, ::2])
    q = torch.zeros((1, 2, 2, 256), device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)  # head dim above 128


def _pa_inputs(b, h, hkv, d, pt, mp, lengths, permuted, dt, dev):
    n_pool = b * mp + 3
    q = _randn((b, h, d), dt, dev, 5)
    pool_k = _randn((n_pool, pt, hkv, d), dt, dev, 6)
    pool_v = _randn((n_pool, pt, hkv, d), dt, dev, 7)
    ids = np.random.default_rng(8).permutation(n_pool) if permuted else np.arange(n_pool)
    table = torch.from_numpy(ids[: b * mp].reshape(b, mp).astype(np.int32)).to(dev)
    lens = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pool_k, pool_v, table, lens


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,hkv,d,pt,mp,lengths,permuted", PA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_paged_attention_kernel(cuda, b, h, hkv, d, pt, mp, lengths, permuted, dtype):
    args = _pa_inputs(b, h, hkv, d, pt, mp, lengths, permuted, DTYPES[dtype], cuda)
    before = pa_ops.paged_attention.launches
    out = pa_ops.paged_attention(*args)
    assert pa_ops.paged_attention.launches == before + 1
    ref = paged_attention_ref(*args)
    _close(out, ref)
    err = float((out.float() - ref.float()).abs().max())
    assert err <= PA_REL * float(ref.float().pow(2).mean().sqrt()), err
    assert torch.equal(out, pa_ops.paged_attention(*args))  # no atomics
    for row, length in enumerate(lengths):
        if length == 0:
            assert not out[row].any()


@pytest.mark.cuda
def test_paged_attention_raises_on_what_the_kernel_does_not_take(cuda):
    q, pool_k, pool_v, table, lens = _pa_inputs(2, 4, 2, 32, 16, 4, (5, 9), False, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        pa_ops.paged_attention(q, pool_k, pool_v, table.cpu(), lens)  # mixed devices
    with pytest.raises(ValueError):
        pa_ops.paged_attention(q.cpu(), pool_k, pool_v, table, lens)
    with pytest.raises(TypeError):
        pa_ops.paged_attention(q, pool_k, pool_v, table.long(), lens)  # int64 table
    with pytest.raises(TypeError):
        pa_ops.paged_attention(q, pool_k, pool_v, table, lens.long())
    with pytest.raises(TypeError):
        pa_ops.paged_attention(q.float(), pool_k, pool_v, table, lens)
    with pytest.raises(ValueError):
        pa_ops.paged_attention(q, pool_k, pool_v, table[:, ::2], lens)  # not contiguous
    wide = _pa_inputs(2, 4, 2, 256, 16, 4, (5, 9), False, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        pa_ops.paged_attention(*wide)  # head dim above 128


@pytest.mark.cuda
def test_decode_past_the_cache_raises_on_the_card(cuda):
    """At index == Smax decode raises IndexError on the host before it writes,
    where the reference clamps into the last slot; the card stays usable."""
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    fns = build_model(get_config("qwen3-1.7b").reduced())
    params = fns.init(torch.Generator(cuda).manual_seed(0))
    tokens = torch.ones((1, 4), dtype=torch.long, device=cuda)
    with torch.inference_mode():
        _, cache = fns.prefill(params, {"tokens": tokens}, max_seq=4)
        k = cache["k"].clone()
        with pytest.raises(IndexError, match="out of bounds"):
            fns.decode_step(params, cache, {"tokens": tokens[:, :1]})
        torch.cuda.synchronize()
        assert torch.equal(cache["k"], k) and int(cache["index"]) == 4
