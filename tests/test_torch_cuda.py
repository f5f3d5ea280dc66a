"""The port's CUDA kernels against their plain PyTorch versions on the card
(``stream_matmul``'s expert-batched form too; both attention kernels up to
head dim 256), the MoE layer on the card against the CPU and without a host
sync, mamba2 and minicpm-2b at full width on the card against the CPU, the
hybrid's ring decode on the card against the CPU and without a host sync;
and the training path's kernels: ``flash_attention``'s backward against the
plain version's gradients (f32 at relative L2 1e-4, bf16 at 2e-2 against
the f32 gradients), ``stream_matmul``'s gradients in both weight layouts,
the backward's tensor-core route (GQA ratios 1-8) and the forward's row
statistics that it reads, the expert-batched form's gradients on its three
routes, the wrappers that have no backward raising under grad, and train
steps on the card against the CPU (the MoE pair too) without a host sync;
the one-rank NCCL mesh's train steps equal to the meshless ones bit for bit,
checkpoints crossing between them, and ``examples/port_train_lm.py``'s
restart giving the uninterrupted run's losses bit for bit.

Every test here is marked ``cuda`` and skips without a card; on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed. Tolerance: rtol = atol = 5e-2,
the reference's kernel-test tolerance (tests/kernels/test_kernels.py): the
kernels accumulate in f32 in another order than the plain versions and
round to bf16 at other places. ``paged_attention`` is also held to a gate
scaled to its output: over a thousand slots its outputs have an rms near
0.05, so 5e-2 alone would pass a dropped page. ``flash_attention``'s
tensor-core route is also held to relative L2 <= 1e-2: at S = 1024 late rows
have outputs of rms ~0.04, so atol 5e-2 alone would pass a dropped KV tile;
rounding P to bf16 gives ~2e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.paged_attention import ops as pa_ops  # noqa: E402
from repro_torch.kernels.paged_attention.ref import paged_attention_ref  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_int8_ref, stream_matmul_ref  # noqa: E402

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
    # qwen2-vl-7b's g = 7 (H 28 / Hkv 4), and hubert-xlarge's bidirectional
    # D = 80 over 16 heads (the simt route) at a full 1024-frame sequence
    (1, 77, 77, 28, 4, 128, True, 0),
    (1, 1024, 1024, 16, 16, 80, False, 0),
    # recurrentgemma-9b (MQA, g = 16, D = 256, the simt route's second
    # instance): its live call, a causal prefill, windows that the sequence
    # outgrows (tiles before the window skipped), Sq > Skv, an odd D above 128
    (1, 1, 1, 16, 1, 256, True, 0),
    (2, 300, 300, 16, 1, 256, True, 0),
    (1, 700, 700, 16, 1, 256, True, 128),
    (2, 96, 96, 16, 1, 256, True, 16),
    (1, 70, 40, 16, 1, 256, True, 16),
    (1, 65, 65, 4, 2, 200, False, 0),
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
    # the split rule's edges (pa_splits: runs of 2 pages of 64 at the decode
    # shapes): rows that end inside the first run (the other runs empty, one
    # row of length 0), lengths on run boundaries, a table of 205 pages in
    # runs of 7 (the last run short), and g = 16 (two blocks of 8 heads)
    (4, 24, 8, 128, 64, 17, (1, 64, 127, 0), True),
    (4, 16, 8, 128, 64, 17, (128, 256, 640, 1088), False),
    (1, 16, 8, 128, 64, 205, (12000,), True),
    (2, 32, 2, 128, 64, 17, (1088, 700), True),
    # the new families' decode shapes: qwen2-vl-7b (g = 7 in one block of 8
    # heads), minicpm-2b (MHA, D = 64), hubert-xlarge (D = 80)
    (4, 28, 4, 128, 64, 17, (1025, 1046, 1067, 1088), True),
    (3, 28, 4, 128, 16, 5, (37, 0, 80), False),
    (4, 36, 36, 64, 64, 17, (1025, 1046, 1067, 1088), False),
    (4, 16, 16, 80, 64, 17, (1025, 1046, 1067, 1088), False),
    # recurrentgemma-9b's ring decode (MQA, g = 16 in 4 blocks of 4 heads, D =
    # 256): a full ring of 1024 slots in pages of 64, a ring that has not
    # wrapped yet (and a row of length 0), g = 3 and an odd D above 128
    (4, 16, 1, 256, 64, 16, (1024, 1024, 1024, 1024), False),
    (4, 16, 1, 256, 64, 16, (1, 300, 1023, 0), True),
    (2, 6, 2, 256, 16, 5, (37, 80), True),
    (2, 8, 1, 200, 16, 4, (64, 17), False),
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


WGMMA_MM_CASES = [
    # (M, K, N): mamba2's in_proj at prefill (N not a multiple of 128), the
    # decode-vs-forward check's 4 x 1088 rows, ragged M, N and K tails
    (4096, 2048, 8512), (4352, 2048, 2048), (200, 264, 136), (130, 72, 8),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", WGMMA_MM_CASES)
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
def test_stream_matmul_wgmma_route(cuda, m, k, n, out_dtype):
    x = _randn((m, k), torch.bfloat16, cuda, 0)
    w = _randn((k, n), torch.bfloat16, cuda, 1, scale=k ** -0.5)
    odt = DTYPES[out_dtype]
    assert mm_ops.mm_route(m, n, k, x.dtype, True) == "wgmma"
    before = mm_ops.stream_matmul.wgmma_launches
    out = mm_ops.stream_matmul(x, w, out_dtype=odt)
    assert mm_ops.stream_matmul.wgmma_launches == before + 1
    _close(out, stream_matmul_ref(x, w, out_dtype=odt))
    assert torch.equal(out, mm_ops.stream_matmul(x, w, out_dtype=odt))  # no split-K, no atomics


NK_CASES = [
    # (M, K, N, dtype, route) of x @ w.T for a K-major w (N, K): minicpm-2b's
    # tied head (V = 122753, odd) at the live step, decode, a 64-row product
    # and the decode check's forward (4 x 1088 rows); a ragged K on the gemv
    # and simt routes, f32 on gemv and simt, a ragged N on wgmma
    (1, 2304, 122753, torch.bfloat16, "gemv"),
    (4, 2304, 122753, torch.bfloat16, "gemv"),
    (64, 2304, 122753, torch.bfloat16, "wgmma"),
    (4352, 2304, 122753, torch.bfloat16, "wgmma"),
    (3, 300, 1001, torch.bfloat16, "gemv"),
    (64, 300, 1001, torch.bfloat16, "simt"),
    (5, 2048, 4097, torch.float32, "gemv"),
    (64, 2048, 1001, torch.float32, "simt"),
    (200, 264, 137, torch.bfloat16, "wgmma"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,dt,route", NK_CASES)
@pytest.mark.parametrize("out_dtype", sorted(DTYPES))
def test_stream_matmul_nk_kernel(cuda, m, k, n, dt, route, out_dtype):
    """The K-major form reads w in place: no copy, one launch, counted in
    ``nk_launches`` and, on the tensor-core route, ``wgmma_launches``."""
    x = _randn((m, k), dt, cuda, 0)
    w = _randn((n, k), dt, cuda, 1, scale=k ** -0.5)
    odt = DTYPES[out_dtype]
    assert mm_ops.mm_route(m, n, k, dt, True, "nk") == route
    fn = mm_ops.stream_matmul
    before = (fn.launches, fn.wgmma_launches, fn.nk_launches)
    out = fn(x, w, out_dtype=odt, w_layout="nk")
    assert (fn.launches, fn.wgmma_launches, fn.nk_launches) == (
        before[0] + 1, before[1] + (route == "wgmma"), before[2] + 1)
    assert out.shape == (m, n) and out.dtype == odt
    ref = stream_matmul_ref(x, w, out_dtype=odt, w_layout="nk")
    _close(out, ref)
    assert float((out.float() - ref.float()).norm() / ref.float().norm()) <= 1e-3
    assert torch.equal(out, fn(x, w, out_dtype=odt, w_layout="nk"))  # one launch, no atomics


@pytest.mark.cuda
def test_stream_matmul_nk_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, torch.zeros((64, 10), device=cuda, dtype=torch.bfloat16), w_layout="nk")
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, torch.zeros((10, 128), device=cuda, dtype=torch.bfloat16)[:, ::2], w_layout="nk")
    with pytest.raises(ValueError, match="w_layout"):
        mm_ops.stream_matmul(x, torch.zeros((10, 64), device=cuda, dtype=torch.bfloat16), w_layout="t")


INT8_CASES = [
    # (M, K, N, block_k): the reference's test shapes, the kernel bench's,
    # paper-llama3-8b's projections at decode (M = 1, 4) and one at M = 4096,
    # and ragged sizes: M not a multiple of 128 on the wgmma route, N not a
    # multiple of 16 and block_k of 100 on the simt route
    (64, 128, 64, 64), (128, 256, 128, 64), (256, 512, 256, 128),
    (1, 4096, 4096, 128), (4, 4096, 1024, 128), (4, 14336, 4096, 128),
    (1, 4096, 128256, 128), (3, 96, 1001, 32), (8, 64, 7, 16), (9, 300, 1001, 100),
    (4096, 4096, 1024, 128), (130, 256, 144, 64), (200, 512, 1000, 128),
]


def _int8_inputs(m, k, n, block_k, dt, dev):
    rng = np.random.default_rng(9)
    x = _randn((m, k), dt, dev, 10)
    w_q = torch.from_numpy(rng.integers(-127, 127, (k, n), dtype=np.int8)).to(dev)
    scales = torch.from_numpy(rng.uniform(0.005, 0.02, (k // block_k, n)).astype(np.float32)).to(dev)
    return x, w_q, scales


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,block_k", INT8_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_int8_kernel(cuda, m, k, n, block_k, dtype):
    x, w_q, scales = _int8_inputs(m, k, n, block_k, DTYPES[dtype], cuda)
    route = mm_ops.int8_route(m, n, k, block_k, x.dtype, True)
    before = mm_ops.stream_matmul_int8.launches
    before_wgmma = mm_ops.stream_matmul_int8.wgmma_launches
    out = mm_ops.stream_matmul_int8(x, w_q, scales, block_k)
    assert mm_ops.stream_matmul_int8.launches == before + 1
    assert mm_ops.stream_matmul_int8.wgmma_launches == before_wgmma + (route == "wgmma")
    ref = stream_matmul_int8_ref(x, w_q, scales, block_k)
    _close(out, ref)
    # a dropped or misread scale group moves the output by several % in L2
    assert float((out.float() - ref.float()).norm() / ref.float().norm()) <= 1e-2
    assert torch.equal(out, mm_ops.stream_matmul_int8(x, w_q, scales, block_k))  # no atomics
    f32 = mm_ops.stream_matmul_int8(x, w_q, scales, block_k, out_dtype=torch.float32)
    ref32 = stream_matmul_int8_ref(x, w_q, scales, block_k, out_dtype=torch.float32)
    _close(f32, ref32)
    # every route keeps the products exact: only the order of f32 sums differs
    assert float((f32 - ref32).norm() / ref32.norm()) <= 1e-5


@pytest.mark.cuda
def test_stream_matmul_int8_routes(cuda):
    """The kernel bench's call takes the wgmma route, f32 x and a block_k of
    whole k-tiles short of 64 the simt one, M <= 8 the gemv one."""
    for (m, k, n, block_k, dt), want in (
        ((256, 512, 256, 128, torch.bfloat16), "wgmma"), ((256, 512, 256, 128, torch.float32), "simt"),
        ((256, 512, 256, 32, torch.bfloat16), "simt"), ((4, 512, 256, 128, torch.bfloat16), "gemv"),
    ):
        x, w_q, scales = _int8_inputs(m, k, n, block_k, dt, cuda)
        assert mm_ops.int8_route(m, n, k, block_k, dt, True) == want
        before = mm_ops.stream_matmul_int8.wgmma_launches
        mm_ops.stream_matmul_int8(x, w_q, scales, block_k)
        assert mm_ops.stream_matmul_int8.wgmma_launches == before + (want == "wgmma")


@pytest.mark.cuda
def test_stream_matmul_int8_raises_on_what_the_kernel_does_not_take(cuda):
    x, w_q, scales = _int8_inputs(2, 128, 64, 64, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        mm_ops.stream_matmul_int8(x, w_q, scales.cpu(), 64)  # mixed devices
    with pytest.raises(ValueError):
        mm_ops.stream_matmul_int8(x, w_q, scales, 48)  # K % block_k
    with pytest.raises(ValueError):
        mm_ops.stream_matmul_int8(x, w_q, scales[:1], 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x, w_q.float(), scales, 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x, w_q, scales.double(), 64)
    with pytest.raises(ValueError):
        mm_ops.stream_matmul_int8(x, w_q.t().contiguous().t(), scales, 64)  # not contiguous
    # a misaligned x (a view one element on) leaves the wgmma route for simt
    xs, wq, sc = _int8_inputs(130, 257, 144, 257, torch.bfloat16, cuda)
    x_off = torch.as_strided(xs, (130, 256), (256, 1), storage_offset=1)
    assert mm_ops.int8_route(130, 144, 256, 64, torch.bfloat16, x_off.data_ptr() % 16 == 0) == "simt"
    w2, s2 = wq[:256], sc.new_full((4, 144), 0.01)
    before = mm_ops.stream_matmul_int8.wgmma_launches
    out = mm_ops.stream_matmul_int8(x_off, w2, s2, 64)
    assert mm_ops.stream_matmul_int8.wgmma_launches == before
    _close(out, stream_matmul_int8_ref(x_off, w2, s2, 64))


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


WGMMA_FA_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window): the dense prefill calls of
    # qwen3-1.7b and llama3.2-3b, the decode-vs-forward check's forward of
    # llama3.2-3b (g = 3, a partial last row block), the reference's GQA case
    # and a window that skips tiles, with a partial last KV tile
    (4, 1024, 1024, 16, 8, 128, True, 0),
    (4, 1024, 1024, 24, 8, 128, True, 0),
    (1, 1088, 1088, 24, 8, 128, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 300, 300, 24, 8, 128, True, 100),
    # the new families' prefill calls: qwen2-vl-7b at g = 7 (a 128-row tile
    # straddles positions unevenly), also short and ragged, and minicpm-2b
    # (MHA, D = 64)
    (4, 1024, 1024, 28, 4, 128, True, 0),
    (1, 300, 300, 28, 4, 128, True, 0),
    (4, 1024, 1024, 36, 36, 64, True, 0),
    # examples/port_train_lm.py's call (g = 5: 12 positions and 4 padding
    # rows a 64-row tile)
    (4, 128, 128, 10, 2, 64, True, 0),
]


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", WGMMA_FA_CASES)
def test_flash_attention_wgmma_route(cuda, b, sq, skv, h, hkv, d, causal, window):
    q = _randn((b, sq, h, d), torch.bfloat16, cuda, 2)
    k = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 3)
    v = _randn((b, skv, hkv, d), torch.bfloat16, cuda, 4)
    assert fa_ops.fa_route(b, sq, skv, h, hkv, d, q.dtype) == "wgmma"
    before = fa_ops.flash_attention.wgmma_launches
    out = fa_ops.flash_attention(q, k, v, causal=causal, window=window)
    assert fa_ops.flash_attention.wgmma_launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    _close(out, ref)
    assert float((out.float() - ref.float()).norm() / ref.float().norm()) <= 1e-2
    assert torch.equal(out, fa_ops.flash_attention(q, k, v, causal=causal, window=window))


@pytest.mark.cuda
def test_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.zeros((2, 4), device=cuda)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul(x, torch.zeros((4, 3), device=cuda, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, torch.zeros((4, 6), device=cuda)[:, ::2])
    q = torch.zeros((1, 2, 2, 264), device=cuda)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)  # head dim above 256


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
    wide = _pa_inputs(2, 4, 2, 264, 16, 4, (5, 9), False, torch.bfloat16, cuda)
    with pytest.raises(ValueError):
        pa_ops.paged_attention(*wide)  # head dim above 256


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


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device) for k, v in tree.items()}


@pytest.mark.cuda
def test_minicpm_full_width_card_against_cpu(cuda):
    """minicpm-2b at its published width (tied head over V = 122753), 2
    layers: forward, and prefill of 32 tokens + 4 decode steps, on the card
    against the CPU with the kernels' plain versions (attention in f32, as
    the kernels keep it) from the same weights; decode on the card against
    forward on the card at the reference's decode tolerance (8e-2)."""
    import dataclasses

    import repro_torch.models.layers as layers
    from repro_torch.configs import get_config
    from repro_torch.kernels.streammm.ops import stream_matmul
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("minicpm-2b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(cuda).manual_seed(0))
    assert "lm_head" not in params["head"]
    cpu_params = _tree_to(params, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(12).integers(0, cfg.vocab_size, (2, 36)))
    s, n = 32, 4

    def prefill_decode(p, toks):
        logits, cache = fns.prefill(p, {"tokens": toks[:, :s]}, max_seq=s + n)
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(p, cache, {"tokens": toks[:, s + i : s + i + 1]})
            outs.append(logits)
        return torch.cat(outs, dim=1)

    def plain_attend(q, k, v, *, causal, window=None, **_):
        return attention_ref(q, k, v, causal=causal, window=window or 0)

    with torch.inference_mode():
        before = stream_matmul.nk_launches
        fwd_card = fns.forward(params, {"tokens": tokens.to(cuda)})
        dec_card = prefill_decode(params, tokens.to(cuda))
        assert stream_matmul.nk_launches == before + 1 + 1 + n  # the tied head, once a call
        saved, layers.attend = layers.attend, plain_attend
        try:
            fwd_cpu = fns.forward(cpu_params, {"tokens": tokens})
            dec_cpu = prefill_decode(cpu_params, tokens)
        finally:
            layers.attend = saved
    assert torch.isfinite(fwd_card.float()).all() and fwd_card.shape == (2, 36, cfg.vocab_size)
    _close(fwd_card.cpu(), fwd_cpu)
    _close(dec_card.cpu(), dec_cpu)
    torch.testing.assert_close(dec_card.float(), fwd_card[:, s - 1 :].float(), rtol=8e-2, atol=8e-2)


@pytest.mark.cuda
def test_vlm_positions_that_are_not_an_index_raise_on_the_card(cuda):
    """The flash kernel masks by index, so on the card a VLM batch whose
    temporal positions are not 0..S-1 raises (the CPU masks by them)."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.specs import make_concrete_batch
    from repro_torch.models.model import build_model

    cfg = get_config("qwen2-vl-7b").reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator(cuda).manual_seed(0))
    batch = make_concrete_batch(cfg, ShapeSpec("p", 64, 2, "prefill"), device=cuda)
    with torch.inference_mode():
        logits = fns.forward(params, batch)
        assert torch.isfinite(logits.float()).all()
        batch["positions3"][0, 1, 8:] += 3
        with pytest.raises(ValueError, match="temporal positions"):
            fns.forward(params, batch)
        with pytest.raises(ValueError, match="temporal positions"):
            fns.prefill(params, batch, max_seq=80)


@pytest.mark.cuda
def test_mamba2_full_width_card_against_cpu(cuda):
    """mamba2-1.3b at its published width, 2 layers: forward, and prefill of
    32 tokens + 4 decode steps, on the card (stream_matmul kernel) against the
    CPU (its plain version) from the same weights; decode on the card against
    forward on the card at the reference's decode tolerance (8e-2)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("mamba2-1.3b"), num_layers=2)
    fns = build_model(cfg)
    params = fns.init(torch.Generator(cuda).manual_seed(0))
    cpu_params = _tree_to(params, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(11).integers(0, cfg.vocab_size, (2, 36)))
    s, n = 32, 4

    def prefill_decode(p, toks):
        logits, cache = fns.prefill(p, {"tokens": toks[:, :s]})
        outs = [logits]
        for i in range(n):
            logits, cache = fns.decode_step(p, cache, {"tokens": toks[:, s + i : s + i + 1]})
            outs.append(logits)
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        fwd_card = fns.forward(params, {"tokens": tokens.to(cuda)})
        dec_card = prefill_decode(params, tokens.to(cuda))
        fwd_cpu = fns.forward(cpu_params, {"tokens": tokens})
        dec_cpu = prefill_decode(cpu_params, tokens)
    assert torch.isfinite(fwd_card.float()).all() and fwd_card.shape == (2, 36, cfg.vocab_size)
    _close(fwd_card.cpu(), fwd_cpu)
    _close(dec_card.cpu(), dec_cpu)
    torch.testing.assert_close(dec_card.float(), fwd_card[:, s - 1 :].float(), rtol=8e-2, atol=8e-2)



# -- the expert-batched stream_matmul and the MoE layer ----------------------------

BATCHED_CASES = [
    # (E, C, K, N, dtype, route): the decode and live step's capacity of 2
    # (gemv; N = 1024 still splits K across 8 experts), grok's shape at
    # prefill cut in K and N (C = 1280, wgmma), arctic's prefill capacity of
    # 80 over 16 experts (wgmma), a ragged C, K and N on wgmma, f32 on simt
    # and gemv, and a K that TMA cannot describe (simt in bf16)
    (8, 2, 1024, 4096, torch.bfloat16, "gemv"),
    (8, 2, 2048, 1024, torch.bfloat16, "gemv"),
    (2, 1280, 512, 1024, torch.bfloat16, "wgmma"),
    (16, 80, 512, 768, torch.bfloat16, "wgmma"),
    (3, 200, 264, 136, torch.bfloat16, "wgmma"),
    (4, 80, 300, 200, torch.float32, "simt"),
    (4, 3, 96, 100, torch.float32, "gemv"),
    (3, 20, 30, 50, torch.bfloat16, "simt"),
]


def _batched_rows(e, c, case):
    """Each expert's filled rows: all of them (None), or empty, partial and
    full experts in turn, one count past the capacity (clamped to it)."""
    if case == "none":
        return None
    counts = [(0, c // 3 + 1, c, c + 5)[i % 4] for i in range(e)]
    return counts


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n,dt,route", BATCHED_CASES)
@pytest.mark.parametrize("rows_case", ["none", "mixed"])
def test_stream_matmul_batched_kernel(cuda, e, c, k, n, dt, route, rows_case):
    """One launch over every expert, on the route of each expert's shape,
    counted in ``batched_launches``; rows past an expert's count come out
    exactly 0 whatever x holds there (NaN here); the same bits on a second
    call."""
    x = _randn((e, c, k), dt, cuda, 20)
    w = _randn((e, k, n), dt, cuda, 21, scale=k ** -0.5)
    counts = _batched_rows(e, c, rows_case)
    rows = None
    if counts is not None:
        rows = torch.tensor(counts, dtype=torch.int32, device=cuda)
        for i, r in enumerate(counts):
            x[i, min(r, c):] = float("nan")
    assert mm_ops.mm_route(c, n, k, dt, True) == route
    fn = mm_ops.stream_matmul
    before = (fn.launches, fn.wgmma_launches, fn.batched_launches)
    out = fn(x, w, out_dtype=dt, rows=rows)
    assert (fn.launches, fn.wgmma_launches, fn.batched_launches) == (
        before[0] + 1, before[1] + (route == "wgmma"), before[2] + 1)
    assert out.shape == (e, c, n) and out.dtype == dt
    ref = stream_matmul_ref(x, w, out_dtype=dt, rows=rows)
    _close(out, ref)
    live = torch.ones((e, c), dtype=torch.bool, device=cuda) if counts is None else (
        torch.arange(c, device=cuda) < rows[:, None].long())
    assert not out[~live].any() and torch.isfinite(out.float()).all()
    rel = float((out.float() - ref.float()).norm() / ref.float().norm())
    assert rel <= 1e-2
    assert torch.equal(out, fn(x, w, out_dtype=dt, rows=rows))


@pytest.mark.cuda
def test_stream_matmul_batched_empty_experts_read_no_weight(cuda):
    """An expert with no rows reads none of its weight: NaN weights there
    reach nothing, and every output of it is 0."""
    for c in (2, 80):
        x = _randn((4, c, 256), torch.bfloat16, cuda, 22)
        w = _randn((4, 256, 512), torch.bfloat16, cuda, 23, scale=1 / 16)
        w[1] = float("nan")
        w[3] = float("nan")
        rows = torch.tensor([c, 0, 1, 0], dtype=torch.int32, device=cuda)
        out = mm_ops.stream_matmul(x, w, rows=rows)
        assert torch.isfinite(out.float()).all() and not out[1].any() and not out[3].any() and not out[2, 1:].any()
        _close(out[0], stream_matmul_ref(x[0], w[0]))


@pytest.mark.cuda
def test_stream_matmul_batched_raises_on_what_the_kernel_does_not_take(cuda):
    x = torch.zeros((4, 3, 64), device=cuda, dtype=torch.bfloat16)
    w = torch.zeros((4, 64, 32), device=cuda, dtype=torch.bfloat16)
    rows = torch.zeros(4, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):  # mismatched experts
        mm_ops.stream_matmul(x, w[:3])
    with pytest.raises(ValueError):  # a non-contiguous expert slice
        mm_ops.stream_matmul(x, torch.zeros((8, 64, 32), device=cuda, dtype=torch.bfloat16)[::2])
    with pytest.raises(ValueError):  # rows on the host
        mm_ops.stream_matmul(x, w, rows=rows.cpu())
    with pytest.raises(TypeError):  # rows of another dtype
        mm_ops.stream_matmul(x, w, rows=rows.long())
    with pytest.raises(ValueError):  # x on the host
        mm_ops.stream_matmul(x.cpu(), w)


def _moe_cfg(dtype, d=1024, experts=8, d_ff=2048, dense_residual=False):
    import dataclasses

    from repro_torch.configs import get_config

    cfg = get_config("grok-1-314b")
    moe = dataclasses.replace(cfg.moe, num_experts=experts, d_ff=d_ff, dense_residual=dense_residual,
                              dense_d_ff=d_ff if dense_residual else 0)
    return dataclasses.replace(cfg, d_model=d, dtype=dtype, moe=moe)


@pytest.mark.cuda
@pytest.mark.parametrize("dense_residual", [False, True])
@pytest.mark.parametrize("n_tokens", [4, 256])
def test_moe_apply_card_against_cpu_f32(cuda, dense_residual, n_tokens):
    """The MoE layer in f32 on the card (router and experts through the
    kernel: gemv at a decode's 4 tokens, simt at 256) against its CPU run:
    the same routing, outputs within 1e-4 (f32 sums in another order)."""
    from repro_torch.models import layers

    cfg = _moe_cfg("float32", dense_residual=dense_residual)
    p = layers.init_moe(torch.Generator(cuda).manual_seed(0), cfg)
    x = _randn((2, n_tokens // 2, cfg.d_model), torch.float32, cuda, 24)
    before = mm_ops.stream_matmul.batched_launches
    with torch.inference_mode():
        out, logits = layers.moe_apply(p, x, cfg)
        out_cpu, logits_cpu = layers.moe_apply(_tree_to(p, "cpu"), x.cpu(), cfg)
    assert mm_ops.stream_matmul.batched_launches == before + 3
    assert torch.equal(layers.moe_dispatch(logits.cpu(), cfg.moe).idx, layers.moe_dispatch(logits_cpu, cfg.moe).idx)
    torch.testing.assert_close(out.cpu(), out_cpu, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_moe_apply_has_no_host_sync(cuda):
    """The layer waits for the device nowhere: under CUDA's sync debug mode
    set to "error" a synchronising call raises."""
    from repro_torch.models import layers

    cfg = _moe_cfg("bfloat16", dense_residual=True)
    p = layers.init_moe(torch.Generator(cuda).manual_seed(1), cfg)
    x = _randn((4, 64, cfg.d_model), torch.bfloat16, cuda, 25)
    with torch.inference_mode():
        layers.moe_apply(p, x, cfg)  # builds the kernels first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out, _ = layers.moe_apply(p, x, cfg)
            out_step, _ = layers.moe_apply(p, x[:, :1].contiguous(), cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.float()).all() and torch.isfinite(out_step.float()).all()


@pytest.mark.cuda
def test_hybrid_ring_decode_card_against_cpu(cuda):
    """recurrentgemma-9b reduced to 5 layers (one (rec, rec, attn) group and
    two trailing recurrent layers) in f32: prefill of 64 tokens (the ring of
    16 slots wraps) and 4 decode steps on the card against the CPU from the
    same weights, at 1e-4 (the same f32 function, sums in another order);
    then the same steps in bf16 with CUDA's sync debug mode set to "error":
    the ring's write slot and lengths stay on the device."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model

    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(), num_layers=5, dtype="float32")
    fns = build_model(cfg)
    params = fns.init(torch.Generator(cuda).manual_seed(3))
    tokens = torch.from_numpy(np.random.default_rng(13).integers(1, cfg.vocab_size, (2, 68)))

    def prefill_decode(fns, p, toks):
        logits, cache = fns.prefill(p, {"tokens": toks[:, :64]})
        outs = [logits]
        for i in range(4):
            logits, cache = fns.decode_step(p, cache, {"tokens": toks[:, 64 + i : 65 + i]})
            outs.append(logits)
        assert cache["k"].shape[2] == cfg.rglru.window and cache["host_index"] == 68
        return torch.cat(outs, dim=1)

    with torch.inference_mode():
        card = prefill_decode(fns, params, tokens.to(cuda))
        cpu = prefill_decode(fns, _tree_to(params, "cpu"), tokens)
        torch.testing.assert_close(card.cpu(), cpu, rtol=1e-4, atol=1e-4)
        cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
        fns16 = build_model(cfg16)
        p16 = fns16.init(torch.Generator(cuda).manual_seed(3))
        tokens = tokens.to(cuda)
        prefill_decode(fns16, p16, tokens)  # builds the kernels first
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = prefill_decode(fns16, p16, tokens)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(out.float()).all()


# The flash backward (csrc/flash_attention_bwd.cu): head dims 64 / 80 / 128 /
# 256, causal, windowed and bidirectional, g = 1 and g > 1, Sq > Skv, ragged
# sizes. f32 gradients: the same function with sums in another order (~1e-6);
# bf16 inputs against the f32 gradient of the same inputs: bf16 rounding of
# the inputs, the forward's output and the gradients (~2e-3 measured).
FA_BWD_CASES = [
    (2, 256, 256, 8, 2, 64, True, 0),
    (1, 128, 128, 4, 4, 64, True, 0),
    (2, 100, 100, 16, 16, 80, False, 0),
    (2, 130, 130, 16, 4, 80, True, 0),
    (1, 300, 300, 16, 8, 128, True, 0),
    (1, 300, 300, 16, 8, 128, True, 100),
    (1, 1, 1, 16, 8, 128, True, 0),
    (2, 96, 96, 16, 1, 256, True, 16),
    (1, 200, 200, 16, 1, 256, True, 64),
    (1, 70, 40, 4, 2, 64, True, 16),
    (1, 65, 65, 4, 2, 200, False, 0),
]
FA_BWD_REL_L2 = {"float32": 1e-4, "bfloat16": 2e-2}


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", FA_BWD_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_flash_attention_backward_kernel(cuda, b, sq, skv, h, hkv, d, causal, window, dtype):
    from repro_torch.kernels.flash_attention.ref import attention_ref_backward

    dt = DTYPES[dtype]
    q, do = (_randn((b, sq, h, d), dt, cuda, seed) for seed in (31, 32))
    k, v = (_randn((b, skv, hkv, d), dt, cuda, seed) for seed in (33, 34))
    kw = dict(causal=causal, window=window)
    with torch.no_grad():
        o = fa_ops.flash_attention(q, k, v, **kw)
    before = fa_ops.flash_attention.bwd_launches
    grads = fa_ops.flash_attention_backward(q, k, v, o, do, **kw)
    assert fa_ops.flash_attention.bwd_launches == before + 1
    want = attention_ref_backward(q.float(), k.float(), v.float(), do.float(), **kw)
    again = fa_ops.flash_attention_backward(q, k, v, o, do, **kw)
    for name, g, w, g2 in zip("qkv", grads, want, again):
        assert g.dtype == dt and g.shape == w.shape
        if w.norm() == 0:  # one key a row (Sq = Skv = 1): P = 1, so dS = dP - delta = 0 and dQ = dK = 0
            assert float(g.float().abs().max()) <= 1e-5, f"d{name}: {float(g.float().abs().max()):.3e}"
        else:
            assert _rel_l2(g, w) <= FA_BWD_REL_L2[dtype], f"d{name}: {_rel_l2(g, w):.3e}"
        assert torch.equal(g, g2), f"d{name} is not deterministic"


# The backward's tensor-core route (fa_bwd_route: bf16, D 64 / 128, Sq <=
# Skv, Sq x g >= 64): g = 1, 2, 4 and 8, and 3, 6 and 7 (llama3.2-3b, grok-1-314b,
# arctic-480b and qwen2-vl-7b), whose 64-row tiles of 64 // g positions keep
# padding rows; causal, windowed and bidirectional;
# Sq = Skv not a multiple of 64, and Sq < Skv. bf16 gradients against the
# f32 plain version (P and dS rounded to bf16 as product operands, ~2e-3).
WGMMA_BWD_SIZES = [(1, 77, 77), (2, 1000, 1000), (1, 200, 333)]  # (B, Sq, Skv)
WGMMA_BWD_MASKS = {"causal": (True, 0), "window": (True, 48), "bidirectional": (False, 0)}


@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv", WGMMA_BWD_SIZES)
@pytest.mark.parametrize("mask", sorted(WGMMA_BWD_MASKS))
@pytest.mark.parametrize("g", [1, 2, 3, 4, 5, 6, 7, 8])
@pytest.mark.parametrize("d", [64, 128])
def test_flash_attention_backward_wgmma_route(cuda, b, sq, skv, mask, g, d):
    from repro_torch.kernels.flash_attention.ref import attention_ref_backward

    causal, window = WGMMA_BWD_MASKS[mask]
    hkv = 2
    h = g * hkv
    q, do = (_randn((b, sq, h, d), torch.bfloat16, cuda, seed) for seed in (51, 52))
    k, v = (_randn((b, skv, hkv, d), torch.bfloat16, cuda, seed) for seed in (53, 54))
    kw = dict(causal=causal, window=window)
    assert fa_ops.fa_bwd_route(b, sq, skv, h, hkv, d, torch.bfloat16) == "wgmma"
    with torch.no_grad():
        o = fa_ops.flash_attention(q, k, v, **kw)
    before, wgmma = fa_ops.flash_attention.bwd_launches, fa_ops.flash_attention.bwd_wgmma_launches
    grads = fa_ops.flash_attention_backward(q, k, v, o, do, **kw)
    assert (fa_ops.flash_attention.bwd_launches, fa_ops.flash_attention.bwd_wgmma_launches) == (before + 1, wgmma + 1)
    want = attention_ref_backward(q.float(), k.float(), v.float(), do.float(), **kw)
    again = fa_ops.flash_attention_backward(q, k, v, o, do, **kw)
    for name, gr, w, g2 in zip("qkv", grads, want, again):
        assert gr.dtype == torch.bfloat16 and gr.shape == w.shape
        assert _rel_l2(gr, w) <= FA_BWD_REL_L2["bfloat16"], f"d{name}: {_rel_l2(gr, w):.3e}"
        assert torch.equal(gr, g2), f"d{name} is not deterministic"


# The forward's statistics (lse2, (B, H, Sq), log2 units): written only when
# asked, O unchanged by them, within 1e-5 of log2(e) x logsumexp of the plain
# scores (f32 sums in another order and ex2.approx; a wrong row or tile is
# off by order 1), and the backward's bits the same with them as without.
@pytest.mark.cuda
@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", [
    (4, 1024, 1024, 16, 8, 128, True, 0),
    (2, 300, 300, 8, 8, 64, True, 100),
    (1, 77, 200, 16, 2, 128, False, 0),
    (1, 333, 333, 28, 4, 128, True, 0),
])
def test_flash_attention_forward_statistics(cuda, b, sq, skv, h, hkv, d, causal, window):
    from repro_torch.kernels.flash_attention.ref import attention_ref_lse

    q, do = (_randn((b, sq, h, d), torch.bfloat16, cuda, seed) for seed in (61, 62))
    k, v = (_randn((b, skv, hkv, d), torch.bfloat16, cuda, seed) for seed in (63, 64))
    kw = dict(causal=causal, window=window)
    scale = 1.0 / d ** 0.5
    lse = torch.full((b, h, sq), float("nan"), dtype=torch.float32, device=cuda)
    o = fa_ops._forward(q, k, v, causal, window, scale)
    o_lse = fa_ops._forward(q, k, v, causal, window, scale, lse)
    assert torch.equal(o, o_lse)
    want = attention_ref_lse(q, k, **kw)
    assert float((lse - want).abs().max()) <= 1e-5, float((lse - want).abs().max())
    with_lse = fa_ops.flash_attention_backward(q, k, v, o, do, lse=lse, **kw)
    without = fa_ops.flash_attention_backward(q, k, v, o, do, **kw)
    for name, a, c in zip("qkv", with_lse, without):
        assert torch.equal(a, c), f"d{name} differs with the forward's statistics"
    # under autograd the forward writes them and the backward reads them
    qg, kg, vg = (t.clone().requires_grad_() for t in (q, k, v))
    out = fa_ops.flash_attention(qg, kg, vg, **kw)
    assert torch.equal(out.detach(), o)
    for name, a, c in zip("qkv", torch.autograd.grad(out, (qg, kg, vg), do), without):
        assert torch.equal(a, c), f"d{name} under autograd"


@pytest.mark.cuda
def test_flash_attention_autograd_on_the_card(cuda):
    """Under grad the wrapper's result has a grad_fn whose backward is the
    kernel; without grad the call is the plain forward launch."""
    q = _randn((2, 128, 8, 64), torch.bfloat16, cuda, 41).requires_grad_()
    k, v = (_randn((2, 128, 2, 64), torch.bfloat16, cuda, s).requires_grad_() for s in (42, 43))
    do = _randn((2, 128, 8, 64), torch.bfloat16, cuda, 44)
    launches, bwd = fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches
    out = fa_ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is not None
    got = torch.autograd.grad(out, (q, k, v), do)
    assert (fa_ops.flash_attention.launches, fa_ops.flash_attention.bwd_launches) == (launches + 1, bwd + 1)
    want = fa_ops.flash_attention_backward(q.detach(), k.detach(), v.detach(), out.detach(), do, causal=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        plain = fa_ops.flash_attention(q, k, v, causal=True)
    assert plain.grad_fn is None and torch.equal(plain, out.detach())
    assert fa_ops.flash_attention.bwd_launches == bwd + 2


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n,layout,dtype", [
    (256, 512, 1024, "kn", "bfloat16"), (4, 512, 1024, "kn", "bfloat16"), (130, 264, 136, "kn", "float32"),
    (256, 2304, 1000, "nk", "bfloat16"), (64, 300, 1001, "nk", "float32"), (64, 256, 1001, "nk", "bfloat16"),
])
def test_stream_matmul_gradients_on_the_card(cuda, m, k, n, layout, dtype):
    dt = DTYPES[dtype]
    x = _randn((m, k), dt, cuda, 51).requires_grad_()
    w = _randn((k, n) if layout == "kn" else (n, k), dt, cuda, 52, scale=k ** -0.5).requires_grad_()
    dy = _randn((m, n), dt, cuda, 53)
    before = mm_ops.stream_matmul.launches
    y = mm_ops.stream_matmul(x, w, out_dtype=dt, w_layout=layout)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    assert mm_ops.stream_matmul.launches == before + 3  # forward, dX, dW
    xf, wf, dyf = x.detach().float(), w.detach().float(), dy.float()
    want_x = dyf @ (wf.T if layout == "kn" else wf)
    want_w = xf.T @ dyf if layout == "kn" else dyf.T @ xf
    tol = 1e-5 if dt == torch.float32 else 1e-2  # f32 stays exact f32; bf16 rounds the gradient once
    assert gx.dtype == gw.dtype == dt
    assert _rel_l2(gx, want_x) <= tol and _rel_l2(gw, want_w) <= tol
    with torch.no_grad():
        plain = mm_ops.stream_matmul(x, w, out_dtype=dt, w_layout=layout)
    assert plain.grad_fn is None and torch.equal(plain, y.detach())


# The expert-batched form's gradients, one launch each over the experts: dX
# = dY @ W^T (the K-major form over the stack, rows past rows[e] written as
# 0) and dW = X^T @ dY over the filled slots only (x read in place as an
# MN-major operand). (E, C, K, N, dtype, dX route, dW route): a capacity of
# 2 (dX on the K-major gemv, dW's C = 2 on simt), arctic's capacity of 80
# over 16 experts and grok's 1280 over 2, cut in K and N (wgmma, several
# k-stages), ragged C, K and N on wgmma, a C no multiple of 8 (dW on simt),
# f32 on simt and on the gemv, and shapes TMA cannot describe (simt in bf16).
BATCHED_GRAD_CASES = [
    (8, 2, 1024, 768, torch.bfloat16, "gemv", "simt"),
    (16, 80, 512, 768, torch.bfloat16, "wgmma", "wgmma"),
    (2, 1280, 512, 1024, torch.bfloat16, "wgmma", "wgmma"),
    (3, 200, 264, 136, torch.bfloat16, "wgmma", "wgmma"),
    (4, 60, 128, 256, torch.bfloat16, "wgmma", "simt"),
    (4, 80, 300, 200, torch.float32, "simt", "simt"),
    (4, 3, 96, 100, torch.float32, "gemv", "simt"),
    (3, 20, 30, 50, torch.bfloat16, "simt", "simt"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("e,c,k,n,dt,dx_route,dw_route", BATCHED_GRAD_CASES)
@pytest.mark.parametrize("rows_case", ["none", "mixed"])
def test_stream_matmul_batched_gradients_on_the_card(cuda, e, c, k, n, dt, dx_route, dw_route, rows_case):
    """Against f32 products of the same operands (bf16: relative L2 1e-2,
    one rounding of each gradient; f32: 1e-5, exact f32 in another order);
    x and dY hold NaN past each expert's count, which must reach nothing:
    dX's rows there and an empty expert's dW are exactly 0. Launches and
    routes counted; the same bits on a second backward."""
    from repro_torch.kernels.streammm.ref import stream_matmul_batched_grads_ref

    x = _randn((e, c, k), dt, cuda, 70)
    w = _randn((e, k, n), dt, cuda, 71, scale=k ** -0.5)
    dy = _randn((e, c, n), dt, cuda, 72)
    counts = _batched_rows(e, c, rows_case)
    rows = None
    if counts is not None:
        rows = torch.tensor(counts, dtype=torch.int32, device=cuda)
        for i, r in enumerate(counts):
            x[i, min(r, c):] = float("nan")
            dy[i, min(r, c):] = float("nan")
    assert mm_ops.mm_route(c, k, n, dt, True, "nk") == dx_route
    assert mm_ops.mm_route(k, n, c, dt, True, "kn", "km") == dw_route
    fn = mm_ops.stream_matmul
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    before = (fn.launches, fn.wgmma_launches, fn.batched_launches, fn.batched_grad_launches)
    y = fn(xg, wg, out_dtype=dt, rows=rows)
    assert y.grad_fn is not None
    gx, gw = torch.autograd.grad(y, (xg, wg), dy)
    wgmma = (mm_ops.mm_route(c, n, k, dt, True) == "wgmma") + (dx_route == "wgmma") + (dw_route == "wgmma")
    assert (fn.launches, fn.wgmma_launches, fn.batched_launches, fn.batched_grad_launches) == (
        before[0] + 3, before[1] + wgmma, before[2] + 1, before[3] + 2)
    assert gx.dtype == gw.dtype == dt and gx.shape == x.shape and gw.shape == w.shape
    want_x, want_w = stream_matmul_batched_grads_ref(x.float(), w.float(), dy.float(), rows)
    tol = 1e-5 if dt == torch.float32 else 1e-2
    assert torch.isfinite(gx.float()).all() and torch.isfinite(gw.float()).all()
    assert _rel_l2(gx, want_x) <= tol and _rel_l2(gw, want_w) <= tol
    if counts is not None:
        for i, r in enumerate(counts):
            assert not gx[i, min(r, c):].any()
            if r == 0:
                assert not gw[i].any()
    again = torch.autograd.grad(fn(xg, wg, out_dtype=dt, rows=rows), (xg, wg), dy)
    assert torch.equal(gx, again[0]) and torch.equal(gw, again[1])


@pytest.mark.cuda
def test_stream_matmul_batched_has_a_backward_under_grad(cuda):
    """Under grad the expert-batched form's result has a grad_fn (it raised
    before its gradients were written); without grad it is the plain launch,
    the same bits."""
    x = _randn((2, 16, 64), torch.bfloat16, cuda, 61).requires_grad_()
    w = _randn((2, 64, 32), torch.bfloat16, cuda, 62)
    y = mm_ops.stream_matmul(x, w)
    assert y.grad_fn is not None and y.shape == (2, 16, 32)
    with torch.no_grad():
        plain = mm_ops.stream_matmul(x, w)
    assert plain.grad_fn is None and torch.equal(plain, y.detach())


@pytest.mark.cuda
def test_wrappers_without_a_backward_raise_under_grad(cuda):
    xq = _randn((4, 128), torch.bfloat16, cuda, 63).requires_grad_()
    w_q = torch.ones((128, 64), dtype=torch.int8, device=cuda)
    scales = torch.ones((2, 64), dtype=torch.float32, device=cuda)
    with pytest.raises(RuntimeError, match="stream_matmul_int8 has no backward"):
        mm_ops.stream_matmul_int8(xq, w_q, scales, 64)
    q = _randn((2, 4, 32), torch.bfloat16, cuda, 64).requires_grad_()
    pool = _randn((4, 16, 2, 32), torch.bfloat16, cuda, 65)
    table = torch.arange(4, dtype=torch.int32, device=cuda).reshape(2, 2)
    lengths = torch.tensor([5, 20], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="paged_attention has no backward"):
        pa_ops.paged_attention(q, pool, pool, table, lengths)


@pytest.mark.cuda
@pytest.mark.parametrize("arch,micro", [("qwen3-1.7b", 0), ("qwen3-1.7b", 2), ("minicpm-2b", 0),
                                        ("recurrentgemma-9b", 0), ("grok-1-314b", 0), ("arctic-480b", 0)])
def test_train_steps_card_against_cpu(cuda, arch, micro):
    """Reduced configs in f32, remat on: two train steps on the card (the
    kernels forward and backward) against the same steps on the CPU (the
    plain versions), metrics and params within 1e-4."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import pipeline_for
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.steps import make_train_state, make_train_step
    from repro_torch.tree import flatten, tree_map

    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="float32", remat=True)
    state_cpu = make_train_state(cfg, torch.Generator().manual_seed(0))
    state = tree_map(lambda t: t.to(cuda), state_cpu)
    step = make_train_step(cfg, peak_lr=1e-3, warmup=1, total_steps=10, microbatches=micro)
    pipe = pipeline_for(cfg, ShapeSpec("train", 64, 4, "train"), seed=1)
    bwd = fa_ops.flash_attention.bwd_launches
    for i in range(2):
        batch = {k: torch.from_numpy(v) for k, v in pipe.batch(i).items()}
        state, metrics = step(state, {k: v.to(cuda) for k, v in batch.items()})
        state_cpu, metrics_cpu = step(state_cpu, batch)
        for key in metrics:
            torch.testing.assert_close(metrics[key].cpu(), metrics_cpu[key], rtol=1e-4, atol=1e-4)
    assert fa_ops.flash_attention.bwd_launches > bwd
    for (path, a), (_, b) in zip(flatten(state), flatten(state_cpu)):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-4, msg=path)


@pytest.mark.cuda
def test_train_step_has_no_host_sync(cuda):
    """A bf16 train step with remat waits for the device nowhere: under
    CUDA's sync debug mode set to "error" a synchronising call raises."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import make_train_state, make_train_step

    cfg = get_config("qwen3-1.7b").reduced()
    state = make_train_state(cfg, torch.Generator(cuda).manual_seed(0))
    step = make_train_step(cfg, warmup=1)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (2, 64), device=cuda)}
    batch["labels"] = torch.roll(batch["tokens"], -1, dims=1)
    state, _ = step(state, batch)  # builds the kernels first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state, metrics = step(state, batch)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(metrics["loss"]).all()


@pytest.mark.cuda
def test_one_rank_nccl_mesh_step_equals_the_meshless_step(cuda, tmp_path):
    """A one-rank NCCL group (a FileStore, no network) under a 1 x 1 mesh: the
    reduced qwen3-1.7b (bf16) through ``TrainSupervisor`` with the state
    placed as DTensors gives the meshless run's losses bit for bit, and a
    checkpoint written under the mesh restores without one, and the other
    way round, to the same bits."""
    import torch.distributed as dist

    from repro_torch.checkpointing.checkpoint import restore
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch.mesh import init_ranks, make_mesh
    from repro_torch.launch.steps import abstract_train_state, make_train_state
    from repro_torch.runtime.train_loop import TrainSupervisor
    from repro_torch.sharding.specs import gather, place, state_shardings
    from repro_torch.tree import flatten

    cfg = get_config("qwen3-1.7b").reduced()
    shape = ShapeSpec("t", 64, 4, "train")
    base = TrainSupervisor(cfg, shape, str(tmp_path / "plain"), ckpt_every=2, device=cuda).run(4)
    init_ranks(0, 1, str(tmp_path / "store"), cuda)
    try:
        mesh = make_mesh((1, 1), ("data", "model"), cuda)
        shardings = state_shardings(cfg, abstract_train_state(cfg), mesh)
        meshed = TrainSupervisor(cfg, shape, str(tmp_path / "mesh"), mesh=mesh, shardings=shardings,
                                 ckpt_every=2, device=cuda).run(4)
        fresh = make_train_state(cfg, torch.Generator(cuda).manual_seed(1))
        into_mesh = restore(str(tmp_path / "plain"), 4, place(fresh, shardings))
        from_mesh = restore(str(tmp_path / "mesh"), 4, make_train_state(cfg, torch.Generator(cuda).manual_seed(2)))
        plain = restore(str(tmp_path / "plain"), 4, make_train_state(cfg, torch.Generator(cuda).manual_seed(3)))
        for (path, a), (_, b), (_, c) in zip(flatten(plain), flatten(from_mesh), flatten(into_mesh)):
            assert torch.equal(a, b) and torch.equal(a, gather(c)), path
    finally:
        dist.destroy_process_group()
    assert meshed.losses == base.losses and len(base.losses) == 4


@pytest.mark.cuda
def test_port_train_lm_restart_is_bit_equal(cuda, tmp_path):
    """``examples/port_train_lm.py`` at its published config, 20 steps with
    checkpoints every 5: a failure at step 12 restarts from step 10 and
    gives the uninterrupted run's losses bit for bit."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "port_train_lm.py"
    spec = importlib.util.spec_from_file_location("port_train_lm", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    base, _ = example.run(20, None, str(tmp_path / "base"), 5, cuda)
    killed, _ = example.run(20, 12, str(tmp_path / "killed"), 5, cuda)
    assert killed.restarts == 1 and len(killed.losses) == 12 + 10
    assert killed.losses[12:] == base.losses[10:]
