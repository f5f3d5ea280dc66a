"""The port's kernels against the JAX package's: each plain PyTorch version
(``ref.py``) against the Pallas kernel in interpret mode, on the same numpy
inputs, and the wrappers' CPU dispatch. Tolerance: rtol = atol = 5e-2, the
reference's own (tests/kernels/test_kernels.py), since bf16 rounds at other
places in the two frameworks. The CUDA kernels themselves are held against
these plain versions on the card by ``test_torch_cuda.py``."""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.streammm.kernel import stream_matmul as jax_stream_matmul  # noqa: E402
from repro.kernels.streammm.ref import stream_matmul_ref as jax_stream_matmul_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_ref  # noqa: E402

RTOL = ATOL = 5e-2
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}


def _close(a, b):
    np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)


def _np(a):
    if isinstance(a, torch.Tensor):
        return a.float().cpu().numpy()
    return np.asarray(a, np.float32)


def _pair(arr, dtype):
    """The same values as a JAX array and a torch tensor of one dtype."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(arr).astype(jd), torch.from_numpy(arr).to(td)


# -- streammm -----------------------------------------------------------------

MM_SHAPES = [(64, 64, 64), (128, 256, 192), (256, 128, 128), (64, 512, 64)]
RAGGED_M1 = [(1, 128, 300), (1, 64, 1000), (1, 96, 257), (1, 200, 8)]


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_ref_matches_pallas(m, k, n, dtype):
    rng = np.random.default_rng(0)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    out = jax_stream_matmul(
        xj, wj, block_m=64, block_n=64, block_k=64, out_dtype=DTYPES[dtype][0],
        interpret=True,
    )
    _close(stream_matmul_ref(xt, wt, out_dtype=DTYPES[dtype][1]), out)


@pytest.mark.parametrize("m,k,n", RAGGED_M1)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_ref_ragged_gemv(m, k, n, dtype):
    rng = np.random.default_rng(1)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((k, n), np.float32), dtype)
    ref = jax_stream_matmul_ref(xj, wj, out_dtype=DTYPES[dtype][0])
    _close(stream_matmul_ref(xt, wt, out_dtype=DTYPES[dtype][1]), ref)


NK_SHAPES = [(64, 64, 64), (128, 256, 192), (1, 128, 300), (4, 96, 257), (9, 72, 1001)]


@pytest.mark.parametrize("m,k,n", NK_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_ref_nk_matches_einsum(m, k, n, dtype):
    """The K-major form is the reference's tied head, einsum("bsd,vd->bsv")."""
    rng = np.random.default_rng(12)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((n, k), np.float32), dtype)
    ref = jnp.einsum("md,nd->mn", xj, wj, preferred_element_type=jnp.float32).astype(DTYPES[dtype][0])
    _close(stream_matmul_ref(xt, wt, out_dtype=DTYPES[dtype][1], w_layout="nk"), ref)


@pytest.mark.parametrize("m,k,n", MM_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_stream_matmul_ref_nk_matches_pallas_on_the_transposed_weight(m, k, n, dtype):
    rng = np.random.default_rng(13)
    xj, xt = _pair(rng.standard_normal((m, k), np.float32), dtype)
    wj, wt = _pair(rng.standard_normal((n, k), np.float32), dtype)
    out = jax_stream_matmul(
        xj, wj.T, block_m=64, block_n=64, block_k=64, out_dtype=DTYPES[dtype][0], interpret=True,
    )
    _close(stream_matmul_ref(xt, wt, out_dtype=DTYPES[dtype][1], w_layout="nk"), out)


def test_stream_matmul_nk_cpu_dispatch_takes_plain_path():
    rng = np.random.default_rng(14)
    x = torch.from_numpy(rng.standard_normal((4, 96), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((257, 96), np.float32)).bfloat16()
    before = (mm_ops.stream_matmul.launches, mm_ops.stream_matmul.nk_launches)
    out = mm_ops.stream_matmul(x, w, w_layout="nk")
    assert (mm_ops.stream_matmul.launches, mm_ops.stream_matmul.nk_launches) == before
    assert torch.equal(out, stream_matmul_ref(x, w, w_layout="nk"))
    assert torch.equal(out, stream_matmul_ref(x, w.T.contiguous()))
    with pytest.raises(ValueError, match="w_layout"):
        mm_ops.stream_matmul(x, w, w_layout="kt")


def test_stream_matmul_cpu_dispatch_takes_plain_path():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 40), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((40, 70), np.float32)).bfloat16()
    before = mm_ops.stream_matmul.launches
    out = mm_ops.stream_matmul(x, w)
    assert mm_ops.stream_matmul.launches == before
    assert torch.equal(out, stream_matmul_ref(x, w))


def test_stream_matmul_off_cpu_never_falls_back():
    # all on meta takes the plain version (shapes only, test_torch_meta.py);
    # a tensor off the CPU beside one on it is neither case and raises
    x = torch.empty((1, 8), device="meta")
    w = torch.empty((8, 4))
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, w)


@pytest.mark.parametrize(
    "m,k,n,elem,splits",
    [
        (9, 2048, 2048, 2, 0),  # tiled path
        (1, 2048, 151936, 2, 1),  # qwen3 lm_head: 1187 slabs of 128 columns fill the card
        (1, 2048, 2048, 2, 8),  # qwen3 wq: 16 slabs, K cut into a cluster of 8
        (1, 2048, 1024, 2, 8),  # qwen3 wk / wv: 8 slabs, 256 rows a split
        (1, 8192, 3072, 2, 8),  # llama3.2 w2: 24 slabs
        (1, 3072, 8192, 2, 2),  # llama3.2 w1 / w3: 64 slabs, 128 blocks
        (4, 2048, 8512, 2, 2),  # mamba2 in_proj at decode: 67 slabs, 134 blocks
        (4, 2048, 8512, 4, 1),  # its f32 check path: 133 slabs of 64 columns
        (1, 3072, 128256, 2, 1),  # llama3.2 lm_head: 1002 slabs
        (1, 4096, 4096, 2, 4),  # the hybrid's 4096 x 4096: 32 slabs, 128 blocks
        (1, 40, 64, 2, 1),  # too shallow to cut
        (1, 127, 64, 2, 1),  # two chunks of at least 64 rows need K >= 128
        (1, 128, 64, 2, 2),
    ],
)
def test_k_splits(m, k, n, elem, splits):
    got = mm_ops.k_splits(m, k=k, n=n, sm_count=132, elem=elem)
    assert got == splits
    if m <= mm_ops.GEMV_MAX_M:  # a power of two, at most one cluster
        assert got & (got - 1) == 0 and 1 <= got <= mm_ops.GEMV_MAX_SPLITS
    chunk = -(-k // max(got, 1))  # the kernel's K rows per split
    assert (got - 1) * chunk < k  # no split is empty
    assert got <= 1 or chunk >= 64


@pytest.mark.parametrize(
    "m,k,n,w_layout,experts,splits",
    [
        (4096, 6144, 8, "kn", 1, 16),  # grok-1-314b's router at 4 x 1024 tokens: 16 tiles of 256 x 8
        (6144, 4096, 8, "kn", 1, 11),  # its dW (x read as (K, M)): a 6144 x 8 output, 24 tiles
        (4096, 7168, 128, "kn", 1, 8),  # arctic-480b's router: 32 tiles of 128 x 128
        (7168, 4096, 128, "kn", 1, 4),  # its dW: 56 tiles
        (4096, 8, 6144, "nk", 1, 1),  # grok's dX (K = E): 1536 tiles fill the card
        (4096, 128, 7168, "nk", 1, 1),  # arctic's dX
        (256, 4096, 8, "kn", 8, 32),  # expert-batched: every expert's tiles count
        (64, 64, 8, "kn", 1, 1),  # too shallow to cut
    ],
)
def test_narrow_splits(m, k, n, w_layout, experts, splits):
    got = mm_ops.narrow_splits(m, n, k, 132, experts=experts, w_layout=w_layout)
    assert got == splits
    bk = mm_ops.narrow_tile(n, w_layout)[2]
    chunk = -(-(-(-k // got)) // bk) * bk  # the kernel's K rows per split, whole K tiles
    assert (got - 1) * chunk < k  # no split is empty
    assert experts * got <= 65535  # the grid's z axis


# The routes: a pure rule of dtype and shape, decided in the wrapper.
BF16, F32 = torch.bfloat16, torch.float32
MM_ROUTES = [
    # (M, K, N, dtype, aligned, route): every bf16 projection of a prefill of
    # 4 x 1024 tokens (qwen3-1.7b, llama3.2-3b, mamba2-1.3b) and of the
    # decode-vs-forward check's 4 x 1088 tokens, the kernel bench's product;
    # M <= 8; f32, ragged K or N, misaligned operands
    (4096, 2048, 2048, BF16, True, "wgmma"),
    (4096, 2048, 1024, BF16, True, "wgmma"),
    (4096, 2048, 6144, BF16, True, "wgmma"),
    (4096, 6144, 2048, BF16, True, "wgmma"),
    (4096, 3072, 3072, BF16, True, "wgmma"),
    (4096, 3072, 1024, BF16, True, "wgmma"),
    (4096, 3072, 8192, BF16, True, "wgmma"),
    (4096, 8192, 3072, BF16, True, "wgmma"),
    (4096, 2048, 8512, BF16, True, "wgmma"),  # mamba2 in_proj: N not a multiple of 128
    (4096, 4096, 2048, BF16, True, "wgmma"),
    (4352, 2048, 2048, BF16, True, "wgmma"),
    (256, 512, 256, BF16, True, "wgmma"),  # kernel bench
    (9, 64, 64, BF16, True, "wgmma"),
    (1, 2048, 2048, BF16, True, "gemv"),
    (4, 2048, 151936, BF16, True, "gemv"),  # prefill's LM head on the last position
    (8, 300, 1001, BF16, False, "gemv"),
    (4096, 2048, 2048, F32, True, "simt"),
    (9, 300, 1001, BF16, True, "simt"),
    (64, 2048, 6144, F32, True, "simt"),
    # the MoE routers in f32 at prefill (E = 8 and 128 columns) take the
    # narrow route, ragged M and N = 60 too; at decode (M = 4) the gemv; a
    # router in bf16 stays on wgmma; more than 128 columns, rows no multiple
    # of 16 bytes (N or K not a multiple of 4) and misaligned operands on simt
    (4096, 6144, 8, F32, True, "narrow"),
    (4096, 7168, 128, F32, True, "narrow"),
    (4095, 6144, 60, F32, True, "narrow"),
    (9, 64, 8, F32, True, "narrow"),
    (4, 6144, 8, F32, True, "gemv"),
    (4096, 6144, 8, BF16, True, "wgmma"),
    (4096, 6144, 132, F32, True, "simt"),
    (4096, 6144, 6, F32, True, "simt"),
    (4096, 6142, 8, F32, True, "simt"),
    (4096, 6144, 8, F32, False, "simt"),
    (4096, 2048, 2048, BF16, False, "simt"),
    (16, 2048, 1004, BF16, True, "simt"),
    (16, 1004, 2048, BF16, True, "simt"),
]


@pytest.mark.parametrize("m,k,n,dtype,aligned,route", MM_ROUTES)
def test_mm_route(m, k, n, dtype, aligned, route):
    assert mm_ops.mm_route(m, n, k, dtype, aligned) == route


NK_ROUTES = [
    # (M, K, N, dtype, aligned, route) of a K-major (N, K) weight: minicpm-2b's
    # tied head (V = 122753, odd) at prefill-forward, in the kernel check and
    # at decode; an odd N is no bar to the wgmma route; K not a multiple of
    # 8, f32 and misaligned operands take simt
    (4352, 2304, 122753, BF16, True, "wgmma"),
    (4096, 2304, 122753, BF16, True, "wgmma"),
    (64, 2304, 122753, BF16, True, "wgmma"),
    (16, 2048, 1001, BF16, True, "wgmma"),
    (1, 2304, 122753, BF16, True, "gemv"),
    (4, 2304, 122753, BF16, True, "gemv"),
    (8, 300, 1001, F32, False, "gemv"),
    (64, 300, 1001, BF16, True, "simt"),
    (64, 2048, 1001, F32, True, "simt"),
    (16, 2048, 1001, BF16, False, "simt"),
    # the routers' dX in f32 (dY (M, E) @ w_router^T, K = E = 8 or 128) on
    # the narrow route, any N; more than 128 terms, K no multiple of 4 and
    # misaligned operands on simt; bf16 on wgmma
    (4096, 8, 6144, F32, True, "narrow"),
    (4096, 128, 7168, F32, True, "narrow"),
    (100, 8, 1001, F32, True, "narrow"),
    (4096, 8, 6144, BF16, True, "wgmma"),
    (4096, 132, 7168, F32, True, "simt"),
    (4096, 6, 7168, F32, True, "simt"),
    (4096, 8, 6144, F32, False, "simt"),
]


@pytest.mark.parametrize("m,k,n,dtype,aligned,route", NK_ROUTES)
def test_mm_route_nk(m, k, n, dtype, aligned, route):
    assert mm_ops.mm_route(m, n, k, dtype, aligned, "nk") == route


FA_ROUTES = [
    # (B, Sq, Skv, H, Hkv, D, dtype, aligned, route): the dense prefill calls
    # of qwen3-1.7b and llama3.2-3b, the decode-vs-forward check's, the kernel
    # bench's, the reference's test shapes in bf16; the live call (Sq = 1),
    # f32, D = 80 at 15 folded rows, D = 32, Sq > Skv, too few folded rows,
    # misaligned
    (4, 1024, 1024, 16, 8, 128, BF16, True, "wgmma"),
    (4, 1024, 1024, 24, 8, 128, BF16, True, "wgmma"),
    (4, 1088, 1088, 24, 8, 128, BF16, True, "wgmma"),
    (1, 512, 512, 8, 2, 64, BF16, True, "wgmma"),
    (2, 256, 256, 8, 2, 64, BF16, True, "wgmma"),
    (1, 300, 300, 24, 8, 128, BF16, True, "wgmma"),
    (1, 32, 32, 4, 2, 64, BF16, True, "wgmma"),  # 64 folded rows
    (1, 1, 1, 16, 8, 128, BF16, True, "simt"),
    (1, 1, 1, 24, 8, 128, BF16, True, "simt"),
    (4, 1024, 1024, 16, 8, 128, F32, True, "simt"),
    (1, 5, 77, 6, 2, 80, BF16, True, "simt"),
    (1, 128, 128, 4, 4, 32, BF16, True, "simt"),
    (2, 70, 40, 4, 2, 64, BF16, True, "simt"),
    (1, 31, 31, 4, 2, 64, BF16, True, "simt"),
    (4, 1024, 1024, 16, 8, 128, BF16, False, "simt"),
    # recurrentgemma-9b (D = 256): its prefill and a windowed forward on the
    # tensor cores (D = 256 is a wgmma head dim), the live call (16 folded
    # rows) on simt
    (4, 1024, 1024, 16, 1, 256, BF16, True, "wgmma"),
    (1, 4096, 4096, 16, 1, 256, BF16, True, "wgmma"),
    (1, 1, 1, 16, 1, 256, BF16, True, "simt"),
    # hubert-xlarge's forward (D = 80, MHA) and one query head of
    # recurrentgemma-9b (a 16x16 rank's shard) on the tensor cores; the rule's
    # edges at D 80 and 256: 63 and 64 folded rows, f32, Sq > Skv, misaligned
    (4, 1024, 1024, 16, 16, 80, BF16, True, "wgmma"),
    (16, 4096, 4096, 1, 1, 256, BF16, True, "wgmma"),
    (1, 63, 63, 1, 1, 80, BF16, True, "simt"),
    (1, 64, 64, 1, 1, 80, BF16, True, "wgmma"),
    (1, 21, 21, 3, 1, 256, BF16, True, "simt"),  # 21 x 3 = 63
    (1, 4, 4, 16, 1, 256, BF16, True, "wgmma"),  # 4 x 16 = 64
    (4, 1024, 1024, 16, 16, 80, F32, True, "simt"),
    (4, 1024, 1024, 16, 1, 256, F32, True, "simt"),
    (1, 300, 200, 16, 4, 80, BF16, True, "simt"),
    (4, 1024, 1024, 16, 1, 256, BF16, False, "simt"),
    (1, 64, 64, 2, 2, 96, BF16, True, "simt"),  # not a wgmma head dim
]


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,dtype,aligned,route", FA_ROUTES)
def test_fa_route(b, sq, skv, h, hkv, d, dtype, aligned, route):
    assert fa_ops.fa_route(b, sq, skv, h, hkv, d, dtype, aligned) == route


STALE_CASES = [
    # (mtime of each file, sources that must be rebuilt)
    ({"a.cu": 1, "b.cu": 1, "h.cuh": 1, "liba.so": 2, "libb.so": 2}, []),
    ({"a.cu": 3, "b.cu": 1, "h.cuh": 1, "liba.so": 2, "libb.so": 2}, ["a.cu"]),
    ({"a.cu": 1, "b.cu": 1, "h.cuh": 3, "liba.so": 2, "libb.so": 2}, ["a.cu", "b.cu"]),
    ({"a.cu": 1, "b.cu": 1, "liba.so": 2}, ["b.cu"]),
]


@pytest.mark.parametrize("mtimes,stale", STALE_CASES)
def test_stale_sources(tmp_path, mtimes, stale):
    """A library is rebuilt when it is missing or older than its source or
    than any shared header."""
    csrc, build = tmp_path / "csrc", tmp_path / "build"
    csrc.mkdir()
    build.mkdir()
    for name, t in mtimes.items():
        path = (build if name.endswith(".so") else csrc) / name
        path.write_text("")
        os.utime(path, (1e9 + t, 1e9 + t))
    assert [p.name for p in _build.stale_sources(csrc, build)] == stale


# -- flash attention ------------------------------------------------------------

FA_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window)
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (2, 128, 128, 4, 1, 32, True, 64),  # MQA + sliding window
    (1, 128, 128, 4, 4, 32, False, 0),  # bidirectional (hubert)
    # recurrentgemma-9b's local attention: MQA, g = 16, head dim 256; causal,
    # and with a window that the sequence outgrows
    (1, 128, 128, 16, 1, 256, True, 0),
    (1, 192, 192, 16, 1, 256, True, 64),
    # hubert-xlarge's bidirectional MHA at head dim 80, and D = 80 with GQA
    # (g = 4) under a causal window
    (1, 128, 128, 16, 16, 80, False, 0),
    (1, 128, 128, 8, 2, 80, True, 48),
]


def _qkv(b, sq, skv, h, hkv, d, dtype, seed=2):
    rng = np.random.default_rng(seed)
    return [
        _pair(rng.standard_normal(shape, np.float32), dtype)
        for shape in ((b, sq, h, d), (b, skv, hkv, d), (b, skv, hkv, d))
    ]


@pytest.mark.parametrize("b,sq,skv,h,hkv,d,causal,window", FA_CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_ref_matches_pallas(b, sq, skv, h, hkv, d, causal, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(b, sq, skv, h, hkv, d, dtype)
    out = jax_flash(
        qj, kj, vj, causal=causal, window=window, block_q=64, block_kv=64, interpret=True
    )
    _close(attention_ref(qt, kt, vt, causal=causal, window=window), out)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_attention_ref_single_token(dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(1, 1, 1, 16, 8, 128, dtype)
    _close(attention_ref(qt, kt, vt), jax_attention_ref(qj, kj, vj))
    # one key: the output is that key's value
    _close(attention_ref(qt, kt, vt), vt.repeat_interleave(2, dim=2))


def test_flash_attention_cpu_dispatch_takes_plain_path():
    (_, q), (_, k), (_, v) = _qkv(1, 16, 16, 4, 2, 32, "bfloat16")
    before = fa_ops.flash_attention.launches
    out = fa_ops.flash_attention(q, k, v, causal=True, window=4)
    assert fa_ops.flash_attention.launches == before
    assert torch.equal(out, attention_ref(q, k, v, causal=True, window=4))


def test_flash_attention_off_cpu_never_falls_back():
    q = torch.empty((1, 2, 2, 8), device="meta")
    kv = torch.empty((1, 2, 2, 8))
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, kv, kv)
