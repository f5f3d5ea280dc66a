"""The port's kernels against the JAX package's: each plain PyTorch version
(``ref.py``) against the Pallas kernel in interpret mode, on the same numpy
inputs, and the wrappers' CPU dispatch. Tolerance: rtol = atol = 5e-2, the
reference's own (tests/kernels/test_kernels.py), since bf16 rounds at other
places in the two frameworks. The CUDA kernels themselves are held against
these plain versions on the card by ``test_torch_cuda.py``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.kernel import flash_attention as jax_flash  # noqa: E402
from repro.kernels.flash_attention.ref import attention_ref as jax_attention_ref  # noqa: E402
from repro.kernels.streammm.kernel import stream_matmul as jax_stream_matmul  # noqa: E402
from repro.kernels.streammm.ref import stream_matmul_ref as jax_stream_matmul_ref  # noqa: E402
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


def test_stream_matmul_cpu_dispatch_takes_plain_path():
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((3, 40), np.float32)).bfloat16()
    w = torch.from_numpy(rng.standard_normal((40, 70), np.float32)).bfloat16()
    before = mm_ops.stream_matmul.launches
    out = mm_ops.stream_matmul(x, w)
    assert mm_ops.stream_matmul.launches == before
    assert torch.equal(out, stream_matmul_ref(x, w))


def test_stream_matmul_off_cpu_never_falls_back():
    x = torch.empty((1, 8), device="meta")
    w = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError):
        mm_ops.stream_matmul(x, w)


@pytest.mark.parametrize(
    "m,k,n,splits",
    [
        (9, 2048, 2048, 0),  # tiled path
        (1, 2048, 151936, 1),  # qwen3 lm_head: 594 column blocks fill the card
        (1, 2048, 2048, 32),  # qwen3 wq: 8 column blocks, K cut 32 ways
        (1, 8192, 3072, 44),  # llama3.2 w2: 12 column blocks
        (1, 40, 64, 1),  # too shallow to cut
    ],
)
def test_k_splits(m, k, n, splits):
    got = mm_ops.k_splits(m, k=k, n=n, sm_count=132)
    assert got == splits
    chunk = -(-k // max(got, 1))  # the kernel's K rows per split
    assert (got - 1) * chunk < k  # no split is empty


# -- flash attention ------------------------------------------------------------

FA_CASES = [
    # (B, Sq, Skv, H, Hkv, D, causal, window)
    (1, 128, 128, 4, 4, 32, True, 0),
    (2, 256, 256, 8, 2, 64, True, 0),
    (2, 128, 128, 4, 1, 32, True, 64),  # MQA + sliding window
    (1, 128, 128, 4, 4, 32, False, 0),  # bidirectional (hubert)
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
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, q, q)
