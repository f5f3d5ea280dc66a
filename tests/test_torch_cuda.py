"""The port's CUDA kernels against their plain PyTorch versions on the card.

Every test here is marked ``cuda`` and skips without a card; on a machine
with an H100:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Imports no JAX, so it runs where only PyTorch is installed. Tolerance: rtol = atol = 5e-2,
the reference's kernel-test tolerance (tests/kernels/test_kernels.py): the
kernels accumulate in f32 in another order than the plain versions and
round to bf16 at other places.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_ref  # noqa: E402

RTOL = ATOL = 5e-2
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
