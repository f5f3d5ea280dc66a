"""The port's int8-weight streaming matmul against the JAX package's, and the
port's kernel bench against the JAX bench's rows. ``stream_matmul_int8_ref``
and the wrapper's CPU dispatch against the Pallas kernel in interpret mode,
on the same numpy inputs, at rtol = atol = 5e-2, the reference's own
tolerance (tests/kernels/test_kernels.py). The CUDA kernel is held against
``ref.py`` on the card by ``test_torch_cuda.py``; here the route rule, the
wgmma route's split rule, and a plain emulation of that route's arithmetic
(exact products a scale group, the scale applied to the group's f32 sum)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.streammm.kernel import stream_matmul_int8 as jax_stream_matmul_int8  # noqa: E402
from repro.kernels.streammm.ref import stream_matmul_int8_ref as jax_int8_ref  # noqa: E402
from repro_torch.kernels import bench  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_int8_ref  # noqa: E402

RTOL = ATOL = 5e-2
DTYPES = {"bfloat16": (jnp.bfloat16, torch.bfloat16), "float32": (jnp.float32, torch.float32)}
# (M, K, N, block_k): the reference's test shapes, then its bench's
CASES = [(64, 128, 64, 64), (128, 256, 128, 64), (256, 512, 256, 128)]


def _inputs(m, k, n, block_k, dtype, seed=1):
    """x in ``dtype``, int8 weights in [-127, 127), scales in [0.005, 0.02),
    as JAX arrays and as torch tensors holding the same values."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    xj = jnp.asarray(rng.standard_normal((m, k), np.float32)).astype(jd)
    w = rng.integers(-127, 127, (k, n), dtype=np.int8)
    s = rng.uniform(0.005, 0.02, (k // block_k, n)).astype(np.float32)
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(td)
    return (xj, jnp.asarray(w), jnp.asarray(s)), (xt, torch.from_numpy(w), torch.from_numpy(s))


def _close(a, b):
    np.testing.assert_allclose(
        a.float().numpy(), np.asarray(b, np.float32), rtol=RTOL, atol=ATOL
    )


@pytest.mark.parametrize("m,k,n,block_k", CASES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_int8_ref_and_cpu_wrapper_match_pallas(m, k, n, block_k, dtype):
    (xj, wj, sj), (xt, wt, st) = _inputs(m, k, n, block_k, dtype)
    out = jax_stream_matmul_int8(
        xj, wj, sj, block_m=64, block_n=64, block_k=block_k, interpret=True
    )
    ref = stream_matmul_int8_ref(xt, wt, st, block_k)
    assert ref.dtype == torch.bfloat16 and tuple(ref.shape) == (m, n)
    _close(ref, out)
    _close(mm_ops.stream_matmul_int8(xt, wt, st, block_k), out)
    _close(ref, jax_int8_ref(xj, wj, sj, block_k))


def test_int8_ref_out_dtype_f32():
    (xj, wj, sj), (xt, wt, st) = _inputs(8, 256, 40, 32, "float32", seed=2)
    ref = stream_matmul_int8_ref(xt, wt, st, 32, out_dtype=torch.float32)
    assert ref.dtype == torch.float32
    np.testing.assert_allclose(
        ref.numpy(), np.asarray(jax_int8_ref(xj, wj, sj, 32, out_dtype=jnp.float32)), rtol=1e-5, atol=1e-4
    )


def test_int8_cpu_wrapper_any_m_and_n():
    """M and N need not divide a tile: only block_k is the contract."""
    _, (xt, wt, st) = _inputs(3, 96, 1001, 32, "bfloat16", seed=3)
    out = mm_ops.stream_matmul_int8(xt, wt, st, 32, out_dtype=torch.float32)
    assert tuple(out.shape) == (3, 1001) and out.dtype == torch.float32
    assert torch.equal(out, stream_matmul_int8_ref(xt, wt, st, 32, out_dtype=torch.float32))


def test_int8_wrapper_contract_errors_on_the_cpu():
    _, (x, w, s) = _inputs(2, 128, 64, 64, "bfloat16")
    with pytest.raises(ValueError, match="block_k"):
        mm_ops.stream_matmul_int8(x, w, s, 48)  # K % block_k
    with pytest.raises(ValueError, match="scales"):
        mm_ops.stream_matmul_int8(x, w, s[:1], 64)
    with pytest.raises(ValueError, match="scales"):
        mm_ops.stream_matmul_int8(x, w, s.t().contiguous(), 64)
    with pytest.raises(ValueError, match="shapes"):
        mm_ops.stream_matmul_int8(x[:, :64], w, s, 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x, w.to(torch.int16), s, 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x, w, s.double(), 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x.half(), w, s, 64)
    with pytest.raises(TypeError):
        mm_ops.stream_matmul_int8(x, w, s, 64, out_dtype=torch.float16)
    with pytest.raises(ValueError, match="contiguous"):
        mm_ops.stream_matmul_int8(x, w.t().contiguous().t(), s, 64)
    before = mm_ops.stream_matmul_int8.launches
    mm_ops.stream_matmul_int8(x, w, s, 64)
    assert mm_ops.stream_matmul_int8.launches == before  # the plain version launches nothing


@pytest.mark.parametrize(
    "m,n,k,block_k,want",
    [(1, 4096, 4096, 128, 32), (4, 1024, 4096, 128, 32), (1, 14336, 4096, 128, 8),
     (4, 4096, 14336, 128, 28), (1, 128256, 4096, 128, 2), (9, 64, 128, 64, 0), (1, 64, 128, 16, 2)],
)
def test_int8_k_splits_fall_on_whole_groups(m, n, k, block_k, want):
    splits = mm_ops.int8_k_splits(m, n, k, block_k, 132)
    assert splits == want
    if splits:
        groups = k // block_k
        per = -(-groups // splits)
        assert (splits - 1) * per < groups  # no split is empty


@pytest.mark.parametrize(
    "m,n,k,block_k,dtype,aligned,want",
    [
        (256, 256, 512, 128, torch.bfloat16, True, "wgmma"),  # the kernel bench
        (4096, 128256, 4096, 128, torch.bfloat16, True, "wgmma"),  # llama3-8b's LM head at M = 4096
        (4096, 1024, 4096, 128, torch.bfloat16, True, "wgmma"),
        (130, 144, 256, 64, torch.bfloat16, True, "wgmma"),  # ragged M, one k-tile a group
        (1, 4096, 4096, 128, torch.bfloat16, True, "gemv"),
        (8, 64, 7 * 16, 16, torch.float32, True, "gemv"),
        (256, 256, 512, 128, torch.float32, True, "simt"),  # f32 x stays exact f32
        (9, 1001, 300, 100, torch.bfloat16, True, "simt"),  # block_k not whole k-tiles
        (256, 264, 512, 128, torch.bfloat16, True, "simt"),  # int8 rows not a multiple of 16 bytes
        (256, 256, 512, 32, torch.bfloat16, True, "simt"),
        (256, 256, 512, 128, torch.bfloat16, False, "simt"),  # misaligned operands
    ],
)
def test_int8_route(m, n, k, block_k, dtype, aligned, want):
    assert mm_ops.int8_route(m, n, k, block_k, dtype, aligned) == want


@pytest.mark.parametrize(
    "m,n,k,block_k,want",
    [(256, 256, 512, 128, 4), (4096, 4096, 4096, 128, 1), (4096, 1024, 14336, 128, 1),
     (130, 144, 256, 64, 4), (128, 128, 64, 64, 1)],
)
def test_int8_wgmma_splits_fall_on_whole_groups(m, n, k, block_k, want):
    splits = mm_ops.int8_wgmma_splits(m, n, k, block_k, 132)
    assert splits == want and 1 <= splits <= k // block_k


def _scale_factored(x, w_q, scales, block_k):
    """The wgmma route's arithmetic in plain PyTorch: for each scale group,
    the products of x with the unscaled int8 weights (exact in f32: a bf16 x
    times |q| <= 127 needs 15 significant bits) summed in f32, then that sum
    times the group's scale row added to an f32 accumulator."""
    acc = torch.zeros((x.shape[0], w_q.shape[1]))
    for g in range(w_q.shape[0] // block_k):
        rows = slice(g * block_k, (g + 1) * block_k)
        acc += (x[:, rows].float() @ w_q[rows].float()) * scales[g]
    return acc


@pytest.mark.parametrize("m,k,n,block_k", CASES + [(130, 384, 144, 64)])
def test_scale_factored_sum_matches_the_refs(m, k, n, block_k):
    (xj, wj, sj), (xt, wt, st) = _inputs(m, k, n, block_k, "bfloat16", seed=4)
    ours = _scale_factored(xt, wt, st, block_k)
    ref = stream_matmul_int8_ref(xt, wt, st, block_k, out_dtype=torch.float32)
    # only the order of f32 sums and the rounding of q * scale differ
    assert float((ours - ref).norm() / ref.norm()) <= 1e-6
    if m % 64 == 0 and n % 64 == 0:  # the Pallas kernel's tiles
        _close(ours, jax_stream_matmul_int8(xj, wj, sj, block_m=64, block_n=64, block_k=block_k, interpret=True))
    else:
        _close(ours, jax_int8_ref(xj, wj, sj, block_k, out_dtype=jnp.float32))


def test_kernel_bench_rows_on_the_cpu():
    rows = bench.run("cpu")
    # the names, shapes and bound of benchmarks/kernels_bench.py's rows
    assert [r[0] for r in rows] == [
        "kernel_streammm", "kernel_streammm_int8", "kernel_flash_attention", "kernel_paged_attention"
    ]
    shapes = ["M256xK512xN256", "M256xK512xN256xBK128", "B1xS512xH8xHkv2xD64",
              "B4xH8xHkv2xD64xpt32xpages8xlen253"]
    mm_bytes = 2 * (256 * 512 + 512 * 256 + 256 * 256)
    int8_bytes = 2 * 256 * 512 + 512 * 256 + 4 * 4 * 256 + 2 * 256 * 256
    bounds = [mm_bytes / 3.35e12 * 1e6, int8_bytes / 3.35e12 * 1e6, None, None]
    for (name, us, derived), shape, want in zip(rows, shapes, bounds):
        fields = dict(kv.split("=") for kv in derived.split(";"))
        assert us > 0 and fields["shape"] == shape and fields["device"] == "cpu"
        assert float(fields["h100_bound_us"]) > 0
        if want is not None:
            assert float(fields["h100_bound_us"]) == pytest.approx(want, abs=1e-3)


def test_kernel_bench_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run()
