"""The kernels' gradients on the CPU: the plain backward of flash attention
(``attention_ref_backward``, what ``chip_smoke.py`` and the card tests hold
the CUDA backward against) equals JAX's gradient of the reference's
``attention_ref`` at every mask and head dim the families use; and the
``autograd.Function``s of ``stream_matmul`` and ``flash_attention`` route
their gradients as the card does (run here with their forward launch
swapped for the plain version, so that the backward's calls go through the
CPU wrappers): dX and dW of both weight layouts through ``stream_matmul``
itself, dQ/dK/dV through ``flash_attention_backward``. The card runs the
same with the kernels (``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import attention_ref, attention_ref_backward  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_ref  # noqa: E402

FA_CASES = [  # (B, Sq, Skv, H, Hkv, D, causal, window)
    (2, 24, 24, 4, 2, 64, True, 0),
    (1, 20, 20, 3, 3, 80, False, 0),
    (2, 16, 16, 4, 1, 256, True, 6),
    (1, 33, 33, 6, 2, 128, True, 0),
    (1, 12, 7, 2, 1, 16, True, 3),  # Sq > Skv: rows the window hides entirely
]


@pytest.mark.parametrize("case", FA_CASES)
def test_plain_flash_backward_matches_jax(case):
    b, sq, skv, h, hkv, d, causal, window = case
    rng = np.random.default_rng(sum(case))
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_attention_ref(q_, k_, v_, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = attention_ref_backward(*(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def test_plain_flash_backward_in_bf16_returns_bf16():
    q, k, v, do = (torch.randn(1, 8, 2, 16).to(torch.bfloat16) for _ in range(4))
    grads = attention_ref_backward(q, k, v, do)
    assert all(g.dtype == torch.bfloat16 for g in grads)


@pytest.mark.parametrize("layout", ["kn", "nk"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_matmul_gradients_go_through_stream_matmul(layout, dtype, monkeypatch):
    calls = []
    inner = mm_ops.stream_matmul

    def spy(x, w, out_dtype=torch.bfloat16, w_layout="kn", rows=None, x_layout="mk"):
        calls.append((tuple(x.shape), tuple(w.shape), w_layout, x_layout, x.is_contiguous() and w.is_contiguous()))
        return inner(x, w, out_dtype=out_dtype, w_layout=w_layout, rows=rows, x_layout=x_layout)

    monkeypatch.setattr(mm_ops, "_stream_matmul_2d", stream_matmul_ref)
    monkeypatch.setattr(mm_ops, "stream_matmul", spy)
    m, k, n = 6, 10, 14
    x = torch.randn(m, k).to(dtype).requires_grad_()
    w = torch.randn(*((k, n) if layout == "kn" else (n, k))).to(dtype).requires_grad_()
    dy = torch.randn(m, n).to(dtype)
    y = mm_ops._StreamMatmul.apply(x, w, dtype, layout)
    gx, gw = torch.autograd.grad(y, (x, w), dy)
    want = torch.autograd.grad(stream_matmul_ref(x, w, dtype, layout), (x, w), dy)
    assert gx.dtype == gw.dtype == dtype
    tol = 0 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(gx, want[0], rtol=tol, atol=tol)
    torch.testing.assert_close(gw, want[1], rtol=tol, atol=tol)
    if layout == "kn":  # dX = dY @ w.T with w read K-major in place; dW = x.T @ dY with x read in place
        assert calls == [((m, n), (k, n), "nk", "mk", True), ((m, k), (m, n), "kn", "km", True)]
    elif dtype == torch.float32:  # dX = dY @ w; dW = dY.T @ x with dY read in place
        assert calls == [((m, n), (n, k), "kn", "mk", True), ((m, n), (m, k), "kn", "km", True)]
    else:  # bf16 rows of dY of n = 14 are no multiple of 16 bytes: dW on a transposed copy
        assert calls == [((m, n), (n, k), "kn", "mk", True), ((n, m), (m, k), "kn", "mk", True)]
    calls.clear()
    (gx_only,) = torch.autograd.grad(mm_ops._StreamMatmul.apply(x, w.detach(), dtype, layout), (x,), dy)
    assert len(calls) == 1 and torch.equal(gx_only, gx)  # no dW product when w needs none


def test_flash_attention_gradients_go_through_the_backward(monkeypatch):
    calls = []
    inner = fa_ops.flash_attention_backward

    def spy(*args, **kw):
        calls.append(kw)
        return inner(*args, **kw)

    monkeypatch.setattr(fa_ops, "_forward", lambda q, k, v, causal, window, scale: attention_ref(
        q, k, v, causal=causal, window=window, sm_scale=scale))
    monkeypatch.setattr(fa_ops, "flash_attention_backward", spy)
    q = torch.randn(2, 12, 4, 16, requires_grad=True)
    k, v = (torch.randn(2, 12, 2, 16, requires_grad=True) for _ in range(2))
    do = torch.randn(2, 12, 4, 16)
    out = fa_ops._FlashAttention.apply(q, k, v, True, 5, 0.3)
    got = torch.autograd.grad(out, (q, k, v), do)
    want = torch.autograd.grad(attention_ref(q, k, v, causal=True, window=5, sm_scale=0.3), (q, k, v), do)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-6)
    assert calls == [{"causal": True, "window": 5, "sm_scale": 0.3}]


def test_wrappers_without_a_backward_raise_only_under_grad():
    x = torch.zeros(2, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="has no backward on CUDA yet"):
        mm_ops._no_grad_on_cuda("stream_matmul_int8", (x,))
    with torch.no_grad():
        mm_ops._no_grad_on_cuda("stream_matmul_int8", (x,))
    mm_ops._no_grad_on_cuda("stream_matmul_int8", (x.detach(),))


def test_cpu_wrappers_differentiate_through_the_plain_versions():
    """On the CPU every wrapper is its plain version, which autograd
    differentiates: the MoE family trains there."""
    x = torch.randn(3, 4, 5, requires_grad=True)
    w = torch.randn(3, 5, 6, requires_grad=True)
    rows = torch.tensor([4, 2, 0], dtype=torch.int32)
    out = mm_ops.stream_matmul(x, w, out_dtype=torch.float32, rows=rows)
    gx, gw = torch.autograd.grad(out.square().sum(), (x, w))
    assert gx[1, 2:].abs().sum() == 0 and gx[2].abs().sum() == 0 and gw[2].abs().sum() == 0
    assert gx[0].abs().sum() > 0
