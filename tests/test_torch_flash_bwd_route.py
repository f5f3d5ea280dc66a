"""The flash backward's route rule and its yardsticks, on the CPU.

``fa_bwd_route`` (``repro_torch.kernels.flash_attention.ops``) sends a
backward call to the tensor-core kernels of ``csrc/flash_attention_bwd.cu``
by the forward's rule: bf16, head dim 64 or 128, Sq <= Skv, Sq x H / Hkv >=
64, and q, k, v, the output and its gradient 16-byte aligned; everything
else takes the simt route. Checked at every shape ``chip_smoke.py`` holds
the backward to (``FA_BWD_CASES``) and at the rule's edges. The autograd
``Function`` hands the forward's statistics to the backward only on that
route. The plain backward (``attention_ref_backward``), which the card's
kernels are held to, equals ``jax.vjp`` of the JAX package's
``attention_ref`` at rtol = atol = 1e-5 in f32 (the same f32 function,
sums in another order), at the wgmma route's shapes cut small; and
``attention_ref_lse``, the yardstick of the forward's statistics, equals
log2(e) times ``jax.nn.logsumexp`` of the reference's masked scores at
rtol = atol = 1e-6.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import attention_ref as ref_attention_ref  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    attention_ref_backward,
    attention_ref_lse,
)

ROOT = Path(__file__).resolve().parents[1]


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)  # imports only the standard library; runs nothing
    return module


SMOKE_BWD_CASES = _chip_smoke().FA_BWD_CASES
# the route of each chip_smoke case in bf16: qwen3 (D 128, g 2), minicpm-2b
# (D 64, MHA), llama3.2-3b (g 3), qwen2-vl-7b and arctic-480b (g 7) and
# grok-1-314b (g 6) and examples/port_train_lm.py (D 64, g 5) on the tensor
# cores; hubert's D = 80 and recurrentgemma's D = 256 on simt
SMOKE_BF16_ROUTES = {"qwen3": "wgmma", "minicpm-2b": "wgmma", "hubert-xlarge": "simt",
                     "recurrentgemma-9b": "simt", "recurrentgemma-9b S=4096": "simt", "g=4 D=80": "simt",
                     "llama3.2-3b": "wgmma", "qwen2-vl-7b": "wgmma", "grok-1-314b": "wgmma",
                     "arctic-480b": "wgmma", "port_train_lm": "wgmma"}


def test_every_smoke_case_has_an_expected_route():
    assert sorted(SMOKE_BF16_ROUTES) == sorted(case[0] for case in SMOKE_BWD_CASES)


@pytest.mark.parametrize("case", SMOKE_BWD_CASES, ids=[c[0] for c in SMOKE_BWD_CASES])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
def test_route_at_the_smoke_cases(case, dtype):
    label, b, s, h, hkv, d = case[:6]
    want = SMOKE_BF16_ROUTES[label] if dtype == torch.bfloat16 else "simt"
    assert fa_ops.fa_bwd_route(b, s, s, h, hkv, d, dtype) == want
    assert fa_ops.fa_bwd_route(b, s, s, h, hkv, d, dtype) == fa_ops.fa_route(b, s, s, h, hkv, d, dtype)


@pytest.mark.parametrize("shape,dtype,aligned,want", [
    ((4, 1024, 1024, 16, 8, 128), torch.bfloat16, True, "wgmma"),
    ((4, 1024, 1024, 16, 8, 128), torch.float32, True, "simt"),
    ((4, 1024, 1024, 16, 16, 80), torch.bfloat16, True, "simt"),
    ((4, 1024, 1024, 16, 1, 256), torch.bfloat16, True, "simt"),
    ((1, 300, 200, 8, 2, 64), torch.bfloat16, True, "simt"),  # Sq > Skv
    ((1, 200, 300, 8, 2, 64), torch.bfloat16, True, "wgmma"),  # Sq < Skv
    ((1, 63, 63, 4, 4, 64), torch.bfloat16, True, "simt"),  # Sq x g = 63
    ((1, 64, 64, 4, 4, 64), torch.bfloat16, True, "wgmma"),  # Sq x g = 64
    ((1, 21, 21, 6, 2, 128), torch.bfloat16, True, "simt"),  # 21 x 3 = 63
    ((1, 8, 8, 16, 2, 128), torch.bfloat16, True, "wgmma"),  # 8 x 8 = 64
    ((4, 1024, 1024, 16, 8, 128), torch.bfloat16, False, "simt"),  # a tensor off 16 bytes
])
def test_route_at_the_edges(shape, dtype, aligned, want):
    assert fa_ops.fa_bwd_route(*shape, dtype, aligned) == want


def test_wrapper_reads_alignment_from_all_five_tensors():
    base = torch.zeros(2 * 64 * 4 * 64 + 8, dtype=torch.bfloat16)
    aligned = base[:2 * 64 * 4 * 64].view(2, 64, 4, 64)
    shifted = base[1:1 + 2 * 64 * 4 * 64].view(2, 64, 4, 64)  # 2 bytes on
    assert fa_ops._aligned(aligned, aligned) == (aligned.data_ptr() % 16 == 0)
    assert not fa_ops._aligned(aligned, shifted)


@pytest.mark.parametrize("make,ok", [
    (lambda: torch.empty(2, 4, 32), True),
    (lambda: torch.empty(2, 32, 4), False),  # (B, Sq, H): not the kernels' layout
    (lambda: torch.empty(2, 4, 32, dtype=torch.bfloat16), False),
    (lambda: torch.empty(2, 32, 4).transpose(1, 2), False),  # the right shape, not contiguous
], ids=["right", "layout", "dtype", "strided"])
def test_statistics_buffer_is_checked_before_a_kernel_writes_it(make, ok):
    q = torch.empty(2, 32, 4, 64)
    if ok:
        fa_ops._check_lse(make(), q, "test")
    else:
        with pytest.raises(ValueError, match="statistics"):
            fa_ops._check_lse(make(), q, "test")


def test_autograd_hands_the_statistics_to_the_backward_on_the_wgmma_route(monkeypatch):
    """bf16 at D = 64 and 64 folded rows: the forward gets a (B, H, Sq) f32
    buffer to fill and the backward receives it; in f32 neither sees one."""
    seen_fwd, seen_bwd = [], []
    inner = fa_ops.flash_attention_backward

    def forward(q, k, v, causal, window, scale, lse=None):
        seen_fwd.append(lse)
        if lse is not None:
            lse.copy_(attention_ref_lse(q, k, causal=causal, window=window, sm_scale=scale))
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=scale)

    def backward(*args, **kw):
        seen_bwd.append(kw.get("lse"))
        return inner(*args, **kw)

    monkeypatch.setattr(fa_ops, "_forward", forward)
    monkeypatch.setattr(fa_ops, "flash_attention_backward", backward)
    for dtype, want in ((torch.bfloat16, True), (torch.float32, False)):
        seen_fwd.clear()
        seen_bwd.clear()
        q = torch.randn(2, 32, 4, 64).to(dtype).requires_grad_()
        k, v = (torch.randn(2, 32, 2, 64).to(dtype).requires_grad_() for _ in range(2))
        out = fa_ops._FlashAttention.apply(q, k, v, True, 0, 0.125)
        grads = torch.autograd.grad(out, (q, k, v), torch.randn_like(out))
        assert all(g.dtype == dtype for g in grads)
        assert len(seen_fwd) == len(seen_bwd) == 1
        if want:
            assert seen_fwd[0].shape == (2, 4, 32) and seen_fwd[0].dtype == torch.float32
            assert seen_bwd[0] is seen_fwd[0]
        else:
            assert seen_fwd[0] is None and seen_bwd[0] is None


# the wgmma route's shapes, cut small: D 64 / 128; g 1, 2, 4, 8; causal,
# windowed and bidirectional; Sq = Skv not a multiple of 64, and Sq < Skv
PLAIN_CASES = [  # (B, Sq, Skv, H, Hkv, D, causal, window)
    (1, 37, 37, 2, 2, 64, True, 0),
    (2, 21, 21, 4, 2, 64, True, 5),
    (1, 19, 30, 8, 2, 64, False, 0),
    (1, 13, 13, 8, 1, 128, True, 0),
    (1, 11, 24, 8, 2, 128, True, 4),
    (2, 9, 9, 16, 2, 128, False, 0),
]


def _inputs(case, seed):
    b, sq, skv, h, hkv, d = case[:6]
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, sq, h, d)).astype(np.float32) for _ in range(2))
    k, v = (rng.standard_normal((b, skv, hkv, d)).astype(np.float32) for _ in range(2))
    return q, k, v, do


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_backward_matches_jax_at_the_wgmma_shapes(case):
    causal, window = case[6:]
    q, k, v, do = _inputs(case, 100 + sum(case))
    _, vjp = jax.vjp(lambda q_, k_, v_: ref_attention_ref(q_, k_, v_, causal=causal, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = attention_ref_backward(*(torch.from_numpy(x) for x in (q, k, v, do)), causal=causal, window=window)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"d{name}")


def _jax_masked_scores(q, k, causal, window):
    """The reference's masked scores (attention_ref's ``s``), in JAX."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    qf = jnp.asarray(q).reshape(b, sq, hkv, h // hkv, d)
    s = jnp.einsum("bqkgd,btkd->bkgqt", qf * (1.0 / np.sqrt(d)), jnp.asarray(k))
    qpos, kpos = jnp.arange(sq)[:, None], jnp.arange(skv)[None, :]
    mask = jnp.ones((sq, skv), bool)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = jnp.logical_and(mask, (qpos - kpos) < window)
    return jnp.where(mask[None, None, None], s, -1e30)


@pytest.mark.parametrize("case", PLAIN_CASES + [(1, 12, 7, 2, 1, 16, True, 3)])  # and rows that see no key
def test_plain_statistics_match_jax_logsumexp(case):
    b, sq, skv, h, hkv, d, causal, window = case
    q, k, _, _ = _inputs(case, 200 + sum(case))
    want = np.asarray(jax.nn.logsumexp(_jax_masked_scores(q, k, causal, window), axis=-1)) * math.log2(math.e)
    got = attention_ref_lse(torch.from_numpy(q), torch.from_numpy(k), causal=causal, window=window)
    assert got.shape == (b, h, sq) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want.reshape(b, h, sq), rtol=1e-6, atol=1e-6)


def test_plain_statistics_give_the_softmax():
    """2^(s * scale * log2(e) - lse2) over a row's keys is the softmax
    attention_ref applies, so the backward's P rebuilt from the statistics
    gives attention_ref's output."""
    case = (1, 40, 40, 4, 2, 64, True, 9)
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(case, 7))
    lse = attention_ref_lse(q, k, causal=True, window=9)  # (B, H, Sq)
    s = torch.einsum("bqhd,bthd->bhqt", q / 8.0, k.repeat_interleave(2, dim=2))
    qpos, kpos = torch.arange(40)[:, None], torch.arange(40)[None, :]
    seen = (qpos >= kpos) & (qpos - kpos < 9)
    p = torch.where(seen, torch.exp2(s * math.log2(math.e) - lse[..., None]), torch.zeros(()))
    out = torch.einsum("bhqt,bthd->bqhd", p, v.repeat_interleave(2, dim=2))
    torch.testing.assert_close(out, attention_ref(q, k, v, causal=True, window=9), rtol=1e-5, atol=1e-5)


def test_the_train_lm_case_is_the_examples_call():
    """chip_smoke's port_train_lm row is the attention call of
    examples/port_train_lm.py's step (g = 5 on the wgmma route)."""
    spec = importlib.util.spec_from_file_location("port_train_lm", ROOT / "examples" / "port_train_lm.py")
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    cfg, shape = example.build_cfg(), example.SHAPE
    (row,) = [c for c in SMOKE_BWD_CASES if c[0] == "port_train_lm"]
    assert row[1:8] == (shape.global_batch, shape.seq_len, cfg.num_heads, cfg.num_kv_heads,
                        cfg.resolved_head_dim(), True, 0)
