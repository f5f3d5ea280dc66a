"""Flash attention masked by positions, on the CPU.

``flash_attention(..., q_positions=, kv_positions=)`` masks as the
reference's ``attend`` does (``src/repro/models/common.py``): key t is
visible to query s when ``kv_positions[t] >= 0``, causal ``q_positions[s]
>= kv_positions[t]`` and, with a window, ``q_positions[s] -
kv_positions[t] < window``; a row that sees no key gives 0, a -inf
statistic and zero gradients (``masked_softmax``). Here the plain version,
which the card's kernels are held to, is held to ``attend`` and to
``jax.vjp`` of it: in f32 at rtol = atol = 1e-5 (the same f32 function,
sums in another order; ``tests/test_torch_flash_bwd_route.py``'s
tolerance), in bf16 at 5e-2. The layouts are Qwen2-VL's M-RoPE temporal
positions (arXiv:2409.12191 §2.1: an image's gh x gw patches share one
temporal position, the text after it starts at max(gh, gw)), with a row
whose tail is -1 (padding slots), a window over positions, g = 7 and g = 1,
head dims 128 and 80. Without positions the plain version keeps its bits.

The wrapper's checks of the positions, its scratch for the kernels'
pre-pass, the autograd ``Function`` handing the positions to the backward,
and the dry-run's memory pass on meta run here too; the kernels themselves
only on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``). The
qwen2-vl-7b model on that layout: its loss and every gradient against
``jax.value_and_grad`` of the reference's (``test_torch_train_loss.py``'s
tolerances), its prefill's logits against the reference's.
"""
import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.launch.specs import make_concrete_batch as ref_make_concrete_batch  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro.models.common import attend as ref_attend  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.flash_attention import ops as fa_ops  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    attention_ref,
    attention_ref_backward,
    attention_ref_lse,
)
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.roofline import memory  # noqa: E402
from repro_torch.tree import flatten, unflatten_like  # noqa: E402

F32_TOL = 1e-5
BF16_TOL = 5e-2


def mrope_positions(b, gh, gw, s_text, tail=0):
    """Qwen2-VL's (3, B, S) positions: an image of gh x gw patches at
    temporal 0 (height, width: the patch's row and column), then text from
    max(gh, gw) on all three axes; row 0's last ``tail`` slots at -1."""
    n = gh * gw
    text = np.arange(s_text) + max(gh, gw)
    pos = np.stack([np.concatenate([np.zeros(n), text]), np.concatenate([np.arange(n) // gw, text]),
                    np.concatenate([np.arange(n) % gw, text])]).astype(np.int32)
    pos = np.broadcast_to(pos[:, None, :], (3, b, n + s_text)).copy()
    if tail:
        pos[:, 0, -tail:] = -1
    return pos


# (B, gh, gw, text, H, Hkv, D, causal, window, tail): qwen2-vl-7b's g = 7 at D
# 128 with a -1 tail, bidirectional at the same shape, g = 1 at D 80 with a
# window over positions
CASES = [
    (2, 3, 5, 20, 7, 1, 128, True, 0, 6),
    (2, 3, 5, 20, 7, 1, 128, False, 0, 6),
    (2, 2, 6, 24, 4, 4, 80, True, 8, 3),
]
IDS = ["g7-tail", "bidirectional", "g1-d80-window"]


def _inputs(case, seed, dtype=np.float32):
    b, gh, gw, text, h, hkv, d = case[:7]
    s = gh * gw + text
    rng = np.random.default_rng(seed)
    q, do = (rng.standard_normal((b, s, h, d)).astype(dtype) for _ in range(2))
    k, v = (rng.standard_normal((b, s, hkv, d)).astype(dtype) for _ in range(2))
    pos = mrope_positions(b, gh, gw, text, case[9])[0]
    return q, k, v, do, pos


def _ref(q, k, v, pos, causal, window):
    return ref_attend(q, k, v, q_positions=pos, kv_positions=pos, causal=causal, window=window or None)


@functools.partial(jax.jit, static_argnums=(5, 6))
def _ref_and_grads(q, k, v, do, pos, causal, window):
    """``attend``'s output by positions and ``jax.vjp`` of it at ``do``,
    compiled once a shape."""
    out, vjp = jax.vjp(lambda q_, k_, v_: _ref(q_, k_, v_, pos, causal, window), q, k, v)
    return out, vjp(do)


def _torch(*arrays, dtype=torch.float32):
    return [torch.from_numpy(np.asarray(a)).to(dtype) for a in arrays]


def _visible(pos, causal, window):
    """(B, Sq, Skv) bool: the reference attend's mask by positions."""
    qp, kp = pos[:, :, None].astype(np.int64), pos[:, None, :].astype(np.int64)
    vis = (kp >= 0) & (qp == qp)
    if causal:
        vis &= qp >= kp
    if window:
        vis &= qp - kp < window
    return vis


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_plain_path_matches_attend_and_its_vjp(case):
    """f32: the output, dQ / dK / dV and the statistics against ``attend``,
    ``jax.vjp`` of it and log2(e) times ``jax.nn.logsumexp`` of the visible
    scaled scores; a query that sees no key gives exactly 0 and dQ 0 and a
    -inf statistic, a key no query sees gets exactly 0."""
    causal, window = case[7:9]
    q, k, v, do, pos = _inputs(case, 10 + sum(case))
    want, want_grads = _ref_and_grads(q, k, v, do, pos, causal, window)
    tp = torch.from_numpy(pos)
    kw = dict(causal=causal, window=window, q_positions=tp, kv_positions=tp)
    got = attention_ref(*_torch(q, k, v), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL, atol=F32_TOL)
    grads = attention_ref_backward(*_torch(q, k, v, do), **kw)
    for name, g, w in zip("qkv", grads, want_grads):
        assert torch.isfinite(g).all(), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=F32_TOL, atol=F32_TOL, err_msg=f"d{name}")
    vis = _visible(pos, causal, window)
    empty = torch.from_numpy(~vis.any(-1))
    assert bool(empty.any()) == causal
    for t in (got, grads[0]):
        assert torch.equal(t[empty], torch.zeros_like(t[empty]))
    if causal:
        dead = torch.from_numpy(pos < 0)
        for g in grads[1:]:
            assert torch.equal(g[dead], torch.zeros_like(g[dead]))
    b, s, h, d = q.shape
    hkv = k.shape[2]
    lse = attention_ref_lse(*_torch(q, k), causal=causal, window=window, q_positions=tp, kv_positions=tp)
    scores = np.einsum("bqkgd,btkd->bkgqt", q.reshape(b, s, hkv, h // hkv, d) / math.sqrt(d), k)
    want_lse = jax.nn.logsumexp(jnp.where(vis[:, None, None], scores, -jnp.inf), axis=-1) * math.log2(math.e)
    want_lse = np.asarray(want_lse).reshape(b, h, s)
    none = empty.numpy()[:, None, :].repeat(h, 1)
    assert np.isneginf(lse.numpy()[none]).all()
    np.testing.assert_allclose(lse.numpy()[~none], want_lse[~none], rtol=1e-6, atol=1e-6)


def test_plain_bf16_matches_attend():
    """bf16 at qwen2-vl-7b's g = 7 with the tail: the output and gradients
    against ``attend`` and ``jax.vjp`` of it in bf16 at 5e-2."""
    case = CASES[0]
    causal, window = case[7:9]
    q, k, v, do, pos = _inputs(case, 30 + sum(case))
    qb, kb, vb, dob = (jnp.asarray(a, dtype=jnp.bfloat16) for a in (q, k, v, do))
    want, want_grads = _ref_and_grads(qb, kb, vb, dob, pos, causal, window)
    tp = torch.from_numpy(pos)
    args = _torch(q, k, v, do, dtype=torch.bfloat16)
    got = attention_ref(*args[:3], causal=causal, window=window, q_positions=tp, kv_positions=tp)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want).astype(np.float32), rtol=BF16_TOL,
                               atol=BF16_TOL)
    grads = attention_ref_backward(*args, causal=causal, window=window, q_positions=tp, kv_positions=tp)
    for name, g, w in zip("qkv", grads, want_grads):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w).astype(np.float32), rtol=BF16_TOL,
                                   atol=BF16_TOL, err_msg=f"d{name}")


def _old_attention_ref(q, k, v, causal, window):
    """The plain forward as it was before positions: the index path's bits."""
    b, sq, h, d = q.shape
    _, skv, hkv, _ = k.shape
    qf = q.float().reshape(b, sq, hkv, h // hkv, d)
    s = torch.einsum("bqkgd,btkd->bkgqt", qf * (1.0 / math.sqrt(d)), k.float())
    qpos = torch.arange(sq)[:, None]
    kpos = torch.arange(skv)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        mask = qpos >= kpos
    if window > 0:
        mask = mask & ((qpos - kpos) < window)
    s = torch.where(mask[None, None, None], s, torch.tensor(-1e30))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    p = p / p.sum(dim=-1, keepdim=True)
    return torch.einsum("bkgqt,btkd->bqkgd", p, v.float()).reshape(b, sq, h, d).to(q.dtype)


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_positions_none_keeps_the_index_bits(causal, window):
    """Both ``None``: the bits of the plain version before positions; the
    index as positions gives the same values."""
    q, k, v, do, _ = _inputs((2, 2, 3, 15, 4, 2, 64, causal, window, 0), 50)
    q, k, v, do = _torch(q, k, v, do)
    got = attention_ref(q, k, v, causal=causal, window=window)
    assert torch.equal(got, _old_attention_ref(q, k, v, causal, window))
    index = torch.arange(q.shape[1], dtype=torch.int32).expand(q.shape[0], -1)
    by_pos = attention_ref(q, k, v, causal=causal, window=window, q_positions=index, kv_positions=index)
    torch.testing.assert_close(by_pos, got, rtol=1e-6, atol=1e-6)
    grads = attention_ref_backward(q, k, v, do, causal=causal, window=window)
    grads_pos = attention_ref_backward(q, k, v, do, causal=causal, window=window, q_positions=index,
                                       kv_positions=index)
    for g, w in zip(grads_pos, grads):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_wrapper_checks_the_positions():
    q, k = torch.empty(2, 10, 4, 64), torch.empty(2, 12, 2, 64)
    qp, kp = torch.zeros(2, 10, dtype=torch.int32), torch.zeros(2, 12, dtype=torch.int32)
    assert fa_ops._check_positions(q, k, None, None) is None
    got = fa_ops._check_positions(q, k, qp, kp)
    assert got[0] is qp and got[1] is kp
    only_q = fa_ops._check_positions(q, k, qp, None)  # the other side at 0..S-1
    assert torch.equal(only_q[1], torch.arange(12, dtype=torch.int32).expand(2, 12))
    with pytest.raises(TypeError, match="int32"):
        fa_ops._check_positions(q, k, qp.long(), kp)
    with pytest.raises(ValueError, match="kv_positions"):
        fa_ops._check_positions(q, k, qp, kp[:, :10])
    with pytest.raises(ValueError, match="q_positions"):
        fa_ops._check_positions(q, k, torch.zeros(10, 2, dtype=torch.int32).t(), kp)  # not contiguous
    # the pre-passes' scratch: B * (2 * ceil(Sq * g / 64) + 2 * ceil(Skv / 32)) pairs
    ranges = fa_ops._range_scratch(q, k, got)
    assert ranges.dtype == torch.int32 and ranges.numel() == 2 * 2 * (2 * 1 + 2 * 1)
    assert fa_ops._range_scratch(q, k, None) is None


def test_autograd_hands_the_positions_to_the_backward(monkeypatch):
    seen_fwd, seen_bwd = [], []

    def forward(q, k, v, causal, window, scale, lse=None, pos=None):
        seen_fwd.append(pos)
        return attention_ref(q, k, v, causal=causal, window=window, sm_scale=scale, q_positions=pos[0],
                             kv_positions=pos[1])

    def backward(q, k, v, out, dout, **kw):
        seen_bwd.append((kw["q_positions"], kw["kv_positions"]))
        return attention_ref_backward(q, k, v, dout, causal=kw["causal"], window=kw["window"],
                                      sm_scale=kw["sm_scale"], q_positions=kw["q_positions"],
                                      kv_positions=kw["kv_positions"])

    monkeypatch.setattr(fa_ops, "_forward", forward)
    monkeypatch.setattr(fa_ops, "flash_attention_backward", backward)
    q, k, v, do, pos = _inputs(CASES[0], 60)
    q, k, v = (t.requires_grad_() for t in _torch(q, k, v))
    tp = torch.from_numpy(pos)
    out = fa_ops._FlashAttention.apply(q, k, v, True, 0, 1 / math.sqrt(q.shape[-1]), (tp, tp))
    grads = torch.autograd.grad(out, (q, k, v), torch.from_numpy(do))
    assert len(seen_fwd) == len(seen_bwd) == 1
    assert seen_fwd[0][0] is tp and seen_bwd[0][0] is tp and seen_bwd[0][1] is tp
    want = attention_ref_backward(q, k, v, torch.from_numpy(do), causal=True, q_positions=tp, kv_positions=tp)
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def test_memory_pass_allocates_the_pre_pass_scratch():
    """On meta under a card count the forward and the backward take the
    CUDA path up to the launch: with positions each also allocates the
    pre-pass's scratch, by the same rule as on the card."""
    b, s, h, hkv, d = 2, 100, 7, 1, 128
    q = torch.empty(b, s, h, d, dtype=torch.bfloat16, device="meta")
    k, v = (torch.empty(b, s, hkv, d, dtype=torch.bfloat16, device="meta") for _ in range(2))
    pos = torch.empty(b, s, dtype=torch.int32, device="meta")
    scratch = 4 * 2 * b * (2 * math.ceil(s * h / hkv / 64) + 2 * math.ceil(s / 32))

    def run(**kw):
        out = fa_ops.flash_attention(q, k, v, causal=True, **kw)
        fa_ops.flash_attention_backward(q, k, v, out, torch.empty_like(q), causal=True, **kw)

    _, plain = memory.count(run, card=True)
    _, by_pos = memory.count(lambda: run(q_positions=pos, kv_positions=pos), card=True)
    assert by_pos.peak - plain.peak == scratch, (by_pos.peak, plain.peak, scratch)


VLM = "qwen2-vl-7b"
VLM_SHAPE = RefShapeSpec("vlm_layout", 48, 2, "train")  # 6 vision patches: a 2 x 3 image


@functools.lru_cache(maxsize=1)
def _vlm(dtype="float32"):
    """(port config, reference config, the reference's numpy parameters, its
    batch on the layout), made once for both tests."""
    cfg = dataclasses.replace(get_config(VLM).reduced(), dtype=dtype)
    ref_cfg = dataclasses.replace(ref_get_config(VLM).reduced(), dtype=dtype)
    params = jax.tree.map(np.asarray, jax.jit(ref_model.build_model(ref_cfg).init)(jax.random.PRNGKey(3)))
    batch = dict(ref_make_concrete_batch(ref_cfg, VLM_SHAPE, seed=4))
    n_vis = batch["vision_embeds"].shape[1]
    batch["positions3"] = jnp.asarray(mrope_positions(2, 2, n_vis // 2, VLM_SHAPE.seq_len - n_vis))
    assert not np.array_equal(np.asarray(batch["positions3"][0, 0]), np.arange(VLM_SHAPE.seq_len))
    return cfg, ref_cfg, params, batch


def _port_batch(batch):
    return {k: to_tensor(np.asarray(v)) for k, v in batch.items()}


def test_vlm_loss_and_grads_on_the_layout_match_reference():
    """qwen2-vl-7b (reduced, f32) on Qwen2-VL's layout: the loss within 1e-5
    and every gradient leaf within 1e-4 relative L2 of the reference's
    ``jax.value_and_grad`` (``test_torch_train_loss.py``'s tolerances)."""
    cfg, ref_cfg, params, batch = _vlm()
    (ref_loss, _), ref_grads = jax.jit(jax.value_and_grad(ref_model.build_model(ref_cfg).loss, has_aux=True))(
        jax.tree.map(jnp.asarray, params), batch)
    port_params = params_from_reference(params)
    loss, _, grads = value_and_grad(build_model(cfg), port_params, _port_batch(batch))
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5, atol=1e-5)
    want = dict(flatten(jax.tree.map(np.asarray, ref_grads)))
    got = dict(flatten(unflatten_like(port_params, grads)))
    assert list(got) == list(want)
    for path, g in got.items():
        w = want[path].astype(np.float64)
        den = np.linalg.norm(w)
        rel = np.linalg.norm(g.double().numpy() - w) / den if den > 0 else np.linalg.norm(g.double().numpy())
        assert rel <= 1e-4, f"{path}: relative L2 {rel:.3e}"


def test_vlm_prefill_on_the_layout_matches_reference():
    """The prefill's logits (its last position) on the layout, f32."""
    cfg, ref_cfg, params, batch = _vlm()
    batch = {k: v for k, v in batch.items() if k != "labels"}  # a copy: the cached batch keeps its labels
    ref_logits, _ = ref_model.build_model(ref_cfg).prefill(jax.tree.map(jnp.asarray, params), batch,
                                                           max_seq=VLM_SHAPE.seq_len + 1)
    with torch.inference_mode():
        logits, cache = build_model(cfg).prefill(params_from_reference(params), _port_batch(batch),
                                                 max_seq=VLM_SHAPE.seq_len + 1)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-4, atol=1e-4)
