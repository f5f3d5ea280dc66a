"""The port's MoE layer against the JAX package's, on the CPU: the capacity
rule, the dispatch (top-k, the choice-major capacity sort, drops) fed the
reference's router logits, ``moe_apply`` for grok's plain layout and arctic's
dense residual, and the expert-batched ``stream_matmul_ref`` that the expert
products take.

Inputs are drawn with numpy from a seed and given to both packages. The
reduced configs have 4 experts, top-2 and ``capacity_factor`` 2.0, whose
capacity (= the token count) never drops; the variant at 0.5 (capacity a
quarter of the tokens) drops about half of the assignments, so the drop
path is exercised too.

Tolerances: the dispatch is integer logic and must be equal exactly. In f32
``moe_apply`` agrees within 1e-4: both compute the same function up to the
order of f32 sums, while one misrouted or dropped assignment moves its token
by order 1. In bf16 within rtol = atol = 5e-2, the reference's kernel-test
tolerance, of outputs divided by the reference's rms: bf16 rounds at other
places in the two frameworks, and the reference's init scales an expert
leaf by 1/sqrt(E) (its leading axis), so the layer's outputs have an rms
near 90, where one bf16 step is 0.5 and both packages sit 2-3 away from the
f32 result; the tolerance is meant for O(1) values. The bf16 test also
holds the port's distance from the f32 result to at most 1.5x the
reference's own. A bf16 input can still flip a routing where two gates are
within its rounding, which changes a token by order 1; the bf16 test then
fails and reports the top-k margin of the tokens that flipped (it does not
re-seed).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_ref  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models import model as model_mod  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402

MOE_ARCHS = ["grok-1-314b", "arctic-480b"]
CAPACITY_FACTORS = [2.0, 0.5]
F32_TOL = 1e-4
TOL = 5e-2
B, S = 2, 24


def _cfgs(arch, cf, dtype="bfloat16"):
    """The reduced config of ``arch`` at ``capacity_factor`` cf, in both packages."""
    out = []
    for cfg in (ref_get_config(arch).reduced(), get_config(arch).reduced()):
        cfg = dataclasses.replace(cfg, dtype=dtype, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))
        out.append(cfg)
    return out


def _ref_moe_params(ref_cfg, seed):
    return jax.tree.map(np.asarray, ref_layers.init_moe(jax.random.PRNGKey(seed), ref_cfg))


def _x(cfg, seed):
    """A normalised-looking MoE input (B, S, d), the same values in both packages."""
    a = np.random.default_rng(seed).standard_normal((B, S, cfg.d_model), np.float32)
    j = jnp.asarray(a).astype(jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32)
    return j, to_tensor(np.asarray(j))


def _ref_dispatch(router_logits, m):
    """The reference's dispatch, transcribed from ``moe_apply``
    (``src/repro/models/layers.py:203-216``): (idx, gates, posn, keep, slot,
    counts) as numpy."""
    n = router_logits.shape[0]
    probs = jax.nn.softmax(router_logits, axis=-1)
    gates, idx = jax.lax.top_k(probs, m.top_k)
    gates = gates / (jnp.sum(gates, axis=-1, keepdims=True) + 1e-9)
    cap = ref_layers.moe_capacity(m, n)
    flat_e = idx.T.reshape(-1)
    oh = jax.nn.one_hot(flat_e, m.num_experts, dtype=jnp.int32)
    pos_in_e = jnp.cumsum(oh, axis=0) - oh
    posn = jnp.sum(pos_in_e * oh, axis=-1)
    keep = posn < cap
    slot = flat_e * cap + jnp.where(keep, posn, 0)
    return tuple(np.asarray(a) for a in (idx, gates.T.reshape(-1), posn, keep, slot, jnp.sum(oh, axis=0)))


@pytest.mark.parametrize(
    "num_experts,top_k,cf,n",
    [(4, 2, 2.0, 48), (4, 2, 0.5, 48), (8, 2, 1.25, 4096), (8, 2, 1.25, 4), (128, 2, 1.25, 4096),
     (128, 2, 1.25, 4), (128, 2, 1.25, 1), (4, 2, 2.0, 1), (128, 2, 64.0, 144), (8, 2, 4.0, 144),
     (16, 1, 1.0, 3), (8, 2, 1.25, 1088)],
)
def test_moe_capacity_matches_reference(num_experts, top_k, cf, n):
    """The reference's rule, with its ``max(c, top_k)`` floor (n = 1 and the
    decode steps of 128 experts take it)."""
    ref_m = dataclasses.replace(ref_get_config("grok-1-314b").moe, num_experts=num_experts, top_k=top_k,
                                capacity_factor=cf)
    m = dataclasses.replace(get_config("grok-1-314b").moe, num_experts=num_experts, top_k=top_k,
                            capacity_factor=cf)
    assert layers.moe_capacity(m, n) == ref_layers.moe_capacity(ref_m, n)
    if num_experts == 128 and n <= 4:
        assert layers.moe_capacity(m, n) == top_k  # the floor


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_dispatch_matches_reference(arch, cf):
    """Fed the reference's own router logits, the port's dispatch gives the
    same experts, positions, keeps, slots and counts, exactly."""
    ref_cfg, cfg = _cfgs(arch, cf, "float32")
    params = _ref_moe_params(ref_cfg, seed=1)
    xj, _ = _x(ref_cfg, seed=2)
    _, logits = ref_layers.moe_apply(params, xj, ref_cfg)
    idx, gates, posn, keep, slot, counts = _ref_dispatch(logits, ref_cfg.moe)
    route = layers.moe_dispatch(to_tensor(np.asarray(logits)), cfg.moe)
    assert route.cap == ref_layers.moe_capacity(ref_cfg.moe, B * S)
    np.testing.assert_array_equal(route.idx.numpy(), idx)
    np.testing.assert_array_equal(route.posn.numpy(), posn)
    np.testing.assert_array_equal(route.keep.numpy(), keep)
    np.testing.assert_array_equal(route.slot.numpy(), slot)
    np.testing.assert_array_equal(route.rows.numpy(), np.minimum(counts, route.cap))
    assert route.rows.dtype == torch.int32
    np.testing.assert_allclose(route.gates.numpy(), gates, rtol=1e-6, atol=1e-7)
    dropped = int((~route.keep).sum())
    assert (dropped == 0) if cf == 2.0 else (dropped > 0)


def test_dispatch_breaks_ties_toward_the_lower_expert():
    """``jax.lax.top_k`` puts the lower index first on an exact tie; so does
    the port (equal logits give equal probabilities)."""
    m = dataclasses.replace(get_config("arctic-480b").reduced().moe, num_experts=8)
    ref_m = dataclasses.replace(ref_get_config("arctic-480b").reduced().moe, num_experts=8)
    logits = np.zeros((3, 8), np.float32)
    logits[1, [2, 5, 6]] = 1.0
    logits[2, [7, 3]] = 2.0
    route = layers.moe_dispatch(torch.from_numpy(logits), m)
    np.testing.assert_array_equal(route.idx.numpy(), _ref_dispatch(jnp.asarray(logits), ref_m)[0])
    assert route.idx.tolist() == [[0, 1], [2, 5], [3, 7]]


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_f32_matches_reference(arch, cf):
    ref_cfg, cfg = _cfgs(arch, cf, "float32")
    params = _ref_moe_params(ref_cfg, seed=3)
    xj, xt = _x(ref_cfg, seed=4)
    ref_out, ref_logits = ref_layers.moe_apply(params, xj, ref_cfg)
    with torch.inference_mode():
        out, logits = layers.moe_apply(params_from_reference(params), xt, cfg)
    assert out.dtype == torch.float32 and tuple(out.shape) == (B, S, cfg.d_model)
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_apply_bf16_matches_reference(arch, cf):
    ref_cfg, cfg = _cfgs(arch, cf)
    params = _ref_moe_params(ref_cfg, seed=5)
    xj, xt = _x(ref_cfg, seed=6)
    ref_out, ref_logits = ref_layers.moe_apply(params, xj, ref_cfg)
    with torch.inference_mode():
        out, logits = layers.moe_apply(params_from_reference(params), xt, cfg)
    assert out.dtype == torch.bfloat16
    ref_idx = _ref_dispatch(ref_logits, ref_cfg.moe)[0]
    idx = layers.moe_dispatch(logits, cfg.moe).idx.numpy()
    flipped = np.nonzero((np.sort(idx, axis=1) != np.sort(ref_idx, axis=1)).any(axis=1))[0]
    if len(flipped):
        probs = np.sort(np.asarray(jax.nn.softmax(ref_logits, axis=-1)), axis=1)[:, ::-1]
        k = cfg.moe.top_k
        margin = probs[flipped, k - 1] - probs[flipped, k]
        pytest.fail(f"{arch} cf {cf}: routing of tokens {flipped.tolist()} differs from the reference's; "
                    f"top-k margins {margin.tolist()}")
    ref_out = np.asarray(ref_out, np.float32)
    out = out.float().numpy()
    rms = float(np.sqrt(np.mean(ref_out ** 2)))
    np.testing.assert_allclose(out / rms, ref_out / rms, rtol=TOL, atol=TOL)
    ref32_cfg = dataclasses.replace(ref_cfg, dtype="float32")
    exact, _ = ref_layers.moe_apply(jax.tree.map(lambda a: np.asarray(a, np.float32), params),
                                    xj.astype(jnp.float32), ref32_cfg)
    exact = np.asarray(exact)
    assert np.abs(out - exact).max() <= 1.5 * np.abs(ref_out - exact).max()


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_init_moe_has_the_reference_leaves(arch):
    """Keys, shapes and dtypes of ``init_moe`` under a leading layer axis, as
    the reference's stacked layout holds them (the runtime's segments follow
    the leaf order)."""
    ref_cfg, cfg = ref_get_config(arch).reduced(), get_config(arch).reduced()
    ref = _ref_moe_params(ref_cfg, seed=0)
    ours = layers.init_moe(torch.Generator().manual_seed(0), cfg, (3,))

    def leaves(tree, prefix=""):
        for key in sorted(tree):
            if isinstance(tree[key], dict):
                yield from leaves(tree[key], f"{prefix}{key}/")
            else:
                yield f"{prefix}{key}", tree[key]

    want = [(p, (3, *a.shape), f"torch.{a.dtype.name}") for p, a in leaves(ref)]
    assert [(p, tuple(t.shape), str(t.dtype)) for p, t in leaves(ours)] == want
    assert ("dense/w1" in dict(leaves(ours))) == cfg.moe.dense_residual


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_expert_rows_past_the_count_hold_zeros(arch):
    """The dispatch buffer holds zeros past each expert's filled slots, so the
    batched product with ``rows`` gives the same bits as the full einsum,
    which is what the reference computes (at cf 0.5, where experts overflow,
    and at 2.0, where some are short)."""
    for cf in CAPACITY_FACTORS:
        ref_cfg, cfg = _cfgs(arch, cf, "float32")
        params = params_from_reference(_ref_moe_params(ref_cfg, seed=7))
        _, xt = _x(ref_cfg, seed=8)
        tokens = xt.reshape(-1, cfg.d_model)
        route = layers.moe_dispatch(tokens @ params["router"], cfg.moe)
        e, cap = cfg.moe.num_experts, route.cap
        buf = torch.zeros((e * cap, cfg.d_model))
        buf.index_add_(0, route.slot, torch.where(route.keep[:, None], tokens.repeat(cfg.moe.top_k, 1), 0))
        expert_in = buf.view(e, cap, -1)
        live = torch.arange(cap) < route.rows[:, None].long()
        assert not expert_in[~live].any()
        full = stream_matmul_ref(expert_in, params["w1"], torch.float32)
        assert torch.equal(stream_matmul_ref(expert_in, params["w1"], torch.float32, rows=route.rows), full)


ROWS_CASES = {
    "none": None,
    "empty, partial, full": [0, 3, 7, 7],
    "all empty": [0, 0, 0, 0],
    "past the capacity and negative": [9, -1, 2, 100],
}


@pytest.mark.parametrize("case", sorted(ROWS_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stream_matmul_ref_batched_against_a_loop(case, dtype):
    """The batched plain version is ``x[e] @ w[e]`` for every expert; rows at
    or past ``rows[e]`` (clamped to [0, C]) come out exactly 0 and are not
    read: NaN there changes nothing."""
    rng = np.random.default_rng(11)
    e, c, k, n = 4, 7, 24, 40
    x = torch.from_numpy(rng.standard_normal((e, c, k), np.float32)).to(dtype)
    w = torch.from_numpy(rng.standard_normal((e, k, n), np.float32) / k ** 0.5).to(dtype)
    rows = ROWS_CASES[case]
    counts = [c] * e if rows is None else [min(max(r, 0), c) for r in rows]
    for i, r in enumerate(counts):
        x[i, r:] = float("nan")
    rows_t = None if rows is None else torch.tensor(rows, dtype=torch.int32)
    out = stream_matmul_ref(x, w, torch.float32, rows=rows_t)
    assert out.shape == (e, c, n) and out.dtype == torch.float32
    for i, r in enumerate(counts):
        want = x[i, :r].float() @ w[i].float()
        assert torch.equal(out[i, :r], want)
        assert torch.equal(out[i, r:], torch.zeros((c - r, n)))
        assert not out[i, r:].signbit().any()  # +0, as the kernel stores
    assert torch.equal(mm_ops.stream_matmul(x, w, out_dtype=torch.float32, rows=rows_t), out)


def test_stream_matmul_batched_on_the_cpu_counts_no_launch():
    x = torch.ones((2, 3, 8))
    w = torch.ones((2, 8, 5))
    before = (mm_ops.stream_matmul.launches, mm_ops.stream_matmul.batched_launches)
    out = mm_ops.stream_matmul(x, w, out_dtype=torch.float32)
    assert torch.equal(out, torch.full((2, 3, 5), 8.0))
    assert (mm_ops.stream_matmul.launches, mm_ops.stream_matmul.batched_launches) == before


def _raises_cases():
    x = torch.zeros((4, 3, 16), dtype=torch.bfloat16)
    w = torch.zeros((4, 16, 8), dtype=torch.bfloat16)
    rows = torch.zeros(4, dtype=torch.int32)
    return {
        "mismatched experts": ((x, torch.zeros((3, 16, 8), dtype=torch.bfloat16)), {}, ValueError),
        "mismatched K": ((x, torch.zeros((4, 12, 8), dtype=torch.bfloat16)), {}, ValueError),
        "2-D w": ((x, w[0]), {}, ValueError),
        "non-contiguous expert slice": ((x, torch.zeros((8, 16, 8), dtype=torch.bfloat16)[::2]), {}, ValueError),
        "transposed experts": ((x, torch.zeros((4, 8, 16), dtype=torch.bfloat16).transpose(1, 2)), {}, ValueError),
        "K-major": ((x, w), {"w_layout": "nk"}, ValueError),
        "mixed dtypes": ((x.float(), w), {}, TypeError),
        "rows int64": ((x, w), {"rows": rows.long()}, TypeError),
        "rows of another length": ((x, w), {"rows": rows[:3]}, ValueError),
        "rows on another device": ((x, w), {"rows": torch.zeros(4, dtype=torch.int32, device="meta")}, ValueError),
        "rows on a 2-D product": ((x[0], w[0]), {"rows": rows}, ValueError),
    }


@pytest.mark.parametrize("case", sorted(_raises_cases()))
def test_stream_matmul_batched_raises(case):
    """The batched form's checks run on both devices."""
    args, kw, err = _raises_cases()[case]
    with pytest.raises(err):
        mm_ops.stream_matmul(*args, **kw)


@pytest.mark.parametrize("experts,n,want", [(1, 2048, 66), (8, 6144, 3), (8, 32768, 1), (128, 4864, 1)])
def test_k_splits_counts_every_expert(experts, n, want):
    """The gemv split rule over all of a batched call's column slabs, at 132
    SMs: grok's w2 (N = 6144) still splits K, its w1/w3 and arctic's do not."""
    assert mm_ops.k_splits(2, n, 6144, 132, experts=experts) == want


# -- the bf16 model path, up to near-tied routings ------------------------------

NEAR_TIE = 1e-2  # gate margin (k-th minus (k+1)-th probability) that bf16 rounding may cross
DECODE_TOL = 8e-2  # the reference's own decode-vs-forward tolerance


def _recorded(monkeypatch, calls):
    """Makes the port's model record every MoE layer's router logits."""
    real = model_mod.moe_apply

    def record(p, h, cfg):
        out, logits = real(p, h, cfg)
        calls.append(logits.reshape(h.shape[0], h.shape[1], -1))
        return out, logits

    monkeypatch.setattr(model_mod, "moe_apply", record)


def _top_k_set(logits, k):
    return torch.sort(torch.topk(logits, k, dim=-1).indices, dim=-1).values


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_bf16_decode_matches_forward_up_to_near_ties(arch, monkeypatch):
    """In bf16, prefill and four decode steps against one forward over the
    same tokens, on the reference's parameters: where every layer routes a
    position as the forward does, its logits agree within the reference's
    8e-2; where a layer routes it otherwise (the decode attention rounds its
    probabilities in f32, the forward's in bf16), the forward's gate margin
    there is below NEAR_TIE, a tie that rounding may break either way. The
    flips are counted, not hidden: seed 7 had one, at decode step 0, while
    the CPU ``attend`` rounded q * scale to bf16; since it computes the
    scores in f32 as the reference does, there is none."""
    cfg = get_config(arch).reduced()
    ref_cfg = ref_get_config(arch).reduced()
    params = params_from_reference(jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(7))))
    fns = model_mod.build_model(cfg)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(1, cfg.vocab_size, (2, 68)))
    fwd_calls, run_calls = [], []
    L, k = cfg.num_layers, cfg.moe.top_k
    with torch.inference_mode():
        _recorded(monkeypatch, fwd_calls)
        ref = fns.forward(params, {"tokens": tokens}).float()
        monkeypatch.undo()
        _recorded(monkeypatch, run_calls)
        logits, cache = fns.prefill(params, {"tokens": tokens[:, :64]}, max_seq=72)
        outs = [logits]
        for i in range(4):
            logits, cache = fns.decode_step(params, cache, {"tokens": tokens[:, 64 + i : 65 + i]})
            outs.append(logits)
    got = torch.cat(outs, dim=1).float()  # positions 63..67
    # each layer's routing over all 68 positions, as the prefill + decode run saw it
    run_logits = [torch.cat([run_calls[l]] + [run_calls[L * (1 + i) + l] for i in range(4)], dim=1) for l in range(L)]
    flipped, margins = set(), []
    for l in range(L):
        differs = (_top_k_set(run_logits[l], k) != _top_k_set(fwd_calls[l], k)).any(-1)
        probs = torch.sort(torch.softmax(fwd_calls[l], -1), dim=-1, descending=True).values
        for b, s in differs.nonzero().tolist():
            if (b, s) not in flipped:  # the first layer that routes it otherwise
                margins.append(float(probs[b, s, k - 1] - probs[b, s, k]))
                flipped.add((b, s))
    assert all(m < NEAR_TIE for m in margins), f"{arch}: routing differs beyond a near-tie: margins {margins}"
    assert flipped == set(), f"{arch}: positions routed otherwise: {sorted(flipped)}, margins {margins}"
    for b in range(2):
        for j, s in enumerate(range(63, 68)):
            if (b, s) not in flipped:
                np.testing.assert_allclose(got[b, j].numpy(), ref[b, s].numpy(), rtol=DECODE_TOL, atol=DECODE_TOL,
                                           err_msg=f"{arch}: row {b} position {s}")
