"""The MoE layer's training path against the JAX package, on the CPU: the
plain gradients of ``stream_matmul``'s expert-batched form (dX with rows
past ``rows[e]`` exactly 0, dW over the filled rows only) against
``jax.vjp`` of the reference's ``einsum("ecd,edf->ecf")`` with those rows
masked; the ``x_layout="km"`` form they take and its route rule;
``moe_apply``'s gradients at the reduced grok-1-314b and arctic-480b against
``jax.value_and_grad`` of the reference's ``moe_apply``; and the train
step's clip norm and Adafactor, which walk a leaf of three or more axes one
slice at a time, against the reference's and against the whole-leaf update.

Inputs are drawn with numpy from a seed and given to both packages.
Tolerances: the plain gradients are the same f32 products as the
reference's, summed in another order (1e-5). ``moe_apply``'s gradients in
f32 within relative L2 1e-4 a leaf: the same function with sums in another
order, while one misrouted or dropped assignment moves a gradient by order
1. The optimizer and the clip norm within 1e-6, the reference's optimizer
tolerance (``tests/test_torch_train_optim.py``): slicing changes only the
order of the two sums over the whole leaf.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.optim import optimizers as ref_optimizers  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.streammm import ops as mm_ops  # noqa: E402
from repro_torch.kernels.streammm.ref import stream_matmul_batched_grads_ref  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_numpy, to_tensor  # noqa: E402
from repro_torch.optim import optimizers  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402

GRAD_TOL = 1e-5
MOE_REL_L2 = 1e-4
OPT_TOL = 1e-6

# (E, C, K, N, rows): full, partly filled and empty experts; counts past C
# (clamped); no rows at all
BATCHED_CASES = [
    (4, 6, 16, 12, (6, 3, 0, 1)),
    (3, 5, 7, 9, (9, 0, 2)),
    (2, 4, 8, 8, None),
    (5, 1, 24, 40, (1, 0, 1, 0, 1)),
]


def _batched_inputs(e, c, k, n, seed):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32) for shape in ((e, c, k), (e, k, n), (e, c, n)))


def _rows_tensor(rows):
    return None if rows is None else torch.tensor(rows, dtype=torch.int32)


@pytest.mark.parametrize("e,c,k,n,rows", BATCHED_CASES)
def test_plain_batched_gradients_match_jax_vjp(e, c, k, n, rows):
    """dy holds noise past rows[e] too: the reference's masked product passes
    none of it back, and neither do the plain gradients."""
    x, w, dy = _batched_inputs(e, c, k, n, seed=e * 100 + c)
    live = np.ones((e, c, 1), bool) if rows is None else (np.arange(c)[None, :] < np.asarray(rows)[:, None])[..., None]

    def ref(xj, wj):
        return jnp.where(live, jnp.einsum("ecd,edf->ecf", xj, wj), 0.0)

    _, vjp = jax.vjp(ref, jnp.asarray(x), jnp.asarray(w))
    want_x, want_w = (np.asarray(a) for a in vjp(jnp.asarray(dy)))
    dx, dw = stream_matmul_batched_grads_ref(to_tensor(x), to_tensor(w), to_tensor(dy), _rows_tensor(rows))
    assert dx.dtype == dw.dtype == torch.float32
    np.testing.assert_allclose(dx.numpy(), want_x, rtol=GRAD_TOL, atol=GRAD_TOL)
    np.testing.assert_allclose(dw.numpy(), want_w, rtol=GRAD_TOL, atol=GRAD_TOL)
    if rows is not None:
        for i, r in enumerate(rows):
            assert not dx[i, min(r, c):].any(), "dX rows past rows[e] must be exactly 0"
            if r == 0:
                assert not dw[i].any(), "an empty expert's dW must be exactly 0"


@pytest.mark.parametrize("e,c,k,n,rows", BATCHED_CASES)
def test_autograd_through_the_cpu_form_gives_the_plain_gradients(e, c, k, n, rows):
    """On the CPU the wrapper is the plain version, which autograd
    differentiates: the same numbers as the plain gradients."""
    x, w, dy = (to_tensor(a) for a in _batched_inputs(e, c, k, n, seed=7 + e))
    xg, wg = x.clone().requires_grad_(), w.clone().requires_grad_()
    y = mm_ops.stream_matmul(xg, wg, out_dtype=torch.float32, rows=_rows_tensor(rows))
    got = torch.autograd.grad(y, (xg, wg), dy)
    want = stream_matmul_batched_grads_ref(x, w, dy, _rows_tensor(rows))
    for g, wnt in zip(got, want):
        torch.testing.assert_close(g, wnt, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("batched", [False, True])
def test_x_given_as_k_by_m(batched):
    """``x_layout="km"``: x.T @ w with x read as (K, M); with rows, the sum
    runs over the filled rows of both operands only, whatever the others
    hold (NaN here)."""
    rng = np.random.default_rng(11)
    if not batched:
        x, w = rng.standard_normal((6, 5)).astype(np.float32), rng.standard_normal((6, 3)).astype(np.float32)
        got = mm_ops.stream_matmul(to_tensor(x), to_tensor(w), out_dtype=torch.float32, x_layout="km")
        np.testing.assert_allclose(got.numpy(), x.T @ w, rtol=GRAD_TOL, atol=GRAD_TOL)
        return
    x, w = rng.standard_normal((3, 6, 5)).astype(np.float32), rng.standard_normal((3, 6, 4)).astype(np.float32)
    rows = (6, 2, 0)
    xn, wn = x.copy(), w.copy()
    for i, r in enumerate(rows):
        xn[i, r:], wn[i, r:] = np.nan, np.nan
    got = mm_ops.stream_matmul(to_tensor(xn), to_tensor(wn), out_dtype=torch.float32, rows=_rows_tensor(rows),
                               x_layout="km")
    want = np.stack([x[i, :r].T @ w[i, :r] for i, r in enumerate(rows)])
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_TOL, atol=GRAD_TOL)


@pytest.mark.parametrize("m,n,k,dtype,route", [
    (7168, 4864, 80, "bfloat16", "wgmma"),  # arctic's dW at 4 x 1024 tokens
    (6144, 32768, 1280, "bfloat16", "wgmma"),  # grok's
    (7168, 4864, 2, "bfloat16", "simt"),  # a capacity of 2: k % 8
    (7168, 4864, 80, "float32", "simt"),
    (4, 64, 64, "bfloat16", "simt"),  # never gemv: its rows are the sum's terms
    (100, 64, 64, "bfloat16", "simt"),  # rows of x TMA cannot stride
])
def test_mm_route_of_an_x_given_as_k_by_m(m, n, k, dtype, route):
    assert mm_ops.mm_route(m, n, k, getattr(torch, dtype), True, x_layout="km") == route


def test_gradient_forms_the_wrapper_refuses():
    x = torch.zeros((2, 4, 8))
    with pytest.raises(ValueError, match="takes \\(K, N\\) weights only"):
        mm_ops.stream_matmul(x, torch.zeros((2, 8, 8)), w_layout="nk", x_layout="km")
    with pytest.raises(ValueError, match="expert shapes"):
        mm_ops.stream_matmul(x, torch.zeros((2, 5, 8)), x_layout="km")


def _moe_cfgs(arch, cf):
    out = []
    for cfg in (ref_get_config(arch).reduced(), get_config(arch).reduced()):
        out.append(dataclasses.replace(cfg, dtype="float32", moe=dataclasses.replace(cfg.moe, capacity_factor=cf)))
    return out


@pytest.mark.parametrize("cf", [2.0, 0.5])
@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_moe_apply_gradients_match_reference(arch, cf):
    """The gradients of sum(out * R1) + sum(router_logits * R2) with respect
    to every leaf of the layer and to x; at capacity factor 0.5 about half
    the assignments drop."""
    ref_cfg, cfg = _moe_cfgs(arch, cf)
    params = jax.tree.map(np.asarray, ref_layers.init_moe(jax.random.PRNGKey(5), ref_cfg))
    rng = np.random.default_rng(6)
    b, s, d, e = 2, 12, cfg.d_model, cfg.moe.num_experts
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    r1 = rng.standard_normal((b, s, d)).astype(np.float32)
    r2 = rng.standard_normal((b * s, e)).astype(np.float32)

    def ref_loss(p, xj):
        out, logits = ref_layers.moe_apply(p, xj, ref_cfg)
        return jnp.sum(out * r1) + jnp.sum(logits * r2)

    ref_val, (ref_gp, ref_gx) = jax.value_and_grad(ref_loss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    port = params_from_reference(params)
    flat = [t.clone().requires_grad_() for t in leaves(port)]
    xt = to_tensor(x).requires_grad_()
    tree = dict(zip([p for p, _ in flatten(port)], flat))
    out, logits = layers.moe_apply(_unflatten(port, tree), xt, cfg)
    val = (out * to_tensor(r1)).sum() + (logits * to_tensor(r2)).sum()
    grads = torch.autograd.grad(val, [*flat, xt])
    np.testing.assert_allclose(float(val.detach()), float(ref_val), rtol=MOE_REL_L2)
    want = dict(flatten(jax.tree.map(np.asarray, ref_gp)))
    for (path, _), g in zip(flatten(port), grads[:-1]):
        w = want[path]
        assert np.linalg.norm(g.numpy() - w) <= MOE_REL_L2 * np.linalg.norm(w), path
    gx = grads[-1].numpy()
    assert np.linalg.norm(gx - np.asarray(ref_gx)) <= MOE_REL_L2 * np.linalg.norm(np.asarray(ref_gx))


def _unflatten(like, by_path, prefix=""):
    return {k: _unflatten(v, by_path, f"{prefix}{k}/") if isinstance(v, dict) else by_path[f"{prefix}{k}"]
            for k, v in like.items()}


def _opt_tree(seed):
    """Leaves of 1, 2, 3 and 4 axes: the 4-axis one spans 6 (K, N) slices."""
    rng = np.random.default_rng(seed)
    return {"norm": rng.standard_normal(5).astype(np.float32),
            "embed": rng.standard_normal((6, 5)).astype(np.float32),
            "layers": {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
                       "experts": (3.0 * rng.standard_normal((2, 3, 4, 6))).astype(np.float32)}}


def _port(t):
    return {k: _port(v) if isinstance(v, dict) else to_tensor(np.asarray(v)) for k, v in t.items()}


def _whole_leaf_adafactor(p, g, s, beta, lr, eps=1e-30, clip_threshold=1.0, weight_decay=0.0):
    """The update of one factored leaf as one tensor (the slices' update
    before it walked them): the yardstick of the sliced one."""
    g = g.float()
    g2 = g * g + eps
    s["vr"].copy_(beta * s["vr"] + (1 - beta) * g2.mean(dim=-1))
    s["vc"].copy_(beta * s["vc"] + (1 - beta) * g2.mean(dim=-2))
    rfac = torch.rsqrt(s["vr"] / s["vr"].mean(dim=-1, keepdim=True) + eps)
    cfac = torch.rsqrt(s["vc"] + eps)
    u = g * rfac[..., None] * cfac[..., None, :]
    rms = torch.sqrt((u * u).mean() + eps)
    u = u / torch.clamp(rms / clip_threshold, min=1.0)
    newp = p.float() - lr * u
    if weight_decay:
        newp = newp - lr * weight_decay * p.float()
    p.copy_(newp)


@pytest.mark.parametrize("weight_decay", [0.0, 0.01])
def test_sliced_adafactor_matches_reference(weight_decay):
    ref_opt = ref_optimizers.adafactor(weight_decay=weight_decay)
    opt = optimizers.adafactor(weight_decay=weight_decay)
    ref_params = jax.tree.map(jnp.asarray, _opt_tree(0))
    params = _port(_opt_tree(0))
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for i in range(3):
        grads = _opt_tree(10 + i)
        lr = np.float32(1e-2 * (i + 1))
        ref_params, ref_state = ref_opt.update(jax.tree.map(jnp.asarray, grads), ref_state, ref_params, lr)
        params, state = opt.update(_port(grads), state, params, torch.tensor(lr))
    ours = dict(flatten({"params": params, "state": state}))
    ref = dict(flatten(jax.tree.map(np.asarray, {"params": ref_params, "state": ref_state})))
    assert list(ours) == list(ref)
    for path, t in ours.items():
        np.testing.assert_allclose(to_numpy(t).astype(np.float64), ref[path].astype(np.float64),
                                   rtol=OPT_TOL, atol=OPT_TOL, err_msg=path)


@pytest.mark.parametrize("shape", [(3, 4, 5), (2, 3, 4, 6), (5, 16, 8)])
def test_sliced_adafactor_matches_the_whole_leaf_update(shape):
    rng = np.random.default_rng(sum(shape))
    p0 = rng.standard_normal(shape).astype(np.float32)
    opt = optimizers.adafactor()
    p, q = to_tensor(p0), to_tensor(p0)
    state = opt.init({"w": p})
    s = {k: v.clone() for k, v in state["state"]["w"].items()}
    for i in range(3):
        g = to_tensor((4.0 * rng.standard_normal(shape)).astype(np.float32))
        lr = torch.tensor(np.float32(1e-2 * (i + 1)))
        opt.update({"w": g}, state, {"w": p}, lr)
        beta = 1.0 - torch.tensor(float(i + 1)) ** -0.8
        _whole_leaf_adafactor(q, g, s, beta, lr)
    torch.testing.assert_close(p, q, rtol=OPT_TOL, atol=OPT_TOL)
    for key in ("vr", "vc"):
        torch.testing.assert_close(state["state"]["w"][key], s[key], rtol=OPT_TOL, atol=OPT_TOL)


@pytest.mark.parametrize("shape", [(6, 5), (3, 4, 5), (2, 3, 40, 7)])
def test_sliced_clip_norm_matches_reference(shape):
    g = (np.random.default_rng(len(shape)).standard_normal(shape) * 3).astype(np.float32)
    want = float(jnp.sum(jnp.square(jnp.asarray(g).astype(jnp.float32))))
    got = steps._square_sum(to_tensor(g))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), want, rtol=OPT_TOL)
    np.testing.assert_allclose(float(got), float(to_tensor(g).square().sum()), rtol=OPT_TOL)
