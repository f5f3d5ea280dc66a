"""The port's SSM family (mamba2-1.3b, reduced) against the JAX package's, on
the reference's own parameters and the same numpy tokens: forward, prefill
and its cache, decode steps, and decode against forward. Tolerances:
rtol = atol = 5e-2 against the reference (its kernel-test tolerance: bf16
rounds at other places in the two frameworks) and 8e-2 for decode against
forward, the reference's own (tests/models/test_cache_consistency.py)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.runtime import flatten  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.convert import cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

ARCH = "mamba2-1.3b"
TOL = 5e-2
DECODE_TOL = 8e-2
B = 2
CACHE_KEYS = ["conv", "index", "state"]


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol)


@pytest.fixture(scope="module")
def setup():
    """Reference fns and params (numpy), the port's fns and params, tokens."""
    ref_fns = ref_build_model(ref_get_config(ARCH).reduced())
    ref_params = jax.tree.map(np.asarray, ref_fns.init(jax.random.PRNGKey(3)))
    fns = build_model(get_config(ARCH).reduced())
    tokens = np.random.default_rng(3).integers(1, fns.cfg.vocab_size, (B, 72)).astype(np.int32)
    return ref_fns, ref_params, fns, params_from_reference(ref_params), tokens


def _t(tokens):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).long()}


def _j(tokens):
    return {"tokens": jnp.asarray(tokens)}


def test_init_tree_matches_reference():
    cfg = get_config(ARCH).reduced()
    ref = ref_build_model(ref_get_config(ARCH).reduced()).init(jax.random.PRNGKey(0))
    ref_leaves = [
        ("/".join(k.key for k in path), leaf.shape, leaf.dtype.name)
        for path, leaf in jax.tree_util.tree_flatten_with_path(ref)[0]
    ]
    ours = build_model(cfg).init(torch.Generator().manual_seed(0))
    assert [(p, tuple(t.shape), str(t.dtype).removeprefix("torch.")) for p, t in flatten(ours)] == ref_leaves
    assert len(ref_leaves) == 12
    assert ours["layers"]["mixer"]["in_proj"].shape[0] == cfg.num_layers


def test_dims_and_split_match_reference():
    from repro.models import ssm as ref_ssm

    cfg = get_config(ARCH).reduced()
    assert ssm.dims(cfg) == ref_ssm.dims(ref_get_config(ARCH).reduced())
    d_inner, n_heads, conv_dim = ssm.dims(cfg)
    proj = torch.arange(2 * d_inner + 2 * cfg.ssm.state_dim + n_heads).float()[None]
    z, xbc, dt = ssm._split_proj(proj, cfg)
    rz, rxbc, rdt = ref_ssm._split_proj(jnp.asarray(proj.numpy()), ref_get_config(ARCH).reduced())
    for a, b in ((z, rz), (xbc, rxbc), (dt, rdt)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_causal_conv_matches_reference():
    from repro.models import ssm as ref_ssm

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 9, 24), np.float32)
    w = rng.standard_normal((4, 24), np.float32)
    b = rng.standard_normal(24).astype(np.float32)
    ours = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b)))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref_ssm._causal_conv(x, w, b)), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seq", [1, 5, 32, 64])
def test_forward_logits_match_reference(setup, seq):
    """S = 1 and 5 pad inside one chunk (32), 32 is one chunk, 64 two."""
    ref_fns, ref_params, fns, params, tokens = setup
    ref = ref_fns.forward(ref_params, _j(tokens[:, :seq]))
    with torch.inference_mode():
        ours = fns.forward(params, _t(tokens[:, :seq]))
    assert ours.shape == ref.shape == (B, seq, fns.cfg.vocab_size) and ours.dtype == torch.bfloat16
    _close(ours, ref)


def test_init_cache_matches_reference():
    ref = ref_build_model(ref_get_config(ARCH).reduced()).init_cache(B, 16)
    ours = build_model(get_config(ARCH).reduced()).init_cache(B, 16, device="cpu")
    assert sorted(ref) == CACHE_KEYS and sorted(ours) == sorted(CACHE_KEYS + ["host_index"])
    assert ours["host_index"] == 0
    for key in ref:
        assert tuple(ours[key].shape) == ref[key].shape
        assert str(ours[key].dtype) == f"torch.{ref[key].dtype.name}"
        assert not ours[key].any()


@pytest.mark.parametrize("seq", [3, 40, 64])
def test_prefill_matches_reference(setup, seq):
    ref_fns, ref_params, fns, params, tokens = setup
    ref_logits, ref_cache = ref_fns.prefill(ref_params, _j(tokens[:, :seq]))
    with torch.inference_mode():
        logits, cache = fns.prefill(params, _t(tokens[:, :seq]))
    assert logits.shape == ref_logits.shape == (B, 1, fns.cfg.vocab_size)
    _close(logits, ref_logits)
    assert cache["index"].dtype == torch.int32 and cache["index"].dim() == 0
    assert int(cache["index"]) == cache["host_index"] == int(ref_cache["index"]) == seq
    for key in ("state", "conv"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        assert str(cache[key].dtype) == f"torch.{ref_cache[key].dtype.name}"
        _close(cache[key], ref_cache[key])


def test_decode_steps_match_reference(setup):
    """Four decode steps from the reference's own prefill cache."""
    ref_fns, ref_params, fns, params, tokens = setup
    _, ref_cache = ref_fns.prefill(ref_params, _j(tokens[:, :40]))
    cache = cache_from_reference(jax.tree.map(np.asarray, ref_cache))
    assert sorted(cache) == sorted(CACHE_KEYS + ["host_index"]) and cache["host_index"] == 40
    for i in range(4):
        tok = tokens[:, 40 + i : 41 + i]
        ref_logits, ref_cache = ref_fns.decode_step(ref_params, ref_cache, _j(tok))
        with torch.inference_mode():
            logits, cache = fns.decode_step(params, cache, _t(tok))
        assert logits.shape == ref_logits.shape == (B, 1, fns.cfg.vocab_size)
        _close(logits, ref_logits)
    assert int(cache["index"]) == cache["host_index"] == int(ref_cache["index"]) == 44
    for key in ("state", "conv"):
        _close(cache[key], ref_cache[key])


@pytest.mark.parametrize("prompt", [3, 32, 60])
def test_decode_matches_forward(setup, prompt):
    """The prefill's last logits and four decode steps reproduce the forward
    pass over the same tokens (the port's copy of the reference's
    test_decode_matches_forward, for the SSM family)."""
    _, _, fns, params, tokens = setup
    n = prompt + 4
    with torch.inference_mode():
        ref_logits = fns.forward(params, _t(tokens[:, :n])).float()
        logits, cache = fns.prefill(params, _t(tokens[:, :prompt]))
        _close(logits[:, 0], ref_logits[:, prompt - 1], DECODE_TOL)
        for i in range(4):
            logits, cache = fns.decode_step(params, cache, _t(tokens[:, prompt + i][:, None]))
            _close(logits[:, 0], ref_logits[:, prompt + i], DECODE_TOL)


def test_decode_updates_the_cache_in_place(setup):
    _, _, fns, params, tokens = setup
    with torch.inference_mode():
        _, cache = fns.prefill(params, _t(tokens[:, :8]))
        state, conv = cache["state"].clone(), cache["conv"].clone()
        _, new = fns.decode_step(params, cache, _t(tokens[:, 8:9]))
    assert new["state"] is cache["state"] and new["conv"] is cache["conv"]
    assert not torch.equal(cache["state"], state) and not torch.equal(cache["conv"], conv)
    # the conv history shifted by one token
    assert torch.equal(cache["conv"][:, :, :-1], conv[:, :, 1:])
    assert int(new["index"]) == new["host_index"] == 9 and cache["host_index"] == 8


@pytest.mark.parametrize("seq", [1, 2])
def test_prefill_shorter_than_the_conv_tail_raises(setup, seq):
    """The reference keeps a conv tail of ``seq`` rows there, which its own
    decode_step cannot read; the port raises at prefill."""
    _, _, fns, params, tokens = setup
    with pytest.raises(ValueError, match="at least 3 tokens"):
        fns.prefill(params, _t(tokens[:, :seq]))


def test_steps_match_functions(setup):
    _, _, fns, params, tokens = setup
    cfg = fns.cfg
    with torch.inference_mode():
        logits, cache = fns.prefill(params, _t(tokens[:, :40]))
        step_logits, step_cache = make_prefill_step(cfg)(params, _t(tokens[:, :40]))
        assert torch.equal(logits, step_logits)
        for key in ("state", "conv", "index"):
            assert torch.equal(cache[key], step_cache[key])
        tok = _t(tokens[:, 40:41])
        logits, cache = fns.decode_step(params, cache, tok)
        step_logits, step_cache = make_serve_step(cfg)(params, step_cache, tok)
        assert torch.equal(logits, step_logits)
        for key in ("state", "conv", "index"):
            assert torch.equal(cache[key], step_cache[key])
        assert cache["host_index"] == step_cache["host_index"] == 41


def test_init_cache_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config(ARCH).reduced()).init_cache(B, 16)
