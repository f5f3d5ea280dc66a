"""The port's prefill and KV-cache decode against the JAX package's, on the
reference's own parameters and the same numpy tokens, for both dense archs
reduced. Tolerances: rtol = atol = 5e-2 for prefill logits and cache (the
reference's kernel-test tolerance: bf16 rounds at other places in the two
frameworks) and 8e-2 for decode logits, the reference's own for decode
against forward (tests/models/test_cache_consistency.py): the port's decode
attention keeps probabilities in f32 where the reference's ``attend`` rounds
them to bf16."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_prefill_step, make_serve_step  # noqa: E402
from repro_torch.models import layers  # noqa: E402
from repro_torch.models.convert import cache_from_reference, params_from_reference  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DENSE = ["qwen3-1.7b", "llama3.2-3b"]
TOL = 5e-2
DECODE_TOL = 8e-2
B = 2
S = 68  # prefill 64, decode 4 more, as the reference's cache test
SMAX = S + 8


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol)


def _setup(arch, seed=7):
    """Reference fns and params (numpy), the port's fns and params, tokens."""
    ref_fns = ref_build_model(ref_get_config(arch).reduced())
    ref_params = jax.tree.map(np.asarray, ref_fns.init(jax.random.PRNGKey(seed)))
    fns = build_model(get_config(arch).reduced())
    tokens = np.random.default_rng(seed).integers(1, fns.cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_fns, ref_params, fns, params_from_reference(ref_params), tokens


def _t(tokens):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).long()}


def _j(tokens):
    return {"tokens": jnp.asarray(tokens)}


@pytest.mark.parametrize("arch", DENSE)
def test_init_cache_matches_reference(arch):
    ref = ref_build_model(ref_get_config(arch).reduced()).init_cache(B, SMAX)
    ours = build_model(get_config(arch).reduced()).init_cache(B, SMAX, device="cpu")
    # the port's cache is the reference's plus the position as a host int
    assert sorted(ref) == ["index", "k", "v"]
    assert sorted(ours) == ["host_index", "index", "k", "v"] and ours["host_index"] == 0
    for key in ref:
        assert tuple(ours[key].shape) == ref[key].shape
        assert str(ours[key].dtype) == f"torch.{ref[key].dtype.name}"
        assert not ours[key].any()


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_matches_reference(arch):
    ref_fns, ref_params, fns, params, tokens = _setup(arch)
    ref_logits, ref_cache = ref_fns.prefill(ref_params, _j(tokens[:, :64]), max_seq=SMAX)
    with torch.inference_mode():
        logits, cache = fns.prefill(params, _t(tokens[:, :64]), max_seq=SMAX)
    assert logits.shape == ref_logits.shape == (B, 1, fns.cfg.vocab_size)
    _close(logits, ref_logits)
    assert cache["index"].dtype == torch.int32 and cache["index"].dim() == 0
    assert int(cache["index"]) == cache["host_index"] == int(ref_cache["index"]) == 64
    for key in ("k", "v"):
        assert tuple(cache[key].shape) == ref_cache[key].shape
        _close(cache[key], ref_cache[key])
        assert not cache[key][:, :, 64:].any()


@pytest.mark.parametrize("arch", DENSE)
def test_decode_steps_match_reference(arch):
    """Four decode steps from the reference's own prefill cache."""
    ref_fns, ref_params, fns, params, tokens = _setup(arch)
    _, ref_cache = ref_fns.prefill(ref_params, _j(tokens[:, :64]), max_seq=SMAX)
    cache = cache_from_reference(jax.tree.map(np.asarray, ref_cache))
    for i in range(4):
        tok = tokens[:, 64 + i : 65 + i]
        ref_logits, ref_cache = ref_fns.decode_step(ref_params, ref_cache, _j(tok))
        with torch.inference_mode():
            logits, cache = fns.decode_step(params, cache, _t(tok))
        assert logits.shape == ref_logits.shape == (B, 1, fns.cfg.vocab_size)
        _close(logits, ref_logits, DECODE_TOL)
    assert int(cache["index"]) == cache["host_index"] == int(ref_cache["index"]) == S
    for key in ("k", "v"):
        _close(cache[key], ref_cache[key])


@pytest.mark.parametrize("arch", DENSE)
def test_decode_matches_forward(arch):
    """The port's copy of the reference's test_decode_matches_forward: the
    prefill's last logits and four decode steps reproduce the forward pass."""
    _, _, fns, params, tokens = _setup(arch)
    with torch.inference_mode():
        ref_logits = fns.forward(params, _t(tokens)).float()
        logits, cache = fns.prefill(params, _t(tokens[:, : S - 4]), max_seq=SMAX)
        _close(logits[:, 0], ref_logits[:, S - 5], DECODE_TOL)
        for i in range(4):
            logits, cache = fns.decode_step(params, cache, _t(tokens[:, S - 4 + i][:, None]))
            _close(logits[:, 0], ref_logits[:, S - 4 + i], DECODE_TOL)


@pytest.mark.parametrize("arch", DENSE)
def test_steps_match_functions(arch):
    _, _, fns, params, tokens = _setup(arch)
    cfg = fns.cfg
    with torch.inference_mode():
        logits, cache = fns.prefill(params, _t(tokens[:, :64]), max_seq=SMAX)
        step_logits, step_cache = make_prefill_step(cfg)(params, _t(tokens[:, :64]), max_seq=SMAX)
        assert torch.equal(logits, step_logits)
        for key in ("k", "v", "index"):
            assert torch.equal(cache[key], step_cache[key])
        assert cache["host_index"] == step_cache["host_index"] == 64
        tok = _t(tokens[:, 64:65])
        logits, cache = fns.decode_step(params, cache, tok)
        step_logits, step_cache = make_serve_step(cfg)(params, step_cache, tok)
        assert torch.equal(logits, step_logits)
        for key in ("k", "v", "index"):
            assert torch.equal(cache[key], step_cache[key])
        assert cache["host_index"] == step_cache["host_index"] == 65


def test_prefill_without_max_seq_sizes_cache_to_prompt():
    _, _, fns, params, tokens = _setup("qwen3-1.7b")
    with torch.inference_mode():
        _, cache = fns.prefill(params, _t(tokens[:, :10]))
    assert cache["k"].shape[2] == 10 and int(cache["index"]) == cache["host_index"] == 10


@pytest.mark.parametrize("arch", DENSE)
def test_decode_at_smax_raises(arch):
    """The reference clamps the write at index == Smax (dynamic_update_slice)
    and overwrites the last slot; the port raises before it writes. The last
    slot itself is still written."""
    _, _, fns, params, tokens = _setup(arch)
    with torch.inference_mode():
        _, cache = fns.prefill(params, _t(tokens[:, :8]), max_seq=9)
        _, cache = fns.decode_step(params, cache, _t(tokens[:, 8:9]))
        assert int(cache["index"]) == cache["host_index"] == 9 and cache["k"][:, :, 8].any()
        k = cache["k"].clone()
        with pytest.raises(IndexError, match="out of bounds"):
            fns.decode_step(params, cache, _t(tokens[:, 9:10]))
        assert torch.equal(cache["k"], k) and int(cache["index"]) == 9


def test_attention_decode_takes_a_step_s_pages():
    """``decode_step`` builds the page view once a step and hands it to every
    layer: the same output as each layer building its own."""
    cfg = get_config("llama3.2-3b").reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(0))
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = torch.randn((2, 1, cfg.d_model), generator=torch.Generator().manual_seed(1)).bfloat16()
    outs = []
    for shared in (False, True):
        cache = fns.init_cache(2, 12, device="cpu")
        cache["k"].normal_(generator=torch.Generator().manual_seed(2))
        cache["v"].normal_(generator=torch.Generator().manual_seed(3))
        index = torch.tensor(5, dtype=torch.int32)
        pages = layers.kv_pages(index, 2, 12) if shared else None
        out, _ = layers.attention_decode(
            lp, x, cfg, k_cache=cache["k"][0], v_cache=cache["v"][0],
            index=index, positions=index.expand(2, 1), pages=pages,
        )
        outs.append(out)
    slot, table, lengths = layers.kv_pages(index, 2, 12)
    assert slot.tolist() == [5] and lengths.tolist() == [6, 6]
    assert table.tolist() == [[0, 1, 2], [3, 4, 5]] and table.dtype == lengths.dtype == torch.int32
    assert torch.equal(outs[0], outs[1])


@pytest.mark.parametrize("kw", [{"ring": True}, {"window": 16}])
def test_ring_and_window_caches_are_not_ported(kw):
    cfg = get_config("qwen3-1.7b").reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(0))
    cache = fns.init_cache(1, 8, device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = torch.zeros((1, 1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        layers.attention_decode(
            lp, x, cfg, k_cache=cache["k"][0], v_cache=cache["v"][0],
            index=cache["index"], positions=cache["index"].expand(1, 1), **kw,
        )


@pytest.mark.parametrize("smax,pt", [(1088, 64), (76, 4), (68, 4), (64, 64), (96, 32), (7, 1), (128, 64)])
def test_kv_page_tokens(smax, pt):
    assert layers.kv_page_tokens(smax) == pt


def test_init_cache_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("qwen3-1.7b").reduced()).init_cache(1, 8)
