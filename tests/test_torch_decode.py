"""The port's prefill and KV-cache decode against the JAX package's, on the
reference's own parameters and the same numpy tokens, for every dense arch
reduced (tied or not) and the two MoE archs, in f32 (``MOE`` below; at the
reduced capacity factor 2.0 no token drops, at prefill, decode or forward);
and the hybrid's ring cache (``ring=True``) layer by layer, across the wrap
(the hybrid's whole-model decode: tests/test_torch_hybrid.py). Tolerances: rtol = atol = 5e-2 for prefill logits and cache (the
reference's kernel-test tolerance: bf16 rounds at other places in the two
frameworks) and 8e-2 for decode logits, the reference's own for decode
against forward (tests/models/test_cache_consistency.py): the port's decode
attention keeps probabilities in f32 where the reference's ``attend`` rounds
them to bf16."""
import dataclasses

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

DENSE = ["qwen3-1.7b", "llama3.2-3b", "minicpm-2b", "qwen1.5-110b", "paper-llama3-8b"]  # the dense family
# The MoE family: the same KV cache, experts in place of the MLP. Its models
# run here in f32 in both packages: in bf16 the decode attention (f32
# probabilities) and the forward's (bf16) round differently, and where a
# token's 2nd and 3rd gates are that close its routing flips and its logits
# move by order 1 (3.9 at decode step 0 of seed 7, a gate margin of 1e-3);
# tests/test_torch_moe.py holds the bf16 path up to such near-ties.
MOE = ["grok-1-314b", "arctic-480b"]
TOL = 5e-2
DECODE_TOL = 8e-2
B = 2
S = 68  # prefill 64, decode 4 more, as the reference's cache test
SMAX = S + 8


def _close(a, b, tol=TOL):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=tol, atol=tol)


def _reduced(get, arch):
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, dtype="float32") if cfg.moe is not None else cfg


def _setup(arch, seed=7):
    """Reference fns and params (numpy), the port's fns and params, tokens."""
    ref_fns = ref_build_model(_reduced(ref_get_config, arch))
    ref_params = jax.tree.map(np.asarray, ref_fns.init(jax.random.PRNGKey(seed)))
    fns = build_model(_reduced(get_config, arch))
    tokens = np.random.default_rng(seed).integers(1, fns.cfg.vocab_size, (B, S)).astype(np.int32)
    return ref_fns, ref_params, fns, params_from_reference(ref_params), tokens


def _t(tokens):
    return {"tokens": torch.from_numpy(np.ascontiguousarray(tokens)).long()}


def _j(tokens):
    return {"tokens": jnp.asarray(tokens)}


@pytest.mark.parametrize("arch", DENSE + MOE)
def test_init_cache_matches_reference(arch):
    ref = ref_build_model(_reduced(ref_get_config, arch)).init_cache(B, SMAX)
    ours = build_model(_reduced(get_config, arch)).init_cache(B, SMAX, device="cpu")
    # the port's cache is the reference's plus the position as a host int
    assert sorted(ref) == ["index", "k", "v"]
    assert sorted(ours) == ["host_index", "index", "k", "v"] and ours["host_index"] == 0
    for key in ref:
        assert tuple(ours[key].shape) == ref[key].shape
        assert str(ours[key].dtype) == f"torch.{ref[key].dtype.name}"
        assert not ours[key].any()


@pytest.mark.parametrize("arch", DENSE + MOE)
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


@pytest.mark.parametrize("arch", DENSE + MOE)
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


@pytest.mark.parametrize("arch", DENSE + MOE)
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


@pytest.mark.parametrize("arch", DENSE + MOE)
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


@pytest.mark.parametrize("arch", DENSE + MOE)
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


def _hybrid_attn_layer(seed=0):
    """The reduced hybrid's attention layer 0: reference params (numpy) and
    the port's tensors of the same values."""
    ref_cfg = ref_get_config("recurrentgemma-9b").reduced()
    ref = jax.tree.map(np.asarray, ref_build_model(ref_cfg).init(jax.random.PRNGKey(seed)))
    lp = jax.tree.map(lambda a: a[0], ref["attn_layers"]["attn"])
    return ref_cfg, lp, params_from_reference(lp)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_ring_attention_decode_matches_reference(dtype):
    """The hybrid's local attention against the reference's ``ring=True,
    window=16`` over a ring of 16 slots, from an empty ring through the wrap:
    indices 0 .. 39 write slot index % 16 and attend over min(index + 1, 16)
    slots. The cache after every step equals the reference's too."""
    from repro.models.layers import attention_decode as ref_attention_decode

    ref_cfg, ref_lp, lp = _hybrid_attn_layer()
    ref_cfg = dataclasses.replace(ref_cfg, dtype=dtype)
    cfg = dataclasses.replace(get_config("recurrentgemma-9b").reduced(), dtype=dtype)
    window, hd = cfg.rglru.window, cfg.resolved_head_dim()
    if dtype == "float32":
        ref_lp = jax.tree.map(lambda a: a.astype(np.float32), ref_lp)
        lp = {k: v.float() for k, v in lp.items()}
    rng = np.random.default_rng(11)
    shape = (B, window, cfg.num_kv_heads, hd)
    ref_k = jnp.zeros(shape, getattr(jnp, dtype))
    ref_v = jnp.zeros(shape, getattr(jnp, dtype))
    k_cache = torch.zeros(shape, dtype=getattr(torch, dtype))
    v_cache = torch.zeros(shape, dtype=getattr(torch, dtype))
    tol = TOL if dtype == "bfloat16" else 1e-5
    for index in range(40):
        x = rng.standard_normal((B, 1, cfg.d_model)).astype(np.float32)
        xj = jnp.asarray(x).astype(getattr(jnp, dtype))
        idx = jnp.asarray(index, jnp.int32)
        pos = jnp.full((B, 1), index, jnp.int32)
        ref, (ref_k, ref_v) = ref_attention_decode(
            ref_lp, xj, ref_cfg, k_cache=ref_k, v_cache=ref_v, index=idx, positions=pos, window=window, ring=True,
        )
        t_index = torch.tensor(index, dtype=torch.int32)
        with torch.inference_mode():
            out, _ = layers.attention_decode(
                lp, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(k_cache.dtype), cfg,
                k_cache=k_cache, v_cache=v_cache, index=t_index, positions=t_index.expand(B, 1),
                window=window, ring=True,
            )
        _close(out, ref, tol)
        _close(k_cache, ref_k, tol)
        _close(v_cache, ref_v, tol)


@pytest.mark.parametrize("index,slot,length", [(0, 0, 1), (5, 5, 6), (15, 15, 16), (16, 0, 16), (37, 5, 16)])
def test_kv_pages_ring(index, slot, length):
    """A ring of 16 slots: the write slot wraps, the lengths stop at 16, the
    page table is the plain cache's; nothing leaves the device."""
    got_slot, table, lengths = layers.kv_pages(torch.tensor(index, dtype=torch.int32), 2, 16, ring=True)
    plain_table = layers.kv_pages(torch.tensor(index, dtype=torch.int32), 2, 16)[1]
    assert got_slot.tolist() == [slot] and got_slot.dtype == torch.int64
    assert lengths.tolist() == [length, length] and lengths.dtype == torch.int32 and lengths.is_contiguous()
    assert torch.equal(table, plain_table)


@pytest.mark.parametrize("kw,smax", [({"window": 16}, 16), ({"window": 8, "ring": True}, 16)])
def test_windows_that_are_not_a_prefix_raise(kw, smax):
    """The kernel reads a prefix of each row: a window over a plain cache, or
    a ring wider than its window, would need other slots (no path of either
    package builds them) and raises before anything is written."""
    cfg = get_config("qwen3-1.7b").reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(0))
    cache = fns.init_cache(1, smax, device="cpu")
    lp = {k: v[0] for k, v in params["layers"]["attn"].items()}
    x = torch.ones((1, 1, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="window"):
        layers.attention_decode(
            lp, x, cfg, k_cache=cache["k"][0], v_cache=cache["v"][0],
            index=cache["index"], positions=cache["index"].expand(1, 1), **kw,
        )
    assert not cache["k"].any()


@pytest.mark.parametrize("smax,pt", [(1088, 64), (76, 4), (68, 4), (64, 64), (96, 32), (7, 1), (128, 64)])
def test_kv_page_tokens(smax, pt):
    assert layers.kv_page_tokens(smax) == pt


def test_init_cache_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(get_config("qwen3-1.7b").reduced()).init_cache(1, 8)
