"""Prefill + decode against the full-sequence forward pass: the port's copy of
``tests/models/test_cache_consistency.py`` over every decode arch the port
builds (the dense models, tied or not, the MoE pair, qwen2-vl-7b with M-RoPE,
mamba2-1.3b, recurrentgemma-9b with its ring of 16 slots, which the 64-token
prefill wraps),
on the reference's own parameters. Each decode is held against the
reference's ``forward`` and against the port's own, at the reference's
tolerance for this comparison, rtol = atol = 8e-2; once from the port's
prefill and once from the reference's prefill cache (``cache_from_reference``).
Batches are the reference test's shapes (B 2, 64 prompt positions then 4
decoded tokens, 8 vision positions ahead for the VLM), drawn with numpy and
given to both packages. The MoE pair runs in f32 in both packages (``_reduced``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.models.convert import cache_from_reference, params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

DECODE_ARCHS = sorted(a for a, c in ARCHS.items() if c.has_decode)
B = 2
S = 68  # prefill 64 (a multiple of the reduced ssm chunk 32), decode 4 more
S_VIS = 8
TOL = 8e-2


def _reduced(get, arch):
    """The reduced config; in f32 for the MoE family, where bf16 rounding at
    other places flips the routing of near-tied tokens (tests/test_torch_decode.py,
    ``MOE``)."""
    cfg = get(arch).reduced()
    return dataclasses.replace(cfg, dtype="float32") if cfg.moe is not None else cfg


def _setup(arch, seed=7):
    ref_cfg = _reduced(ref_get_config, arch)
    ref_fns = ref_build_model(ref_cfg)
    ref_params = jax.tree.map(np.asarray, ref_fns.init(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, ref_cfg.vocab_size, (B, S)).astype(np.int32)
    full = {"tokens": tokens}
    prefill = {"tokens": tokens[:, : S - 4]}
    if ref_cfg.family == "vlm":
        ve = rng.standard_normal((B, S_VIS, ref_cfg.d_model), np.float32)
        pos = np.broadcast_to(np.arange(S + S_VIS, dtype=np.int32), (3, B, S + S_VIS))
        full.update(vision_embeds=ve, positions3=pos)
        prefill.update(vision_embeds=ve, positions3=pos[:, :, : S + S_VIS - 4])
    fns = build_model(_reduced(get_config, arch))
    return ref_fns, ref_params, fns, params_from_reference(ref_params), full, prefill, tokens


def _j(batch):
    return {k: jnp.asarray(v, jnp.bfloat16) if v.dtype == np.float32 else jnp.asarray(v) for k, v in batch.items()}


def _t(batch):
    """The torch batch of the same values (embeddings rounded to bf16 as JAX rounds them)."""
    return {k: to_tensor(np.asarray(v)) for k, v in _j(batch).items()}


def _close(a, b, what):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=TOL, atol=TOL, err_msg=what)


def _offset(fns):
    return S_VIS if fns.cfg.family == "vlm" else 0


def test_decode_archs():
    assert DECODE_ARCHS == ["arctic-480b", "grok-1-314b", "llama3.2-3b", "mamba2-1.3b", "minicpm-2b",
                            "paper-llama3-8b", "qwen1.5-110b", "qwen2-vl-7b", "qwen3-1.7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward(arch):
    """The port's prefill's last logits and four decode steps reproduce the
    reference's forward pass and the port's own."""
    ref_fns, ref_params, fns, params, full, prefill, tokens = _setup(arch)
    off = _offset(fns)
    ref_logits = np.asarray(ref_fns.forward(ref_params, _j(full)), np.float32)
    with torch.inference_mode():
        own_logits = fns.forward(params, _t(full)).float()
        logits, cache = fns.prefill(params, _t(prefill), max_seq=S + S_VIS + 8)
        assert cache["host_index"] == S - 4 + off
        _close(logits[:, 0], ref_logits[:, S - 5 + off], f"{arch}: prefill vs reference forward")
        _close(logits[:, 0], own_logits[:, S - 5 + off], f"{arch}: prefill vs forward")
        for i in range(4):
            tok = torch.from_numpy(np.ascontiguousarray(tokens[:, S - 4 + i : S - 3 + i]))
            logits, cache = fns.decode_step(params, cache, {"tokens": tok})
            _close(logits[:, 0], ref_logits[:, S - 4 + i + off], f"{arch}: decode step {i} vs reference forward")
            _close(logits[:, 0], own_logits[:, S - 4 + i + off], f"{arch}: decode step {i} vs forward")
    assert int(cache["index"]) == cache["host_index"] == S + off


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_from_reference_cache(arch):
    """Four port decode steps from the reference's own prefill cache, against
    the reference's decode steps and its forward pass."""
    ref_fns, ref_params, fns, params, full, prefill, tokens = _setup(arch)
    off = _offset(fns)
    ref_logits = np.asarray(ref_fns.forward(ref_params, _j(full)), np.float32)
    max_seq = None if fns.cfg.family == "ssm" else S + S_VIS + 8
    _, ref_cache = ref_fns.prefill(ref_params, _j(prefill), max_seq=max_seq)
    cache = cache_from_reference(jax.tree.map(np.asarray, ref_cache))
    assert cache["host_index"] == S - 4 + off
    for i in range(4):
        tok = tokens[:, S - 4 + i : S - 3 + i]
        ref_step, ref_cache = ref_fns.decode_step(ref_params, ref_cache, {"tokens": jnp.asarray(tok)})
        with torch.inference_mode():
            logits, cache = fns.decode_step(params, cache, {"tokens": torch.from_numpy(np.ascontiguousarray(tok))})
        _close(logits, ref_step, f"{arch}: decode step {i} vs reference decode")
        _close(logits[:, 0], ref_logits[:, S - 4 + i + off], f"{arch}: decode step {i} vs reference forward")
    assert int(cache["index"]) == int(ref_cache["index"]) == S + off
