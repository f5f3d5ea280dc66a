"""Every arch the port builds, against the JAX package, on the CPU at the
reduced configs: the port's copy of ``tests/models/test_archs_smoke.py``
(forward shapes and finite; prefill then one decode step), its batches
(``launch/specs.py``) bit-equal to the reference's, the forward pass in f32
against the reference's (where no bf16 rounding can hide a difference:
rtol = atol = 1e-4), the VLM path with temporal positions that are not
0..S-1, and the tied-embedding model, the two MoE models (grok-1-314b,
arctic-480b with its dense residual) and the hybrid (recurrentgemma-9b) as
live MSched tasks, whose segments and decisions must equal the reference's
exactly."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.core.runtime import LiveModelTask as RefTask  # noqa: E402
from repro.core.runtime import LiveRuntime as RefRuntime  # noqa: E402
from repro.launch.specs import batch_spec as ref_batch_spec  # noqa: E402
from repro.launch.specs import make_concrete_batch as ref_make_concrete_batch  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.core.runtime import LiveModelTask, LiveRuntime  # noqa: E402
from repro_torch.launch.specs import VISION_FRACTION, batch_spec, make_concrete_batch  # noqa: E402
from repro_torch.launch.steps import make_serve_step  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

SMOKE = {kind: (ShapeSpec(f"smoke_{kind}", 64, 2, kind), RefShapeSpec(f"smoke_{kind}", 64, 2, kind))
         for kind in ("train", "prefill", "decode")}
# the archs build_model takes: every family
PORTED = sorted(ARCHS)
ATTENTION = [a for a in PORTED if ARCHS[a].family != "ssm"]
F32_TOL = 1e-4
TOL = 5e-2
LIVE_SET = ["minicpm-2b", "qwen3-1.7b", "mamba2-1.3b"]  # the tied head beside the live set's two families
MOE_LIVE_SET = ["grok-1-314b", "arctic-480b", "qwen3-1.7b"]  # the MoE pair beside a dense model
HYBRID_LIVE_SET = ["recurrentgemma-9b", "qwen3-1.7b", "mamba2-1.3b"]  # the hybrid beside the live set


def _f32(cfg):
    return dataclasses.replace(cfg, dtype="float32")


def _ref_params(cfg, seed):
    return jax.tree.map(np.asarray, ref_build_model(cfg).init(jax.random.PRNGKey(seed)))


def _port_batch(batch):
    return {k: to_tensor(np.asarray(v)) for k, v in batch.items()}


def test_ported_archs():
    assert PORTED == ["arctic-480b", "grok-1-314b", "hubert-xlarge", "llama3.2-3b", "mamba2-1.3b", "minicpm-2b",
                      "paper-llama3-8b", "qwen1.5-110b", "qwen2-vl-7b", "qwen3-1.7b", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
def test_make_concrete_batch_matches_reference(arch, kind):
    ours_shape, ref_shape = SMOKE[kind]
    cfg, ref_cfg = get_config(arch).reduced(), ref_get_config(arch).reduced()
    spec, ref_spec = batch_spec(cfg, ours_shape), ref_batch_spec(ref_cfg, ref_shape)
    assert list(spec) == list(ref_spec)
    for name, (shape, dtype) in spec.items():
        assert shape == ref_spec[name].shape and str(dtype) == f"torch.{ref_spec[name].dtype.name}"
    ours = make_concrete_batch(cfg, ours_shape, seed=3, device="cpu")
    ref = ref_make_concrete_batch(ref_cfg, ref_shape, seed=3)
    assert list(ours) == list(ref)
    for name, t in ours.items():
        want = to_tensor(np.asarray(ref[name]))
        assert t.dtype == want.dtype and t.shape == want.shape
        assert torch.equal(t, want), name  # bit-equal, bf16 embeddings included
    if cfg.family == "vlm" and kind != "decode":
        assert ours["vision_embeds"].shape[1] == 64 // VISION_FRACTION


@pytest.mark.parametrize("arch", PORTED)
def test_forward_shapes_and_finite(arch):
    """The port's copy of the reference's smoke test, on the forward pass
    (the port has no loss yet)."""
    cfg = get_config(arch).reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, SMOKE["train"][0], device="cpu")
    with torch.inference_mode():
        logits = fns.forward(params, batch)
    assert logits.shape == (2, 64, cfg.vocab_size) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


@pytest.mark.parametrize("arch", [a for a in PORTED if ARCHS[a].has_decode])
def test_prefill_then_decode(arch):
    cfg = get_config(arch).reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(0))
    batch = make_concrete_batch(cfg, SMOKE["prefill"][0], device="cpu")
    with torch.inference_mode():
        # one slot for the decode step: the reference's prefill sizes its cache
        # to the prompt and its decode clamps the write into the last slot,
        # where the port's raises (ROADMAP.md §3)
        logits, cache = fns.prefill(params, batch, max_seq=65)
        assert logits.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits.float()).all()
        logits2, cache2 = make_serve_step(cfg)(params, cache, {"tokens": torch.ones((2, 1), dtype=torch.int32)})
    assert logits2.shape == (2, 1, cfg.vocab_size) and torch.isfinite(logits2.float()).all()
    assert int(cache2["index"]) == cache2["host_index"] == int(cache["index"]) + 1 == 65


@pytest.mark.parametrize("arch", ATTENTION)
def test_forward_f32_matches_reference(arch):
    """In f32 the two packages compute the same function to rounding of f32
    sums: any difference of the algorithm (a RoPE section, a mask, the tied
    head, the mask embedding) shows far above F32_TOL."""
    ref_cfg, cfg = _f32(ref_get_config(arch).reduced()), _f32(get_config(arch).reduced())
    params = _ref_params(ref_cfg, seed=2)
    batch = ref_make_concrete_batch(ref_cfg, SMOKE["prefill"][1], seed=4)
    ref = np.asarray(ref_build_model(ref_cfg).forward(params, batch))
    with torch.inference_mode():
        ours = build_model(cfg).forward(params_from_reference(params), _port_batch(batch))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    np.testing.assert_allclose(ours.numpy(), ref, rtol=F32_TOL, atol=F32_TOL)


def _mrope_positions(b, s_vis, s_text):
    """Qwen2-VL's layout: the vision patches of a 1 x 2 x (s_vis / 2) grid at
    temporal 0, then text from the grid's largest index + 1 on all axes."""
    grid_w = s_vis // 2
    vis = np.stack([np.zeros(s_vis), np.arange(s_vis) // grid_w, np.arange(s_vis) % grid_w])
    text = np.arange(s_text) + max(2, grid_w)
    pos = np.concatenate([vis, np.stack([text] * 3)], axis=1).astype(np.int32)
    return np.broadcast_to(pos[:, None, :], (3, b, s_vis + s_text)).copy()


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_vlm_positions_that_are_not_an_index_on_the_cpu(dtype):
    """On the CPU the port masks by positions3[0] as the reference does (the
    card's flash kernel masks by index and raises instead)."""
    ref_cfg = dataclasses.replace(ref_get_config("qwen2-vl-7b").reduced(), dtype=dtype)
    cfg = dataclasses.replace(get_config("qwen2-vl-7b").reduced(), dtype=dtype)
    rng = np.random.default_rng(8)
    params = _ref_params(ref_cfg, seed=5)
    batch = {
        "tokens": jnp.asarray(rng.integers(1, cfg.vocab_size, (2, 24)).astype(np.int32)),
        "vision_embeds": jnp.asarray(rng.standard_normal((2, 8, cfg.d_model)), dtype=getattr(jnp, dtype)),
        "positions3": jnp.asarray(_mrope_positions(2, 8, 24)),
    }
    assert not np.array_equal(np.asarray(batch["positions3"][0, 0]), np.arange(32))
    ref = np.asarray(ref_build_model(ref_cfg).forward(params, batch)).astype(np.float32)
    with torch.inference_mode():
        ours = build_model(cfg).forward(params_from_reference(params), _port_batch(batch)).float().numpy()
    tol = F32_TOL if dtype == "float32" else TOL
    np.testing.assert_allclose(ours, ref, rtol=tol, atol=tol)
    # the index positions give other logits: the positions do reach the mask and M-RoPE
    index = dict(batch, positions3=jnp.broadcast_to(jnp.arange(32, dtype=jnp.int32), (3, 2, 32)))
    with torch.inference_mode():
        other = build_model(cfg).forward(params_from_reference(params), _port_batch(index)).float().numpy()
    assert np.abs(other - ours).max() > 10 * tol


def test_audio_frame_mask_takes_the_mask_embedding():
    """Masked frames are replaced by embed[0] before the encoder: a batch
    whose masked frames already hold embed[0] gives the same logits."""
    cfg = get_config("hubert-xlarge").reduced()
    fns = build_model(cfg)
    params = fns.init(torch.Generator().manual_seed(1))
    batch = make_concrete_batch(cfg, SMOKE["prefill"][0], seed=2, device="cpu")
    mask = batch["frame_mask"]
    assert 0 < int(mask.sum()) < mask.numel()
    filled = torch.where(mask[..., None], params["head"]["embed"][0], batch["frames"])
    with torch.inference_mode():
        a = fns.forward(params, batch)
        b = fns.forward(params, {"frames": filled})
        c = fns.forward(params, {"frames": batch["frames"]})
    assert torch.equal(a, b) and not torch.equal(a, c)


# -- the tied head as a live MSched task --------------------------------------


@pytest.fixture(scope="module")
def live_tasks():
    ref = [RefTask(i, a, seed=i) for i, a in enumerate(LIVE_SET)]
    ours = [
        LiveModelTask(i, a, seed=i, device="cpu", params=_ref_params(ref_get_config(a).reduced(), i))
        for i, a in enumerate(LIVE_SET)
    ]
    return ref, ours


def test_tied_task_segments_match_reference(live_tasks):
    ref, ours = live_tasks
    for r, o in zip(ref, ours):
        ref_segs = [(s.path.replace("['", "").replace("']", ""), s.base, s.nbytes) for s in r.segments]
        assert [(s.path, s.base, s.nbytes) for s in o.segments] == ref_segs
        assert o.footprint_bytes() == r.footprint_bytes()
    paths = [s.path for s in ours[0].segments]
    assert "head/embed" in paths and "head/lm_head" not in paths and len(paths) == 11


@pytest.mark.parametrize("what,share", [("footprint", 0.5), ("params", 0.6)])
def test_tied_task_stats_equal_reference(live_tasks, what, share):
    ref, ours = live_tasks
    for t in ref + ours:
        for s in t.segments:
            s.device = None
    if what == "footprint":
        budget = int(share * sum(t.footprint_bytes() for t in ref))
    else:
        budget = int(share * sum(s.nbytes for t in ref for s in t.segments))
    a = RefRuntime(ref, budget, steps_per_slice=2).run(6)
    b = LiveRuntime(ours, budget, steps_per_slice=2).run(6)
    assert b.steps == a.steps and b.steps[0] > 0
    assert b.migrated_in_bytes == a.migrated_in_bytes > 0
    assert b.migrated_out_bytes == a.migrated_out_bytes
    assert b.demand_faults == a.demand_faults


def test_tied_task_step_matches_reference(live_tasks):
    ref, ours = live_tasks
    for t in (ref[0], ours[0]):
        for s in t.segments:
            if s.device is None:
                s.device = s.host if isinstance(s.host, torch.Tensor) else jax.device_put(s.host)
    for i in range(2):
        got, want = ours[0].run_step(i), ref[0].run_step(i)
        assert tuple(got.shape) == want.shape == (1, 1, ours[0].cfg.vocab_size)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


# -- the MoE pair as live MSched tasks -----------------------------------------


@pytest.fixture(scope="module")
def moe_live_tasks():
    ref = [RefTask(i, a, seed=i) for i, a in enumerate(MOE_LIVE_SET)]
    ours = [
        LiveModelTask(i, a, seed=i, device="cpu", params=_ref_params(ref_get_config(a).reduced(), i))
        for i, a in enumerate(MOE_LIVE_SET)
    ]
    return ref, ours


def test_moe_task_segments_match_reference(moe_live_tasks):
    """A layer's ``moe`` leaves (router, w1, w2, w3, and arctic's dense MLP)
    land in the reference's segments, page for page."""
    ref, ours = moe_live_tasks
    for r, o in zip(ref, ours):
        ref_segs = [(s.path.replace("['", "").replace("']", ""), s.base, s.nbytes) for s in r.segments]
        assert [(s.path, s.base, s.nbytes) for s in o.segments] == ref_segs
        assert o.footprint_bytes() == r.footprint_bytes()
    grok, arctic = ([s.path for s in t.segments] for t in ours[:2])
    assert "layers/moe/router" in grok and "layers/mlp/w1" not in grok and len(grok) == 13
    assert "layers/moe/dense/w1" in arctic and len(arctic) == 16


@pytest.mark.parametrize("what,share", [("footprint", 0.5), ("params", 0.6)])
def test_moe_task_stats_equal_reference(moe_live_tasks, what, share):
    ref, ours = moe_live_tasks
    for t in ref + ours:
        for s in t.segments:
            s.device = None
    if what == "footprint":
        budget = int(share * sum(t.footprint_bytes() for t in ref))
    else:
        budget = int(share * sum(s.nbytes for t in ref for s in t.segments))
    a = RefRuntime(ref, budget, steps_per_slice=2).run(6)
    b = LiveRuntime(ours, budget, steps_per_slice=2).run(6)
    assert b.steps == a.steps and b.steps[0] > 0 and b.steps[1] > 0
    assert b.migrated_in_bytes == a.migrated_in_bytes > 0
    assert b.migrated_out_bytes == a.migrated_out_bytes
    assert b.demand_faults == a.demand_faults


@pytest.mark.parametrize("task", [0, 1])
def test_moe_task_step_matches_reference(moe_live_tasks, task):
    """A live step is one token: n = 1, so the capacity is its floor of
    top_k = 2 slots an expert."""
    ref, ours = moe_live_tasks
    for t in (ref[task], ours[task]):
        for s in t.segments:
            if s.device is None:
                s.device = s.host if isinstance(s.host, torch.Tensor) else jax.device_put(s.host)
    for i in range(2):
        got, want = ours[task].run_step(i), ref[task].run_step(i)
        assert tuple(got.shape) == want.shape == (1, 1, ours[task].cfg.vocab_size)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)


# -- the hybrid as a live MSched task -------------------------------------------


@pytest.fixture(scope="module")
def hybrid_live_tasks():
    ref = [RefTask(i, a, seed=i) for i, a in enumerate(HYBRID_LIVE_SET)]
    ours = [
        LiveModelTask(i, a, seed=i, device="cpu", params=_ref_params(ref_get_config(a).reduced(), i))
        for i, a in enumerate(HYBRID_LIVE_SET)
    ]
    return ref, ours


def test_hybrid_task_segments_match_reference(hybrid_live_tasks):
    """The hybrid's two stacks (``attn_layers``, ``rec_layers``) land in the
    reference's segments, page for page."""
    ref, ours = hybrid_live_tasks
    for r, o in zip(ref, ours):
        ref_segs = [(s.path.replace("['", "").replace("']", ""), s.base, s.nbytes) for s in r.segments]
        assert [(s.path, s.base, s.nbytes) for s in o.segments] == ref_segs
        assert o.footprint_bytes() == r.footprint_bytes()
    paths = [s.path for s in ours[0].segments]
    assert "rec_layers/rec/lam" in paths and "attn_layers/attn/wq" in paths and len(paths) == 25


@pytest.mark.parametrize("what,share", [("footprint", 0.5), ("params", 0.6)])
def test_hybrid_task_stats_equal_reference(hybrid_live_tasks, what, share):
    ref, ours = hybrid_live_tasks
    for t in ref + ours:
        for s in t.segments:
            s.device = None
    if what == "footprint":
        budget = int(share * sum(t.footprint_bytes() for t in ref))
    else:
        budget = int(share * sum(s.nbytes for t in ref for s in t.segments))
    a = RefRuntime(ref, budget, steps_per_slice=2).run(6)
    b = LiveRuntime(ours, budget, steps_per_slice=2).run(6)
    assert b.steps == a.steps and b.steps[0] > 0
    assert b.migrated_in_bytes == a.migrated_in_bytes > 0
    assert b.migrated_out_bytes == a.migrated_out_bytes
    assert b.demand_faults == a.demand_faults


def test_hybrid_task_step_matches_reference(hybrid_live_tasks):
    """A live step is one token: the recurrence from a zero state, the local
    attention over one position (the flash kernel's Sq = Skv = 1 call)."""
    ref, ours = hybrid_live_tasks
    for t in (ref[0], ours[0]):
        for s in t.segments:
            if s.device is None:
                s.device = s.host if isinstance(s.host, torch.Tensor) else jax.device_put(s.host)
    for i in range(2):
        got, want = ours[0].run_step(i), ref[0].run_step(i)
        assert tuple(got.shape) == want.shape == (1, 1, ours[0].cfg.vocab_size)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=TOL, atol=TOL)
