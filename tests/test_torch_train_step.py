"""``make_train_step`` against the JAX package's jitted step on the CPU, in
f32, from the same train state (``models/convert.py``) and batches: three
steps, without and with microbatches, give ``loss``, ``ce``, ``grad_norm``,
``lr`` and the params within 1e-4 (rtol = atol) of the reference's, and the
optimizer state too. ``warmup=1`` makes step 0's learning rate 0 and the
later ones the peak, so both branches of the schedule run. Also: remat and
``REPRO_MICROBATCH`` give the same bits, and the state comes back in the
reference's form."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.launch.specs import make_concrete_batch as ref_make_concrete_batch  # noqa: E402
from repro.launch.steps import make_train_state as ref_make_train_state  # noqa: E402
from repro.launch.steps import make_train_step as ref_make_train_step  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.launch.steps import make_train_state, make_train_step  # noqa: E402
from repro_torch.models.convert import (  # noqa: E402
    to_tensor,
    train_state_from_reference,
    train_state_to_reference,
)
from repro_torch.tree import flatten  # noqa: E402

TOL = 1e-4
STEPS = 3
KW = dict(peak_lr=3e-4, warmup=1, total_steps=10)
SHAPE = RefShapeSpec("train_small", 16, 4, "train")


def configs(arch):
    return tuple(dataclasses.replace(c.reduced(), dtype="float32") for c in (get_config(arch), ref_get_config(arch)))


def batches(ref_cfg):
    return [ref_make_concrete_batch(ref_cfg, SHAPE, seed=10 + i) for i in range(STEPS)]


def run_port(cfg, state, ref_batches, **kw):
    step_fn = make_train_step(cfg, **KW, **kw)
    metrics = []
    for b in ref_batches:
        state, m = step_fn(state, {k: to_tensor(np.asarray(v)) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    return state, metrics


@pytest.mark.parametrize("arch,micro", [("qwen3-1.7b", 0), ("qwen3-1.7b", 2), ("qwen2-vl-7b", 2),
                                        ("grok-1-314b", 0), ("mamba2-1.3b", 2)])
def test_train_steps_match_reference(arch, micro):
    cfg, ref_cfg = configs(arch)
    ref_state = ref_make_train_state(ref_cfg, jax.random.PRNGKey(0))
    state = train_state_from_reference(jax.tree.map(np.asarray, ref_state))
    ref_step = jax.jit(ref_make_train_step(ref_cfg, **KW, microbatches=micro))
    bs = batches(ref_cfg)
    ref_metrics = []
    for b in bs:
        ref_state, m = ref_step(ref_state, b)
        ref_metrics.append({k: float(v) for k, v in m.items()})
    state, metrics = run_port(cfg, state, bs, microbatches=micro)
    for ours, ref in zip(metrics, ref_metrics):
        assert list(ours) == ["loss", "ce", "grad_norm", "lr"] and sorted(ours) == sorted(ref)
        for key in ours:
            np.testing.assert_allclose(ours[key], ref[key], rtol=TOL, atol=TOL, err_msg=key)
    if micro:  # the reference's scan carries no aux: ce reads 0
        assert all(m["ce"] == 0.0 for m in metrics)
    assert int(state["step"]) == STEPS
    ref_flat = dict(flatten(jax.tree.map(np.asarray, ref_state)))
    ours = dict(flatten(train_state_to_reference(state, bf16_dtype=jnp.bfloat16)))
    assert list(ours) == list(ref_flat)
    for path, val in ours.items():
        assert val.dtype == ref_flat[path].dtype and val.shape == ref_flat[path].shape, path
        np.testing.assert_allclose(val, ref_flat[path], rtol=TOL, atol=TOL, err_msg=path)


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "recurrentgemma-9b"])
def test_remat_and_the_microbatch_variable_give_the_same_bits(arch, monkeypatch):
    cfg, ref_cfg = configs(arch)
    ref_state = jax.tree.map(np.asarray, ref_make_train_state(ref_cfg, jax.random.PRNGKey(1)))
    bs = batches(ref_cfg)[:2]
    runs = {}
    for label, remat, micro, env in (("plain", False, 2, ""), ("remat", True, 2, ""), ("env", False, 0, "2")):
        monkeypatch.setenv("REPRO_MICROBATCH", env)
        state, metrics = run_port(dataclasses.replace(cfg, remat=remat), train_state_from_reference(ref_state), bs,
                                  microbatches=micro)
        runs[label] = (state, metrics)
    base_state, base_metrics = runs["plain"]
    for label in ("remat", "env"):
        state, metrics = runs[label]
        assert metrics == base_metrics, label
        for (path, a), (_, b) in zip(flatten(base_state), flatten(state)):
            assert torch.equal(a, b), (label, path)


def test_train_state_from_a_generator():
    cfg = get_config("qwen3-1.7b").reduced()
    state = make_train_state(cfg, torch.Generator().manual_seed(0))
    assert sorted(state) == ["opt", "params", "step"]
    assert state["step"].dtype == torch.int32 and state["step"].dim() == 0
    assert sorted(state["opt"]) == ["count", "m", "v"]  # adamw, the config's optimizer
    for (path, p), (_, m) in zip(flatten(state["params"]), flatten(state["opt"]["m"])):
        assert m.shape == p.shape and m.dtype == torch.float32 and not m.any(), path
