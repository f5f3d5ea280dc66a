"""The training path's pieces beside the model, against the JAX package on
the CPU: three updates of ``sgd`` (momentum 0 and 0.9), ``adamw`` and
``adafactor`` (factored and not) within 1e-6 of the reference's; both
schedules at steps 0-200; ``TokenPipeline`` batches bit-equal (synthetic
and from a token file); ``compress_grads`` with equal int8 values, error
feedback and ratio."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.data.pipeline import DataConfig as RefDataConfig  # noqa: E402
from repro.data.pipeline import TokenPipeline as RefTokenPipeline  # noqa: E402
from repro.data.pipeline import pipeline_for as ref_pipeline_for  # noqa: E402
from repro.optim import optimizers as ref_optimizers  # noqa: E402
from repro.optim import schedules as ref_schedules  # noqa: E402
from repro.runtime import compression as ref_compression  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.data.pipeline import DataConfig, TokenPipeline, pipeline_for  # noqa: E402
from repro_torch.models.convert import to_numpy, to_tensor  # noqa: E402
from repro_torch.optim import optimizers, schedules  # noqa: E402
from repro_torch.runtime import compression  # noqa: E402
from repro_torch.tree import flatten, tree_map  # noqa: E402

TOL = 1e-6
BF16_ULP = 2.0 ** -7  # one bf16 step, relative: f32 values a last bit apart may round apart


def tree(seed, bf16=False):
    """A params-like tree: stacked (3-D), 2-D, 1-D and 0-d leaves."""
    rng = np.random.default_rng(seed)
    out = {
        "head": {"embed": rng.standard_normal((6, 5)).astype(np.float32), "norm": rng.standard_normal(5).astype(np.float32)},
        "layers": {"w": rng.standard_normal((2, 4, 3)).astype(np.float32), "b": rng.standard_normal((2, 3)).astype(np.float32)},
        "scalar": np.float32(rng.standard_normal()),
    }
    if bf16:
        out["layers"]["w16"] = rng.standard_normal((2, 4, 3)).astype(jnp.bfloat16)
    return out


def to_port(t):
    return tree_map(lambda a: to_tensor(np.asarray(a)), t)


@pytest.mark.parametrize("name,kw", [("sgd", {}), ("sgd", {"momentum": 0.9}), ("adamw", {}),
                                     ("adamw", {"weight_decay": 0.0}), ("adafactor", {}),
                                     ("adafactor", {"weight_decay": 0.01})])
def test_three_updates_match_reference(name, kw):
    ref_opt = getattr(ref_optimizers, name)(**kw)
    opt = getattr(optimizers, name)(**kw)
    params_np = tree(0, bf16=True)
    ref_params = jax.tree.map(jnp.asarray, params_np)
    params = to_port(params_np)
    ref_state, state = ref_opt.init(ref_params), opt.init(params)
    for i in range(3):
        grads_np = tree(10 + i, bf16=True)
        lr = np.float32(1e-2 * (i + 1))
        ref_params, ref_state = ref_opt.update(jax.tree.map(jnp.asarray, grads_np), ref_state, ref_params, lr)
        params, state = opt.update(to_port(grads_np), state, params, torch.tensor(lr))
    ours = dict(flatten({"params": params, "state": state}))
    ref = dict(flatten(jax.tree.map(np.asarray, {"params": ref_params, "state": ref_state})))
    assert list(ours) == list(ref)
    for path, t in ours.items():
        want = ref[path]
        got = to_numpy(t, bf16_dtype=jnp.bfloat16)
        assert got.dtype == want.dtype and got.shape == want.shape, path
        rtol = BF16_ULP if want.dtype == jnp.bfloat16 else TOL
        np.testing.assert_allclose(got.astype(np.float64), want.astype(np.float64), rtol=rtol, atol=TOL, err_msg=path)


def test_get_optimizer_names():
    for name in ("adamw", "adafactor", "sgd"):
        assert optimizers.get_optimizer(name).name == ref_optimizers.get_optimizer(name).name
    with pytest.raises(KeyError):
        optimizers.get_optimizer("lion")


@pytest.mark.parametrize("name", ["cosine", "wsd"])
@pytest.mark.parametrize("warmup,total", [(20, 200), (0, 150), (100, 120)])
def test_schedules_match_reference(name, warmup, total):
    ours = schedules.get_schedule(name, 3e-4, warmup, total)
    ref = ref_schedules.get_schedule(name, 3e-4, warmup, total)
    steps = np.arange(0, 201, dtype=np.int32)
    got = np.array([float(ours(torch.tensor(s))) for s in steps])
    want = np.asarray(jax.vmap(ref)(jnp.asarray(steps)))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=1e-10)
    assert float(ours(5)) == float(ours(torch.tensor(5, dtype=torch.int32)))


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "minicpm-2b"])
def test_pipeline_batches_are_bit_equal(arch):
    shape, ref_shape = ShapeSpec("train", 64, 4, "train"), RefShapeSpec("train", 64, 4, "train")
    ours = pipeline_for(get_config(arch), shape, seed=3)
    ref = ref_pipeline_for(ref_get_config(arch), ref_shape, seed=3)
    for step in (0, 1, 17):
        a, b = ours.batch(step), ref.batch(step)
        assert list(a) == list(b) == ["tokens", "labels"]
        for key in a:
            assert a[key].dtype == b[key].dtype and np.array_equal(a[key], b[key])
    it, ref_it = ours.iterate(5), ref.iterate(5)
    for _ in range(2):
        assert all(np.array_equal(x, y) for x, y in zip(next(it).values(), next(ref_it).values()))


def test_pipeline_from_a_token_file(tmp_path):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(0).integers(0, 1000, size=5000, dtype=np.int32).tofile(path)
    ours = TokenPipeline(DataConfig(seq_len=31, global_batch=3, vocab_size=1000, token_file=str(path)))
    ref = RefTokenPipeline(RefDataConfig(seq_len=31, global_batch=3, vocab_size=1000, token_file=str(path)))
    for step in (0, 4, 60):
        for key in ("tokens", "labels"):
            assert np.array_equal(ours.batch(step)[key], ref.batch(step)[key])


def test_compression_matches_reference():
    grads_np = tree(3, bf16=True)
    grads_np["layers"]["w"] *= 1e-3
    ref_err = ref_compression.init_error_feedback(jax.tree.map(jnp.asarray, grads_np))
    err = compression.init_error_feedback(to_port(grads_np))
    for _ in range(2):  # the second round carries the first's error
        ref_deq, ref_err, ref_stats = ref_compression.compress_grads(jax.tree.map(jnp.asarray, grads_np), ref_err)
        deq, err, stats = compression.compress_grads(to_port(grads_np), err)
        assert stats == ref_stats
        for (path, a), (_, b) in zip(flatten(deq), flatten(jax.tree.map(np.asarray, ref_deq))):
            got = to_numpy(a, bf16_dtype=jnp.bfloat16)
            assert got.dtype == b.dtype, path
            np.testing.assert_allclose(got.astype(np.float64), b.astype(np.float64), rtol=TOL, atol=1e-9, err_msg=path)
        for (path, a), (_, b) in zip(flatten(err), flatten(jax.tree.map(np.asarray, ref_err))):
            np.testing.assert_allclose(a.numpy(), b, rtol=1e-5, atol=1e-9, err_msg=path)
    for path, g in flatten(grads_np):
        q, scale = compression.quantize_int8(to_tensor(np.asarray(g)))
        ref_q, ref_scale = ref_compression.quantize_int8(jnp.asarray(g))
        assert q.dtype == torch.int8 and np.array_equal(q.numpy(), np.asarray(ref_q)), path
        np.testing.assert_allclose(float(scale), float(ref_scale), rtol=TOL)
        np.testing.assert_allclose(compression.dequantize_int8(q, scale).numpy(),
                                   np.asarray(ref_compression.dequantize_int8(ref_q, ref_scale)), rtol=TOL, atol=1e-9)
