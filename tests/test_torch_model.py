"""The port's dense transformer against the JAX package's, on the same numpy
inputs and the reference's own initial parameters. Tolerance: rtol = atol =
5e-2, the reference's kernel-test tolerance, since bf16 rounds at other places
in the two frameworks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models.model import build_model as ref_build_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.core.runtime import flatten  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402

RTOL = ATOL = 5e-2
DENSE = ["qwen3-1.7b", "llama3.2-3b"]


def _close(a, b):
    a = a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)
    np.testing.assert_allclose(a, np.asarray(b, np.float32), rtol=RTOL, atol=ATOL)


def _ref_params(arch, seed=0):
    fns = ref_build_model(ref_get_config(arch).reduced())
    return jax.tree.map(np.asarray, fns.init(jax.random.PRNGKey(seed)))


def _bf16_pair(arr):
    """The same bf16 values as a JAX array and a torch tensor."""
    j = jnp.asarray(arr).astype(jnp.bfloat16)
    return j, to_tensor(np.asarray(j))


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_configs_are_copies(arch):
    ours, ref = get_config(arch), ref_get_config(arch)
    assert repr(ours) == repr(ref)
    assert repr(ours.reduced()) == repr(ref.reduced())
    assert ours.param_count() == ref.param_count()


def test_rms_norm():
    rng = np.random.default_rng(0)
    xj, xt = _bf16_pair(rng.standard_normal((2, 5, 64), np.float32))
    w = rng.standard_normal(64).astype(np.float32) * 0.1
    _close(common.rms_norm(xt, torch.from_numpy(w), 1e-6), ref_common.rms_norm(xj, jnp.asarray(w), 1e-6))


@pytest.mark.parametrize("theta", [1e6, 5e5])
def test_apply_rope(theta):
    rng = np.random.default_rng(1)
    xj, xt = _bf16_pair(rng.standard_normal((2, 7, 3, 32), np.float32))
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 3, (2, 7)).copy()
    _close(
        common.apply_rope(xt, torch.from_numpy(pos), theta),
        ref_common.apply_rope(xj, jnp.asarray(pos), theta),
    )


def test_masked_softmax():
    rng = np.random.default_rng(2)
    s = rng.standard_normal((2, 3, 4, 9), np.float32) * 4
    mask = rng.random((2, 1, 4, 9)) > 0.4
    mask[0, 0, 1] = False  # a fully masked row
    ours = common.masked_softmax(torch.from_numpy(s), torch.from_numpy(mask))
    ref = ref_common.masked_softmax(jnp.asarray(s), jnp.asarray(mask))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize(
    "sq,skv,causal,window,q_block,invalid",
    [
        (8, 8, True, None, 1024, 0),
        (8, 8, True, 3, 1024, 0),
        (8, 8, False, None, 1024, 0),
        (16, 16, True, None, 4, 0),  # the q-block loop
        (16, 16, True, 5, 8, 0),
        (4, 12, True, None, 1024, 3),  # invalid (-1) kv slots
    ],
)
def test_attend(sq, skv, causal, window, q_block, invalid):
    rng = np.random.default_rng(3)
    qj, qt = _bf16_pair(rng.standard_normal((2, sq, 4, 16), np.float32))
    kj, kt = _bf16_pair(rng.standard_normal((2, skv, 2, 16), np.float32))
    vj, vt = _bf16_pair(rng.standard_normal((2, skv, 2, 16), np.float32))
    qpos = np.broadcast_to(np.arange(sq, dtype=np.int32) + (skv - sq), (2, sq)).copy()
    kvpos = np.broadcast_to(np.arange(skv, dtype=np.int32), (2, skv)).copy()
    kvpos[:, skv - invalid:] = -1
    kw = dict(causal=causal, window=window, q_block=q_block)
    ours = common.attend(
        qt, kt, vt, q_positions=torch.from_numpy(qpos), kv_positions=torch.from_numpy(kvpos), **kw
    )
    ref = ref_common.attend(
        qj, kj, vj, q_positions=jnp.asarray(qpos), kv_positions=jnp.asarray(kvpos), **kw
    )
    _close(ours, ref)


def test_attend_default_positions_are_iota():
    rng = np.random.default_rng(4)
    q, k, v = (torch.from_numpy(rng.standard_normal((1, 6, 2, 8), np.float32)) for _ in range(3))
    pos = torch.arange(6, dtype=torch.int32)[None]
    assert torch.equal(
        common.attend(q, k, v, causal=True),
        common.attend(q, k, v, q_positions=pos, kv_positions=pos, causal=True),
    )


@pytest.mark.parametrize("arch", DENSE)
def test_params_from_reference_keeps_layout(arch):
    ref = _ref_params(arch)
    ours = flatten(params_from_reference(ref))
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref)[0]
    assert [p for p, _ in ours] == ["/".join(k.key for k in path) for path, _ in ref_leaves]
    for (_, t), (_, leaf) in zip(ours, ref_leaves):
        assert tuple(t.shape) == leaf.shape
        assert str(t.dtype) == f"torch.{leaf.dtype.name}"
        assert t.numel() * t.element_size() == leaf.nbytes
        np.testing.assert_array_equal(t.float().numpy(), leaf.astype(np.float32))
    dtypes = dict((p, t.dtype) for p, t in ours)
    assert dtypes["head/final_norm"] == dtypes["layers/attn_norm"] == torch.float32
    assert dtypes["layers/mlp/w1"] == dtypes["head/lm_head"] == torch.bfloat16


@pytest.mark.parametrize("arch", DENSE)
def test_init_matches_reference_layout(arch):
    ours = flatten(build_model(get_config(arch).reduced()).init(torch.Generator().manual_seed(0)))
    ref = flatten(params_from_reference(_ref_params(arch)))
    assert [(p, t.shape, t.dtype) for p, t in ours] == [(p, t.shape, t.dtype) for p, t in ref]


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("seq", [1, 12])
def test_forward_logits_match_reference(arch, seq):
    cfg = ref_get_config(arch).reduced()
    params = _ref_params(arch, seed=1)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
    ref = ref_build_model(cfg).forward(params, {"tokens": jnp.asarray(tokens)})
    with torch.inference_mode():
        ours = build_model(get_config(arch).reduced()).forward(
            params_from_reference(params), {"tokens": torch.from_numpy(tokens).long()}
        )
    assert ours.shape == ref.shape and ours.dtype == torch.bfloat16
    _close(ours, ref)


@pytest.mark.parametrize("arch", ["mamba2-1.3b", "minicpm-2b", "grok-1-314b"])
def test_unported_families_raise(arch):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        build_model(get_config(arch).reduced())
