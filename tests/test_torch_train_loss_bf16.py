"""``loss`` in bf16 for every arch against the JAX package on the CPU, within
the reference's rtol = atol = 5e-2, with finite gradients; ``ModelFns`` has
the reference's fields in its order; remat gives the same bits; the
cross-entropy and the MoE load-balance term alone equal the reference's."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch.specs import make_concrete_batch as ref_make_concrete_batch  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.tree import flatten, leaves  # noqa: E402
from test_torch_train_loss import SHAPE, configs, port_value_and_grad, run_both  # noqa: E402

BF16_TOL = 5e-2



def test_model_fns_fields_in_the_reference_order():
    ours = [f.name for f in dataclasses.fields(port_model.ModelFns)]
    assert ours == [f.name for f in dataclasses.fields(ref_model.ModelFns)]
    assert ours.index("loss") == 3


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_loss_bf16_matches_reference(arch):
    (loss, aux, grads), (ref_loss, ref_aux, _), _ = run_both(arch, "bfloat16")
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=BF16_TOL, atol=BF16_TOL)
    np.testing.assert_allclose(float(aux["ce"]), float(ref_aux["ce"]), rtol=BF16_TOL, atol=BF16_TOL)
    for path, g in flatten(grads):
        assert torch.isfinite(g.float()).all(), path


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "grok-1-314b", "mamba2-1.3b", "recurrentgemma-9b", "qwen2-vl-7b"])
def test_remat_gives_the_same_bits(arch):
    cfg, ref_cfg = configs(arch, "float32")
    params = params_from_reference(
        jax.tree.map(np.asarray, ref_model.build_model(ref_cfg).init(jax.random.PRNGKey(2))))
    batch = {k: to_tensor(np.asarray(v)) for k, v in ref_make_concrete_batch(ref_cfg, SHAPE, seed=5).items()}
    loss, _, grads = port_value_and_grad(dataclasses.replace(cfg, remat=False), params, batch)
    loss_r, _, grads_r = port_value_and_grad(dataclasses.replace(cfg, remat=True), params, batch)
    assert torch.equal(loss, loss_r)
    for (path, g), g_r in zip(flatten(grads), leaves(grads_r)):
        assert torch.equal(g, g_r), path


def test_cross_entropy_matches_reference_with_ignored_labels():
    rng = np.random.default_rng(0)
    logits = rng.standard_normal((2, 5, 11)).astype(np.float32) * 4
    labels = rng.integers(0, 11, size=(2, 5)).astype(np.int32)
    labels[0, 1] = labels[1, 4] = -1
    ref = ref_model.cross_entropy(jnp.asarray(logits), jnp.asarray(labels))
    ours = port_model.cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels))
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6, atol=1e-6)
    ref_g = jax.grad(lambda x: ref_model.cross_entropy(x, jnp.asarray(labels)))(jnp.asarray(logits))
    x = torch.from_numpy(logits).requires_grad_()
    (g,) = torch.autograd.grad(port_model.cross_entropy(x, torch.from_numpy(labels)), x)
    np.testing.assert_allclose(g.numpy(), np.asarray(ref_g), rtol=1e-6, atol=1e-7)
    all_ignored = torch.full((2, 5), -1, dtype=torch.int32)
    assert float(port_model.cross_entropy(torch.from_numpy(logits), all_ignored)) == 0.0


@pytest.mark.parametrize("arch", ["grok-1-314b", "arctic-480b"])
def test_load_balance_loss_matches_reference(arch):
    cfg, ref_cfg = configs(arch, "float32")
    logits = np.random.default_rng(1).standard_normal((64, cfg.moe.num_experts)).astype(np.float32)
    ref = ref_model._load_balance_loss(jnp.asarray(logits), ref_cfg)
    ours = port_model._load_balance_loss(torch.from_numpy(logits), cfg)
    np.testing.assert_allclose(float(ours), float(ref), rtol=1e-6, atol=1e-6)
