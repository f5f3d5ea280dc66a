"""``loss`` and its gradients in f32 for the dense, tied, VLM and audio archs,
against the JAX package on the CPU at the reduced configs, from the same
numpy weights and batches: the loss within 1e-5 and every gradient leaf
within 1e-4 relative L2 of ``jax.value_and_grad`` of the reference's
``loss`` (sums in another order, no rounding to hide a fault). The helpers
here serve ``test_torch_train_loss_families.py`` (the MoE pair, the SSM and
the hybrid) and ``test_torch_train_loss_bf16.py`` too."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs.base import ShapeSpec as RefShapeSpec  # noqa: E402
from repro.launch.specs import make_concrete_batch as ref_make_concrete_batch  # noqa: E402
from repro.models import model as ref_model  # noqa: E402
from repro_torch.configs import ARCHS, get_config  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models import model as port_model  # noqa: E402
from repro_torch.models.convert import params_from_reference, to_tensor  # noqa: E402
from repro_torch.tree import flatten, unflatten_like  # noqa: E402

FAMILIES = ["arctic-480b", "grok-1-314b", "mamba2-1.3b", "recurrentgemma-9b"]  # the other files
SHAPE = RefShapeSpec("train_small", 32, 2, "train")
LOSS_TOL = 1e-5
GRAD_REL_L2 = 1e-4
BF16_TOL = 5e-2


def configs(arch, dtype):
    return tuple(dataclasses.replace(c.reduced(), dtype=dtype) for c in (get_config(arch), ref_get_config(arch)))


def rel_l2(ours, ref) -> float:
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    den = np.linalg.norm(ref)
    return float(np.linalg.norm(ours - ref) / den) if den > 0 else float(np.linalg.norm(ours))


def port_value_and_grad(cfg, params, batch):
    loss, aux, grads = value_and_grad(port_model.build_model(cfg), params, batch)
    return loss, aux, unflatten_like(params, grads)


def run_both(arch, dtype, seed=0):
    cfg, ref_cfg = configs(arch, dtype)
    ref_params = jax.tree.map(np.asarray, ref_model.build_model(ref_cfg).init(jax.random.PRNGKey(seed)))
    ref_batch = ref_make_concrete_batch(ref_cfg, SHAPE, seed=seed + 1)
    (ref_loss, ref_aux), ref_grads = jax.value_and_grad(ref_model.build_model(ref_cfg).loss, has_aux=True)(
        jax.tree.map(jnp.asarray, ref_params), ref_batch)
    batch = {k: to_tensor(np.asarray(v)) for k, v in ref_batch.items()}
    loss, aux, grads = port_value_and_grad(cfg, params_from_reference(ref_params), batch)
    return (loss, aux, grads), (ref_loss, ref_aux, ref_grads), (cfg, params_from_reference(ref_params), batch)


def check_f32(arch):
    (loss, aux, grads), (ref_loss, ref_aux, ref_grads), _ = run_both(arch, "float32")
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=LOSS_TOL, atol=LOSS_TOL)
    for key in ("ce", "aux"):
        np.testing.assert_allclose(float(aux[key]), float(ref_aux[key]), rtol=LOSS_TOL, atol=LOSS_TOL)
    ref_paths = dict(flatten(jax.tree.map(np.asarray, ref_grads)))
    ours = dict(flatten(grads))
    assert list(ours) == list(ref_paths)
    for path, g in ours.items():
        assert tuple(g.shape) == ref_paths[path].shape, path
        rel = rel_l2(g.numpy(), ref_paths[path])
        assert rel <= GRAD_REL_L2, f"{arch} {path}: relative L2 {rel:.3e}"



@pytest.mark.parametrize("arch", sorted(set(ARCHS) - set(FAMILIES)))
def test_loss_and_grads_f32_match_reference(arch):
    check_f32(arch)
