"""``loss`` and its gradients in f32 for the MoE pair (at the reduced
configs' capacity factor 2.0, where nothing drops), the SSM and the hybrid,
against the JAX package on the CPU: the loss within 1e-5 and every gradient
leaf within 1e-4 relative L2 (``test_torch_train_loss.py`` holds the
helpers and the other archs)."""
import pytest

pytest.importorskip("torch")
from test_torch_train_loss import FAMILIES, check_f32  # noqa: E402


@pytest.mark.parametrize("arch", FAMILIES)
def test_loss_and_grads_f32_match_reference(arch):
    check_f32(arch)
