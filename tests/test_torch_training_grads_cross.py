"""The backward of the port's ``train_loss`` against ``jax.grad`` of the
reference's, on the CPU, at smoke size, for the hybrid (zamba2) and the
cross-attention families (llama-3.2-vision, seamless-m4t); the dense, MoE
and SSM families, and the tolerances, are in
``tests/test_torch_training_grads.py``."""

import pytest

pytest.importorskip("torch")

from test_torch_training_grads import check_gradients
from torch_training_parity import FAMILIES, one_thread  # noqa: F401


@pytest.mark.parametrize("arch", FAMILIES[3:])
def test_train_loss_gradients_match_jax_grad(arch):
    check_gradients(arch)
