"""The backward of the port's ``train_loss`` against ``jax.grad`` of the
reference's, on the CPU, at smoke size: the dense, MoE and SSM families
here, the hybrid and cross-attention families in
``tests/test_torch_training_grads_cross.py``; and the remat policies
(``cfg.remat``) on the port alone, every family.

Weights are the reference's draw, well scaled (C9), carried across as
numpy; a [2, 32] batch is made with numpy from a seed.  The loss agrees
within LOSS_RTOL = 1e-5 relative, each leaf's gradient within GRAD_TOL =
1e-4 normwise (measured at most 5.0e-6, zamba2's ``dt_bias``: a last-place
difference in the forward passes through four layers).

``cfg.remat`` changes what the backward keeps, not what it computes, so
the gradients under "full", "dots" and "none" are equal bit for bit;
under "full" the autograd graph keeps fewer bytes than under "none", and
under "dots" the backward reruns no more un-batched matrix products than
under "none" (only those inside the always-checkpointed key and logits
chunks), and fewer than under "full".
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import train_loss as ref_train_loss
from repro_torch.convert import model_params_from_reference
from repro_torch.models import train_loss
from repro_torch.training.train_loop import value_and_grad
from repro_torch.training.tree import tree_map, tree_paths
from torch_training_parity import FAMILIES, batch_for, family_model, \
    normwise, one_thread  # noqa: F401

LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4


def port_grads(cfg, params, batch):
    return value_and_grad(lambda p, b: train_loss(p, cfg, b), params,
                          {k: torch.from_numpy(v) for k, v in batch.items()})


def check_gradients(arch):
    cfg, ref_cfg, tree = family_model(arch)
    batch = batch_for(cfg, 2, 32)
    want_loss, want = jax.value_and_grad(ref_train_loss)(
        jax.tree_util.tree_map(jnp.asarray, tree), ref_cfg,
        {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = port_grads(cfg, model_params_from_reference(
        tree, device="cpu"), batch)
    assert abs(float(loss) - float(want_loss)) <= LOSS_RTOL * abs(
        float(want_loss))
    got = tree_paths(grads)
    want = tree_paths(jax.tree_util.tree_map(np.asarray, want))
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert got[k].shape == w.shape, k
        assert np.linalg.norm(w) > 0, k   # every leaf is reached
        assert normwise(got[k].numpy(), w) <= GRAD_TOL, k


@pytest.mark.parametrize("arch", FAMILIES[:3])
def test_train_loss_gradients_match_jax_grad(arch):
    check_gradients(arch)


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
            self.n += 1
        return func(*args, **(kwargs or {}))


def _under(cfg, params, batch, remat):
    """(grads, saved bytes of the outer graph, matrix products run by the
    backward) under ``cfg.remat = remat``."""
    cfg = dataclasses.replace(cfg, remat=remat)
    saved = [0]

    def pack(t):
        saved[0] += t.numel() * t.element_size()
        return t

    diff = tree_map(lambda v: v.detach().requires_grad_(), params)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        loss = train_loss(diff, cfg, tb)
    leaves = list(tree_paths(diff).values())
    with _CountMatmuls() as count:
        grads = torch.autograd.grad(loss, leaves)
    return grads, saved[0], count.n


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_changes_no_gradient_bit(arch):
    cfg, _, tree = family_model(arch)
    params = model_params_from_reference(tree, device="cpu")
    batch = batch_for(cfg, 2, 32, seed=1)
    full, saved_full, mm_full = _under(cfg, params, batch, "full")
    dots, _, mm_dots = _under(cfg, params, batch, "dots")
    none, saved_none, mm_none = _under(cfg, params, batch, "none")
    for g_full, g_dots, g_none in zip(full, dots, none):
        assert torch.equal(g_full, g_dots)
        assert torch.equal(g_full, g_none)
    assert saved_full < saved_none / 4, (saved_full, saved_none)
    # "dots" keeps every un-batched product a rep makes, so its backward
    # reruns only those of the chunk-level checkpoints, as "none" does
    assert mm_none == mm_dots < mm_full, (mm_none, mm_dots, mm_full)


def test_an_unknown_remat_policy_is_refused():
    cfg, _, tree = family_model("qwen2-0.5b")
    params = model_params_from_reference(tree, device="cpu")
    with pytest.raises(ValueError, match="remat"):
        port_grads(dataclasses.replace(cfg, remat="most"), params,
                   batch_for(cfg, 2, 32))


@pytest.mark.parametrize("arch", FAMILIES[:3])
def test_train_steps_are_bit_stable(arch):
    """Two runs of three train steps from one state are equal bit for bit,
    params and moments: every reduction of the backward has a fixed order
    (the embedding's and the MoE dispatch's gradients included), which a
    multi-threaded CPU shows as well as the card."""
    from repro_torch.training import TrainConfig, adamw_init, \
        build_train_step, DataConfig, synth_batch

    cfg, _, tree = family_model(arch)
    tc = TrainConfig(total_steps=10, peak_lr=1e-3, warmup_steps=2)
    step = build_train_step(cfg, tc)
    batches = [{k: torch.from_numpy(v) for k, v in synth_batch(
        DataConfig(cfg.vocab, 32, 4, seed=3), i).items()} for i in range(3)]
    runs = []
    for _ in range(2):
        params = model_params_from_reference(tree, device="cpu")
        state = {"params": params, "opt": adamw_init(params, tc.opt)}
        for i, b in enumerate(batches):
            state, _ = step(state, b, i)
        runs.append(tree_paths(state))
    for k, a in runs[0].items():
        assert torch.equal(a, runs[1][k]), k
