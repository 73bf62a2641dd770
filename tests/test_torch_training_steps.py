"""The port's train steps against the reference's, on the CPU:
``build_train_step`` on qwen2-0.5b at smoke size (one and three steps,
``accum_steps`` 1 and 2, f32 and bf16 accumulation, 8-bit moments, whose
own tolerances are in their test's docstring), and
``build_sparse_ffn_train_step`` at the reference's own test's shapes.

Both packages start from one state: the reference's well-scaled draw (C9)
and its zero moments, carried across by ``train_state_from_reference``.
Each step's batch is ``synth_batch``'s, equal in both.  After one step
and after three, the whole param tree is held at PARAM_TOL = 1e-5
normwise (measured at most 1.3e-6, bf16 accumulation), and so is each
weight leaf (measured at most 2.5e-6): the gradients agree to about
5e-6 (``tests/test_torch_training_grads.py``), and AdamW's first steps
move each element by about ``lr`` whatever the gradient's size.  The
q/k/v biases start at zero, so each of their elements is nothing but
those steps: AdamW's first steps move an element by about ``lr *
sign(g)`` whatever the gradient's size, so where an element's gradient is
the small remainder of a cancelling sum (each package adds it in its own
order, to a few digits) its step can differ in size or sign, and nothing
dilutes that in the leaf's norm, as a weight's initial values do.  They
are held at BIAS_TOL = 1e-2 normwise (measured 1.7e-3 for ``wk/b``,
1.0e-4 for ``wq/b``).  The bf16 accumulation buffer
rounds both packages' gradients to bf16, where an element whose f32
gradients straddle a rounding boundary differs by one bf16 step; AdamW
normalises that away but for a few elements.

The sparse-FFN step's loss is held at 1e-5 relative each step over six
steps, and must fall below 0.7x its first value, as in the reference's
test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.models.sparse_ffn import SparseFFN as RefSparseFFN
from repro.training import TrainConfig as RefTrainConfig
from repro.training import adamw_init as ref_adamw_init
from repro.training import build_train_step as ref_build_train_step
from repro.training import synth_batch as ref_synth_batch
from repro.training.data import DataConfig as RefDataConfig
from repro.training.optimizer import AdamWConfig as RefAdamWConfig
from repro.training.train_loop import \
    build_sparse_ffn_train_step as ref_build_sparse_ffn_train_step
from repro_torch.convert import train_state_from_reference
from repro_torch.models import SparseFFN
from repro_torch.training import AdamWConfig, DataConfig, TrainConfig, \
    build_train_step, synth_batch
from repro_torch.training.train_loop import build_sparse_ffn_train_step
from repro_torch.training.tree import tree_paths
from torch_training_parity import family_model, normwise, \
    one_thread  # noqa: F401

PARAM_TOL = 1e-5
BIAS_TOL = 1e-2
LOSS_RTOL = 1e-5
QUANT_LOSS_RTOL = 2e-3
QUANT_CODES = 1e-3


def _flat(paths: dict) -> np.ndarray:
    """A tree's leaves, by key, as one f64 vector."""
    return np.concatenate([np.ravel(np.asarray(paths[k], np.float64))
                           for k in sorted(paths)])


def _run_both(accum, accum_dtype, quantize, n_steps=3):
    """Both packages' train steps from one state on the same batches:
    yields (step index, port state, port metrics, reference state,
    reference metrics) after each step."""
    cfg, ref_cfg, tree = family_model("qwen2-0.5b")
    kw = dict(total_steps=10, accum_steps=accum, accum_dtype=accum_dtype,
              peak_lr=1e-3, warmup_steps=2)
    tc = TrainConfig(**kw, opt=AdamWConfig(quantize_moments=quantize))
    ref_tc = RefTrainConfig(**kw,
                            opt=RefAdamWConfig(quantize_moments=quantize))
    ref_state = {"params": jax.tree_util.tree_map(jnp.asarray, tree)}
    ref_state["opt"] = ref_adamw_init(ref_state["params"], ref_tc.opt)
    state = train_state_from_reference(
        jax.tree_util.tree_map(np.asarray, ref_state), device="cpu")
    ref_step = jax.jit(ref_build_train_step(ref_cfg, ref_tc))
    step = build_train_step(cfg, tc)
    dcfg = dict(vocab=cfg.vocab, seq_len=32, global_batch=4, seed=3)
    for i in range(n_steps):
        batch = synth_batch(DataConfig(**dcfg), i)
        ref_batch = ref_synth_batch(RefDataConfig(**dcfg), i)
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()}, i)
        ref_state, ref_m = ref_step(ref_state, {
            k: jnp.asarray(v) for k, v in ref_batch.items()}, jnp.int32(i))
        assert float(m["lr"]) == float(ref_m["lr"])
        yield i, state, m, jax.tree_util.tree_map(np.asarray, ref_state), \
            ref_m


def _check_params(state, ref_state, i):
    got = tree_paths(state["params"])
    want = tree_paths(ref_state["params"])
    assert normwise(_flat(got), _flat(want)) <= PARAM_TOL
    for k, w in want.items():
        tol = BIAS_TOL if k.endswith("/b") else PARAM_TOL
        assert normwise(got[k].numpy(), w) <= tol, (i, k)


@pytest.mark.parametrize("accum,accum_dtype", [
    (1, "float32"), (2, "float32"), (2, "bfloat16")])
def test_train_steps_match_the_reference(accum, accum_dtype):
    for i, state, m, ref_state, ref_m in _run_both(accum, accum_dtype,
                                                   False):
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= LOSS_RTOL * \
            abs(float(ref_m["loss"]))
        if i in (0, 2):     # after one step and after three
            _check_params(state, ref_state, i)
    assert int(state["opt"]["step"]) == 3


def test_train_steps_with_8bit_moments_match_the_reference():
    """8-bit moments.  The first step's update reads the moments before
    they are quantized, so its params are held at PARAM_TOL like the f32
    moments'.  Its quantization then meets a few codes whose quotient
    ``x / scale`` lies within the gradients' 1e-6 of a rounding boundary
    (measured 1-9 of each leaf's 32768-131072 codes), and there the two
    packages' codes differ by one.  From the second step on such a
    difference is amplified: most ``v`` codes of a row are 0 next to its
    absmax (``v`` is a squared gradient), so ``sqrt(v_hat) + eps`` is
    ``eps`` and the element moves by ``lr * m_hat / eps``, whose one-code
    difference is about ``lr * scale / eps``.  That is the reference's
    algorithm, not the port's: the params after three steps differ by
    about 2e-3 normwise and the loss by QUANT_LOSS_RTOL (measured 4.7e-4
    relative at the third step), and the codes after it by several.  So
    after the first step the codes are held to a difference of at most
    one, at under QUANT_CODES of them, and the params at PARAM_TOL; the
    loss at every step at LOSS_RTOL until the amplified steps reach it,
    then at QUANT_LOSS_RTOL; the params stay finite.  The stacked biases' moments are quantized too (each
    is a [layers, width] leaf), and their codes follow gradient elements
    that may be a cancelling sum's remainder, known to a few digits
    (module docstring): their params are held at BIAS_TOL after the first
    step, their codes not at all."""
    for i, state, m, ref_state, ref_m in _run_both(1, "float32", True):
        tol = LOSS_RTOL if i < 2 else QUANT_LOSS_RTOL
        assert abs(float(m["loss"]) - float(ref_m["loss"])) <= tol * abs(
            float(ref_m["loss"]))
        assert all(torch.isfinite(p).all()
                   for p in tree_paths(state["params"]).values())
        if i > 0:
            continue
        _check_params(state, ref_state, i)
        got = tree_paths(state["opt"])
        for k, w in tree_paths(ref_state["opt"]).items():
            if k.endswith("/q") and not k.endswith("/b/q"):
                d = np.abs(got[k].numpy().astype(int) - w.astype(int))
                assert d.max() <= 1, k
                assert np.count_nonzero(d) <= QUANT_CODES * d.size, k


def _tiny_ffn_params(d=24, hid=32, seed=0):
    """The reference's test's FFN (``tests/test_sparse_ffn.py``)."""
    rng = np.random.default_rng(seed)
    return {"gate": {"w": rng.normal(size=(d, hid), scale=0.3)},
            "up": {"w": rng.normal(size=(d, hid), scale=0.3)},
            "down": {"w": rng.normal(size=(hid, d), scale=0.3)}}


def test_sparse_ffn_train_step_matches_the_reference():
    p = _tiny_ffn_params(seed=4)
    ref = RefSparseFFN.from_params(p, keep_density=0.5, path="spgemm")
    sp = SparseFFN.from_params(p, keep_density=0.5, path="spgemm",
                               device="cpu")
    for name in ("gate", "up", "down"):   # one mask, one value order
        np.testing.assert_array_equal(
            getattr(sp, name).w_values.numpy(),
            np.asarray(getattr(ref, name).w_csc.values, np.float32))
    ref_step, ref_state = ref_build_sparse_ffn_train_step(ref, lr=5e-2)
    step, state = build_sparse_ffn_train_step(sp, lr=5e-2)
    before = sp.gate.w_values.clone()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(6, 24)).astype(np.float32)
    y = rng.normal(size=(6, 24)).astype(np.float32)
    losses = []
    for _ in range(6):
        state, m = step(state, (torch.from_numpy(x), torch.from_numpy(y)))
        ref_state, ref_m = ref_step(ref_state, (jnp.asarray(x),
                                                jnp.asarray(y)))
        assert isinstance(m["loss"], torch.Tensor)
        losses.append(float(m["loss"]))
        assert abs(losses[-1] - float(ref_m["loss"])) <= LOSS_RTOL * abs(
            float(ref_m["loss"]))
    assert losses[-1] < 0.7 * losses[0], losses
    assert np.isfinite(losses).all()
    # the step trains copies: the FFN's own values stay as they were
    assert torch.equal(sp.gate.w_values, before)
    assert not torch.equal(state["params"]["gate"], before)
