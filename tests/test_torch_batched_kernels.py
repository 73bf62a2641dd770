"""The batched kernels K1-b … K4-b: the port's batched wrappers against the
JAX package's vmapped Pallas kernels (``spa_spgemm_batched``,
``spars_spgemm_batched``, ``hash_spgemm_batched``, ``fused_fn_batched``) on
the same operands, B = 2 value sets each.

The JAX kernels run in interpret mode; the port's wrappers get CPU tensors,
so they run their batched plain versions, which carry the batch axis in
their tensor ops (the CUDA kernels are held against them on the card, in
test_torch_gpu.py and chip_smoke.py).  Integer values must agree with
atol=0, real values within REAL_RTOL/REAL_ATOL (K2-K4) or
FUSED_RTOL/FUSED_ATOL (K1, whose reference sums through one-hot matmuls);
keys and flags, which do not depend on values, exactly.  Each batched plain
version's slice b also equals the unbatched wrapper on value set b.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.core import pallas_stream as ref_pallas_stream
from repro.core.planner import plan_spgemm as ref_plan_spgemm
from repro.kernels.hash_spgemm import hash_spgemm_batched as ref_hash_b
from repro.kernels.spa import spa_spgemm_batched as ref_spa_b
from repro.kernels.spars import spars_spgemm_batched as ref_spars_b
from repro_torch import kernels
from repro_torch.core import fused_stream, plan_spgemm
from test_torch_fused import K1_CASES
from test_torch_kernels import BLOCK, CASES, operands
from torch_parity import (
    ADVERSARIAL,
    FUSED_ATOL,
    FUSED_RTOL,
    REAL_ATOL,
    REAL_RTOL,
    adversarial,
    to_ref,
    value_stack,
)

BATCH = 2


def _values(shape, values, rng) -> np.ndarray:
    if values == "int":
        v = rng.integers(1, 4, shape) * rng.choice([-1, 1], shape)
    else:
        v = rng.standard_normal(shape)
    return v.astype(np.float32)


def batched_operands(case, values):
    """The padded operands of one case with B value sets per operand (pads
    stay 0), A's and B's drawn apart."""
    op = operands(case, values)
    rng = np.random.default_rng(8)
    for name in ("a_vals", "b_vals"):
        v = op[name]
        op[name] = torch.from_numpy(
            _values((BATCH,) + tuple(v.shape), values, rng)) * (v != 0)
    return op


def _ab(op):
    return (op["a_rows"], op["a_vals"], op["a_nnz"], op["b_rows"],
            op["b_vals"], op["b_nnz"])


def _slice(op, b):
    return (op["a_rows"], op["a_vals"][b].contiguous(), op["a_nnz"],
            op["b_rows"], op["b_vals"][b].contiguous(), op["b_nnz"])


def _jax(x):
    return jnp.asarray(x.numpy())


def _assert_values(got, want, values, rtol=REAL_RTOL, atol=REAL_ATOL):
    got, want = got.numpy(), np.asarray(want)
    assert got.shape == want.shape
    if values == "int":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_spa_batched_matches_pallas(case, values):
    op = batched_operands(case, values)
    got = kernels.spa_spgemm_batched(*_ab(op), m=op["m"], block_cols=BLOCK)
    want = ref_spa_b(*map(_jax, _ab(op)), m=op["m"], block_cols=BLOCK,
                     interpret=True)
    _assert_values(got, want, values)
    for b in range(BATCH):
        assert torch.equal(got[b], kernels.spa_spgemm(
            *_slice(op, b), m=op["m"], block_cols=BLOCK))


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_spars_batched_matches_pallas(case, values):
    op = batched_operands(case, values)
    acc, flags = kernels.spars_spgemm_batched(*_ab(op), op["steps"],
                                              m=op["m"], block_cols=BLOCK)
    want_acc, want_flags = ref_spars_b(*map(_jax, _ab(op)), _jax(op["steps"]),
                                       m=op["m"], block_cols=BLOCK,
                                       interpret=True)
    _assert_values(acc, want_acc, values)
    np.testing.assert_array_equal(flags.numpy(), np.asarray(want_flags))
    for b in range(BATCH):
        one = kernels.spars_spgemm(*_slice(op, b), op["steps"], m=op["m"],
                                   block_cols=BLOCK)
        assert torch.equal(acc[b], one[0]) and torch.equal(flags[b], one[1])


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", CASES)
def test_hash_batched_matches_pallas(case, values):
    """Keys slot for slot and values; the keys are the same in every batch
    element (probing depends on rows alone)."""
    op = batched_operands(case, values)
    keys, vals = kernels.hash_spgemm_batched(
        *_ab(op), op["steps"], m=op["m"], h=op["h"], block_cols=BLOCK)
    want_keys, want_vals = ref_hash_b(*map(_jax, _ab(op)), _jax(op["steps"]),
                                      m=op["m"], h=op["h"], block_cols=BLOCK,
                                      interpret=True)
    np.testing.assert_array_equal(keys.numpy(), np.asarray(want_keys))
    _assert_values(vals, want_vals, values)
    assert all(torch.equal(keys[b], keys[0]) for b in range(BATCH))
    for b in range(BATCH):
        one = kernels.hash_spgemm(*_slice(op, b), op["steps"], m=op["m"],
                                  h=op["h"], block_cols=BLOCK)
        assert torch.equal(keys[b], one[0]) and torch.equal(vals[b], one[1])


@pytest.mark.parametrize("values", ["int", "real"])
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_k1_batched_matches_fused_fn_batched(case, values):
    """K1-b on the plan's forward view against the reference's
    ``fused_fn_batched`` (``jit(vmap)`` of its fused contraction) on the
    same value stacks."""
    a, b = adversarial(case)
    av = value_stack(a, BATCH, values, seed=1)
    bv = value_stack(b, BATCH, values, seed=2)
    fn = ref_pallas_stream.fused_fn_batched(
        ref_plan_spgemm(to_ref(a), to_ref(b), "spa", backend="pallas"))
    want = fn(jnp.asarray(av), jnp.asarray(bv))
    view = fused_stream(plan_spgemm(a, b, "spa", device="cpu")).forward
    x, y = torch.from_numpy(av), torch.from_numpy(bv)
    got = kernels.fused_stream_batched(view.idx_x, view.idx_y, view.seg_ptr,
                                       x, y)
    _assert_values(got, want, values, FUSED_RTOL, FUSED_ATOL)
    for k in range(BATCH):
        assert torch.equal(got[k], kernels.fused_stream(
            view.idx_x, view.idx_y, view.seg_ptr, x[k], y[k]))


@pytest.mark.parametrize("case", sorted(K1_CASES))
def test_k1_batched_matches_vmapped_fused_call(case):
    """K1-b against ``jax.vmap`` of the reference's ``_fused_call`` on the
    segment-boundary cases of its own tests (integer values, atol=0)."""
    idx_x, idx_y, seg, n_out, block = K1_CASES[case]
    rng = np.random.default_rng(6)
    n_val = int(max(idx_x.max(), idx_y.max())) + 1
    x, y = (_values((BATCH, n_val), "int", rng) for _ in range(2))
    view = ref_pallas_stream._build_view(idx_x, idx_y, seg, block, n_out)
    want = jax.vmap(lambda u, v: ref_pallas_stream._fused_call(view, u, v))(
        jnp.asarray(x), jnp.asarray(y))
    seg_ptr = np.searchsorted(seg, np.arange(n_out + 1))
    got = kernels.fused_stream_batched(
        *(torch.as_tensor(np.asarray(t, np.int32))
          for t in (idx_x, idx_y, seg_ptr)),
        torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_k1_batched_zero_products():
    i32 = torch.zeros(0, dtype=torch.int32)
    v = torch.ones((3, 4))
    out = kernels.fused_stream_batched(
        i32, i32, torch.zeros(4, dtype=torch.int32), v, v)
    assert torch.equal(out, torch.zeros((3, 3)))
