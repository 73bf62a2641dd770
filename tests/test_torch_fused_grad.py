"""Gradients through the port's fused engine, on the CPU.

``torch.autograd.grad`` through ``plan.stream_apply(x, y, engine="fused")``
(two more K1 replays, plain versions here) against the JAX package's
``jax.vjp`` of its ``fused_fn`` (Pallas in interpret mode): within
``FUSED_RTOL``/``FUSED_ATOL`` on real values, exact (atol=0) on integer
values with integer cotangent weights.  Also against the dense-matmul
oracle and finite differences with the reference's own tolerances
(``tests/test_fused_engine.py``), and on the empty-gradient-segment case.
"""

import functools
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import fused_stream, plan_spgemm
from repro_torch.sparse.format import CSC, _np, csc_from_dense
from torch_parity import (
    ADVERSARIAL,
    FUSED_ATOL,
    FUSED_RTOL,
    adversarial,
    integer_valued,
    ref_fused,
)

VALUES = ("int", "real")


def _inputs(case):
    """{values: (a, b, a_vals, b_vals, w)}: the operands and, as numpy f32,
    their values and the cotangent weights, integer or real."""
    a, b = adversarial(case)
    same = a is b
    out = {}
    for values in VALUES:
        if values == "int":
            ai = integer_valued(a, seed=1)
            bi = ai if same else integer_valued(b, seed=2)
        else:
            ai, bi = a, b
        n_c = plan_spgemm(ai, bi, device="cpu").stream.nnz
        rng = np.random.default_rng(9)
        w = (rng.integers(-3, 4, n_c) if values == "int"
             else rng.standard_normal(n_c))
        out[values] = (ai, bi, _np(ai.values).astype(np.float32),
                       _np(bi.values).astype(np.float32),
                       w.astype(np.float32))
    return out


@functools.lru_cache(maxsize=None)
def _case(case):
    """The inputs of ``case`` and the reference's results on them (one
    trace of the reference's kernel for both value kinds)."""
    inputs = _inputs(case)
    a, b = inputs["int"][:2]
    refs = ref_fused(a, b, [inputs[v][2:] for v in VALUES])
    return inputs, dict(zip(VALUES, refs))


def _port(a, b, av, bv, w):
    plan = plan_spgemm(a, b, device="cpu")
    x = torch.from_numpy(av).requires_grad_()
    y = torch.from_numpy(bv).requires_grad_()
    c = plan.stream_apply(x, y, engine="fused")
    ga, gb = torch.autograd.grad((torch.from_numpy(w) * c).sum(), (x, y))
    return c.detach().numpy(), ga.numpy(), gb.numpy()


@pytest.mark.parametrize("values", VALUES)
@pytest.mark.parametrize("case", ADVERSARIAL)
def test_grad_matches_reference(case, values):
    inputs, refs = _case(case)
    got = _port(*inputs[values])
    for name, g, w in zip(("c", "grad_a", "grad_b"), got, refs[values]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32, name
        if values == "int":
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=FUSED_RTOL,
                                       atol=FUSED_ATOL, err_msg=name)


def _stored_coords(m: CSC):
    cp = _np(m.col_ptr)
    rows = _np(m.row_indices)[: m.nnz].astype(np.int64)
    cols = np.repeat(np.arange(m.n_cols), np.diff(cp))
    return torch.from_numpy(rows), torch.from_numpy(cols)


@pytest.mark.parametrize("case", ["random", "dup_heavy", "rect_chain",
                                  "single_row", "empty_cols"])
def test_grad_matches_dense_matmul_oracle(case):
    a, b = adversarial(case)
    av = _np(a.values).astype(np.float32)
    bv = _np(b.values).astype(np.float32)
    _, ga, gb = _port(a, b, av, bv, np.ones(
        plan_spgemm(a, b, device="cpu").stream.nnz, np.float32))
    x = torch.from_numpy(av).double().requires_grad_()
    y = torch.from_numpy(bv).double().requires_grad_()
    ad = torch.zeros(a.shape, dtype=torch.float64).index_put(
        _stored_coords(a), x)
    bd = torch.zeros(b.shape, dtype=torch.float64).index_put(
        _stored_coords(b), y)
    da, db = torch.autograd.grad((ad @ bd).sum(), (x, y))
    np.testing.assert_allclose(ga, da.numpy(), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gb, db.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", ["random", "dup_heavy", "single_row",
                                  "rect_chain"])
def test_grad_matches_finite_differences(case):
    a, b = adversarial(case)
    plan = plan_spgemm(a, b, device="cpu")
    av = _np(a.values).astype(np.float32)
    bv = _np(b.values).astype(np.float32)

    def loss(x, y):
        return float(plan.stream_apply(torch.from_numpy(x),
                                       torch.from_numpy(y),
                                       engine="fused").sum())

    _, ga, gb = _port(a, b, av, bv, np.ones(plan.stream.nnz, np.float32))
    rng = np.random.default_rng(0)
    eps = 1e-2
    for arr, grad, which in ((av, ga, 0), (bv, gb, 1)):
        for i in rng.choice(len(arr), size=min(4, len(arr)), replace=False):
            hi, lo = arr.copy(), arr.copy()
            hi[i] += eps
            lo[i] -= eps
            fd = ((loss(hi, bv) - loss(lo, bv)) if which == 0
                  else (loss(av, hi) - loss(av, lo))) / (2 * eps)
            np.testing.assert_allclose(grad[i], fd, rtol=5e-2, atol=5e-3,
                                       err_msg=f"{which}/{i}")


def test_empty_grad_segment_gets_exact_zero():
    """A stored A value with no products (B's row 0 is empty) is absent
    from the grad view, and its cotangent is exactly 0."""
    a = csc_from_dense(np.array([[1.0, 2.0], [0.0, 3.0]]))
    b = csc_from_dense(np.array([[0.0, 0.0], [4.0, 5.0]]))
    plan = plan_spgemm(a, b, device="cpu")
    assert fused_stream(plan).grad_a.n_out < a.nnz
    x = a.values.float().requires_grad_()
    y = b.values.float().requires_grad_()
    ga, gb = torch.autograd.grad(
        plan.stream_apply(x, y, engine="fused").sum(), (x, y))
    assert torch.equal(ga, torch.tensor([0.0, 9.0, 9.0]))
    assert torch.equal(gb, torch.tensor([5.0, 5.0]))


def test_operand_used_twice_gets_both_gradients():
    """C = A·A with one value vector: its gradient is the sum of both
    replays, as the reference's."""
    a, _ = adversarial("random")
    a = integer_valued(a, seed=4)
    plan = plan_spgemm(a, a, device="cpu")
    av = _np(a.values).astype(np.float32)
    w = np.random.default_rng(2).integers(-3, 4, plan.stream.nnz).astype(
        np.float32)
    (_, ref_ga, ref_gb), = ref_fused(a, a, [(av, av, w)])
    x = torch.from_numpy(av).requires_grad_()
    c = plan.stream_apply(x, x, engine="fused")
    g, = torch.autograd.grad((torch.from_numpy(w) * c).sum(), x)
    np.testing.assert_array_equal(g.numpy(), ref_ga + ref_gb)


def test_gradients_keep_the_operands_dtype_and_length():
    """f64 operands get f64 gradients through the f32 cast, and an
    oversized value vector an oversized gradient, 0 past nnz."""
    a, b = adversarial("dup_heavy")
    plan = plan_spgemm(a, b, device="cpu")
    x = torch.cat([a.values.double(), torch.full((3,), 7.0,
                   dtype=torch.float64)]).requires_grad_()
    y = b.values.double().requires_grad_()
    ga, gb = torch.autograd.grad(
        plan.stream_apply(x, y, engine="fused").sum(), (x, y))
    assert ga.dtype == gb.dtype == torch.float64
    assert ga.shape == x.shape and torch.equal(ga[-3:], torch.zeros(3,
                                               dtype=torch.float64))


def test_unrequested_replay_is_skipped(monkeypatch):
    """Only the gradient asked for is replayed."""
    # the module: the package's attribute of that name is the function
    mod = sys.modules["repro_torch.core.fused_stream"]
    calls = []
    real = mod._fused_call
    monkeypatch.setattr(mod, "_fused_call", lambda v, x, y: calls.append(v)
                        or real(v, x, y))
    a, b = adversarial("random")
    plan = plan_spgemm(a, b, device="cpu")
    x = a.values.float().requires_grad_()
    y = b.values.float()
    torch.autograd.grad(plan.stream_apply(x, y, engine="fused").sum(), x)
    views = fused_stream(plan)
    assert calls == [views.forward, views.grad_a]


@pytest.mark.parametrize("engine", [None, "stream", "naive", "bogus"])
def test_stream_apply_only_has_the_fused_engine(engine):
    """Besides "fused", stream_apply takes the torch stream (None and
    "stream", on this "cuda" plan too): it equals the torch backend's
    execute; any other spelling raises."""
    a, b = adversarial("random")
    plan = plan_spgemm(a, b, device="cpu")
    if engine in ("naive", "bogus"):
        with pytest.raises(ValueError, match="engine=None/'stream'/'fused'"):
            plan.stream_apply(a.values, b.values, engine=engine)
        return
    want = plan_spgemm(a, b, backend="torch", device="cpu").execute(a, b)
    got = plan.stream_apply(a.values, b.values, engine=engine)
    assert torch.equal(got, want.values)


def test_stream_apply_checks_operand_lengths():
    a, b = adversarial("random")
    plan = plan_spgemm(a, b, device="cpu")
    with pytest.raises(ValueError, match="values"):
        plan.stream_apply(a.values[:-1], b.values, engine="fused")
