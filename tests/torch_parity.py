"""Shared helpers of the port's parity tests (``tests/test_torch_*.py``):
operands built once with numpy from a seed and handed to both packages as
numpy arrays, and the comparisons the tests state."""

from __future__ import annotations

import numpy as np
import torch

from repro.sparse.format import CSC as RefCSC
from repro_torch.convert import batched_csc_from_reference, csc_from_reference
from repro_torch.sparse import generate as tgen
from repro_torch.sparse.format import CSC, _np, csc_from_dense

#: the nine methods with a kernel family (the JAX package's pallas set)
KERNEL_METHODS = ("spa", "spars-16/64", "spars-40/40", "h-spa-16/64",
                  "h-spa-40/40", "hash-32/256", "hash-256/256",
                  "h-hash-32/256", "h-hash-256/256")

# XLA on the CPU and torch on the CPU may round a real-valued product or sum
# differently in the last place (different vectorization of the same
# multiply and add); integer-valued inputs leave no rounding, so they are
# compared with atol=0.
REAL_RTOL = REAL_ATOL = 1e-6

# the fused engine's reference sums each slot through one-hot matmuls over
# 128-product windows, the port in stream order one product at a time: real
# values may differ by reassociation, so they are held to the reference's
# own fused-engine tolerance (tests/test_fused_engine.py)
FUSED_RTOL, FUSED_ATOL = 1e-5, 1e-6


def to_ref(m: CSC) -> RefCSC:
    """The JAX package's CSC of a port CSC, through numpy."""
    nnz = m.nnz
    return RefCSC(_np(m.values)[:nnz], _np(m.row_indices)[:nnz].astype(
        np.int32), _np(m.col_ptr).astype(np.int32), tuple(m.shape))


def to_port(m: RefCSC) -> CSC:
    return csc_from_reference(np.asarray(m.values), np.asarray(m.row_indices),
                              np.asarray(m.col_ptr), m.shape, device="cpu")


def integer_valued(m: CSC, seed: int = 0) -> CSC:
    """The same pattern with values in {-3..3} \\ {0}: every product and sum
    of the tests' sizes is an exact integer in f32."""
    rng = np.random.default_rng(seed)
    v = rng.integers(1, 4, size=m.capacity) * rng.choice([-1, 1],
                                                         size=m.capacity)
    return CSC(torch.from_numpy(v.astype(np.float64)), m.row_indices,
               m.col_ptr, m.shape)


def adversarial(name: str, seed: int = 0):
    """(a, b) port operand pairs stressing structural edge paths (the cases
    of the JAX package's differential harness, built the same way)."""
    rng = np.random.default_rng(seed)
    if name == "random":
        a = tgen.random_powerlaw_csc(36, 3.0, seed=seed)
        return a, a
    if name == "empty_cols":
        d = rng.normal(size=(32, 32)) * (rng.uniform(size=(32, 32)) < 0.15)
        d[:, ::2] = 0.0
        d[5] = 0.0
        a = csc_from_dense(d)
        return a, a
    if name == "all_dense_cols":
        a = csc_from_dense(rng.normal(size=(20, 20)))
        return a, a
    if name == "single_row":
        d = np.zeros((24, 24))
        d[3] = rng.normal(size=24)
        d[3, 3] = 1.5
        a = csc_from_dense(d)
        return a, a
    if name == "dup_heavy":
        d = np.zeros((24, 24))
        d[:4] = rng.normal(size=(4, 24))
        d[np.abs(d) < 0.3] = 0.0
        d[0, :] = 1.0
        b_d = np.zeros((24, 24))
        b_d[:4] = rng.normal(size=(4, 24))
        return csc_from_dense(d), csc_from_dense(b_d)
    if name == "empty":
        a = tgen.random_uniform_csc(16, 0, seed=seed)
        return a, a
    if name == "empty_a":
        return (csc_from_dense(np.zeros((12, 12))),
                csc_from_dense(rng.normal(size=(12, 12))))
    if name == "rect_chain":
        return (tgen.random_density_csc(18, 30, 0.12, seed=seed),
                tgen.random_density_csc(30, 11, 0.2, seed=seed + 1))
    raise AssertionError(name)


ADVERSARIAL = ("random", "empty_cols", "all_dense_cols", "single_row",
               "dup_heavy", "empty", "empty_a", "rect_chain")


def assert_same_csc(got: CSC, want: RefCSC, *, exact: bool,
                    rtol: float = REAL_RTOL, atol: float = REAL_ATOL) -> None:
    """Identical structure; values equal (exact) or within rtol/atol."""
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.col_ptr), np.asarray(want.col_ptr))
    nnz = got.nnz
    np.testing.assert_array_equal(_np(got.row_indices)[:nnz],
                                  np.asarray(want.row_indices)[:nnz])
    gv = _np(got.values)[:nnz]
    wv = np.asarray(want.values)[:nnz]
    assert gv.dtype == wv.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(gv, wv)
    else:
        np.testing.assert_allclose(gv, wv, rtol=rtol, atol=atol)


def assert_bit_identical(got: CSC, want: RefCSC) -> None:
    """The port's CSC equals the reference's bit for bit: shape, col_ptr,
    each column's rows in storage order, and values of the same dtype."""
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.col_ptr), np.asarray(want.col_ptr))
    nnz = got.nnz
    np.testing.assert_array_equal(_np(got.row_indices)[:nnz],
                                  np.asarray(want.row_indices)[:nnz])
    gv, wv = _np(got.values)[:nnz], np.asarray(want.values)[:nnz]
    assert gv.dtype == wv.dtype
    assert np.array_equal(np.ascontiguousarray(gv).view(np.uint8),
                          np.ascontiguousarray(wv).view(np.uint8))


def check_spgemm_parity(a: CSC, b: CSC, method: str, values: str) -> None:
    """C = A·B through both packages' default device paths, compared.

    ``values`` is "int" (values replaced by small integers, compared with
    atol=0) or "real" (the operands' own values, REAL_*TOL).  The reference
    runs ``plan.execute`` of a pallas plan — the body of its
    ``spgemm(..., backend="pallas")`` — so that its stats are readable.
    """
    from repro.core.planner import plan_spgemm as ref_plan_spgemm
    from repro_torch.core import cached_plan, spgemm

    if values == "int":
        same = a is b
        a = integer_valued(a, seed=1)
        b = a if same else integer_valued(b, seed=2)
    ra, rb = to_ref(a), to_ref(b)
    ref_plan = ref_plan_spgemm(ra, rb, method, backend="pallas")
    ref_stats: dict = {}
    want = ref_plan.execute(ra, rb, stats=ref_stats)

    got = spgemm(a, b, method, device="cpu")
    assert_same_csc(got, want, exact=values == "int")
    port_plan = cached_plan(a, b, method, device="cpu")
    port_stats: dict = {}
    again = port_plan.execute(a, b, stats=port_stats)
    assert port_stats["n_launches"] == ref_stats["n_launches"]
    assert port_stats["tile_shapes"] == ref_stats["tile_shapes"]
    assert_same_groups(port_plan, ref_plan)
    np.testing.assert_array_equal(_np(again.values), _np(got.values))


def assert_same_groups(port_plan, ref_plan) -> None:
    """The two plans launch the same groups: kinds, columns, h and steps."""
    pg, rg = port_plan.layout.groups, ref_plan.pallas.groups
    assert [g.kind for g in pg] == [g.kind for g in rg]
    for p, r in zip(pg, rg):
        np.testing.assert_array_equal(p.cols, np.asarray(r.cols))
        assert p.h == r.h
        if r.steps is None:
            assert p.steps is None
        else:
            np.testing.assert_array_equal(_np(p.steps), np.asarray(r.steps))
        np.testing.assert_array_equal(_np(p.b_rows), np.asarray(r.b_rows))
        np.testing.assert_array_equal(_np(p.b_nnz), np.asarray(r.b_nnz))


def assert_same_stream(got, want) -> None:
    """A port ``ProductStream`` equals the reference's, array for array."""
    assert tuple(got.shape) == tuple(want.shape)
    for f in ("a_pos", "b_pos", "seg_starts", "c_rows", "c_col_ptr"):
        g, w = getattr(got, f), np.asarray(getattr(want, f))
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.n_products == want.n_products and got.nnz == want.nnz


def ref_fused(a: CSC, b: CSC, inputs, method: str = "spa") -> list:
    """The reference's fused function on its own plan of (a, b), forward and
    backward: for each ``(a_vals, b_vals, w)`` of numpy arrays, the C values
    ``fn(a_vals, b_vals)`` and the gradients of ``sum(w * fn(a_vals,
    b_vals))`` with respect to both, as numpy arrays.

    ``fn`` is ``repro.core.pallas_stream.fused_fn`` of a pallas plan, with
    its Pallas kernel in interpret mode (its default); one ``jax.jit`` serves
    all ``inputs``, so the kernel is traced once per pattern.
    """
    import jax
    import jax.numpy as jnp
    from repro.core.pallas_stream import fused_fn
    from repro.core.planner import plan_spgemm as ref_plan_spgemm

    fn = fused_fn(ref_plan_spgemm(to_ref(a), to_ref(b), method,
                                  backend="pallas"))

    @jax.jit
    def forward_backward(x, y, w):
        c, pullback = jax.vjp(fn, x, y)
        return (c, *pullback(w))

    return [tuple(np.asarray(t) for t in forward_backward(
        jnp.asarray(x, jnp.float32), jnp.asarray(y, jnp.float32),
        jnp.asarray(w, jnp.float32))) for x, y, w in inputs]


def value_stack(m: CSC, batch: int, values: str, seed: int) -> np.ndarray:
    """``[batch, nnz]`` f32 value sets for the pattern of ``m``, each row
    different: integers in {-3..3} \\ {0} ("int", exact in f32 at the
    tests' sizes) or standard normal ("real")."""
    rng = np.random.default_rng(seed)
    if values == "int":
        v = rng.integers(1, 4, (batch, m.nnz)) * rng.choice([-1, 1],
                                                          (batch, m.nnz))
    else:
        v = rng.standard_normal((batch, m.nnz))
    return v.astype(np.float32)


def batched_pair(a: CSC, b: CSC, values: str, batch: int):
    """((A, B) port BatchedCSCs on the CPU, (A, B) JAX-package BatchedCSCs)
    of different value stacks, A's from seed 1 and B's from seed 2: mixed
    operands even where ``a is b``."""
    from repro.sparse.format import BatchedCSC as RefBatchedCSC

    port, ref = [], []
    for m, seed in ((a, 1), (b, 2)):
        v = value_stack(m, batch, values, seed)
        r = to_ref(m)
        port.append(batched_csc_from_reference(v, r.row_indices, r.col_ptr,
                                               r.shape, device="cpu"))
        ref.append(RefBatchedCSC.from_values(r, v))
    return tuple(port), tuple(ref)


def check_batched_parity(a: CSC, b: CSC, method: str, values: str,
                         batch: int = 2) -> None:
    """B multiplies through both packages' batched per-group paths,
    compared element by element.

    The reference runs ``execute_batched`` of a pallas plan (its Pallas
    kernels vmapped, in interpret mode); the port ``spgemm_batched`` with
    ``device="cpu"`` (the batched kernels' plain versions), then
    ``execute_batched`` of the cached plan for its stats.  Structure must
    be identical, values exact on integer values and within
    ``REAL_RTOL``/``REAL_ATOL`` otherwise; both must launch the same groups
    and report the same tiles.
    """
    from repro.core.planner import plan_spgemm as ref_plan_spgemm
    from repro_torch.core import cached_plan, spgemm_batched

    (pa, pb), (ra, rb) = batched_pair(a, b, values, batch)
    ref_plan = ref_plan_spgemm(ra[0], rb[0], method, backend="pallas")
    ref_stats: dict = {}
    want = ref_plan.execute_batched(ra, rb, stats=ref_stats)

    got = spgemm_batched(pa, pb, method, device="cpu")
    assert len(got) == len(want) == batch
    for g, w in zip(got, want):
        assert_same_csc(g, w, exact=values == "int")
    port_plan = cached_plan(pa[0], pb[0], method, device="cpu")
    port_stats: dict = {}
    again = port_plan.execute_batched(pa, pb, stats=port_stats)
    for key in ("n_launches", "tile_shapes", "peak_tile_elems", "batch"):
        assert port_stats[key] == ref_stats[key], key
    assert_same_groups(port_plan, ref_plan)
    for g, w in zip(again, got):
        np.testing.assert_array_equal(_np(g.values), _np(w.values))
