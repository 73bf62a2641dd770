"""The port's format, generator, loader, dense-oracle and expansion
additions against the JAX package's functions, mirroring
``test_sparse_formats.py``, ``test_suitesparse.py`` and the expansion
checks of ``test_spgemm_algorithms.py``: CSR and COO, ``csc_from_coo``,
``csc_to_csr``/``csr_to_csc``, ``transpose_csc``, ``segment_reduce``,
``csc_bit_identical``, ``random_banded_csc``, ``load_or_synthesize`` (its
cache files are the reference's format, read by either package),
``spgemm_dense``/``dense_product`` and ``expand_products``/
``product_col_ptr``/``spgemm_expand`` — array for array on the same numpy
inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.sparse.format as rf
from repro.core import expand as ref_expand
from repro.core import reference as ref_reference
from repro.sparse import generate as ref_generate
from repro.sparse import suitesparse as ref_suitesparse
from repro_torch.core import expand, reference
from repro_torch.sparse import generate, suitesparse
from repro_torch.sparse.format import (
    COO,
    CSC,
    _np,
    csc_bit_identical,
    csc_from_coo,
    csc_from_dense,
    csc_to_csr,
    csc_to_dense,
    csr_to_csc,
    segment_reduce,
    transpose_csc,
    validate_csc,
)
from torch_parity import ADVERSARIAL, adversarial, assert_bit_identical, \
    to_ref


def _dense(seed, shape=(17, 23), density=0.3):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=shape)
    return d * (rng.uniform(size=shape) < density)


@pytest.mark.parametrize("seed", range(6))
def test_csr_roundtrip_and_transpose_match_reference(seed):
    d = _dense(seed, shape=(1 + seed * 3, 20 - seed * 2))
    m = csc_from_dense(d)
    r = csc_to_csr(m)
    ref_r = rf.csc_to_csr(to_ref(m))
    np.testing.assert_array_equal(_np(r.values), np.asarray(ref_r.values))
    np.testing.assert_array_equal(_np(r.col_indices),
                                  np.asarray(ref_r.col_indices))
    np.testing.assert_array_equal(_np(r.row_ptr), np.asarray(ref_r.row_ptr))
    assert r.nnz == ref_r.nnz and tuple(r.shape) == tuple(ref_r.shape)
    back = csr_to_csc(r)
    validate_csc(back, sorted_rows=True)
    assert_bit_identical(back, rf.csr_to_csc(ref_r))
    assert csc_bit_identical(back, m)
    t = transpose_csc(m)
    assert_bit_identical(t, rf.transpose_csc(to_ref(m)))
    np.testing.assert_array_equal(csc_to_dense(t).numpy(), d.T)


def test_coo_duplicate_accumulation_matches_reference():
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 5, 60).astype(np.int32)
    cols = rng.integers(0, 7, 60).astype(np.int32)
    vals = rng.normal(size=60)
    coo = COO(rows, cols, torch.from_numpy(vals), (5, 7))
    assert coo.nnz == 60
    for dup in (True, False):
        got = csc_from_coo(coo, sum_duplicates=dup)
        want = rf.csc_from_coo(rf.COO(rows, cols, vals, (5, 7)),
                               sum_duplicates=dup)
        assert_bit_identical(got, want)
    small = csc_from_coo(COO(np.array([0, 0, 1], np.int32),
                             np.array([0, 0, 1], np.int32),
                             torch.tensor([1.0, 2.0, 3.0]), (2, 2)))
    np.testing.assert_array_equal(csc_to_dense(small).numpy(),
                                  [[3.0, 0.0], [0.0, 3.0]])


def test_segment_reduce_matches_reference():
    v = np.random.default_rng(1).normal(size=(4, 40))
    for starts in (np.array([0, 3, 3, 17, 39]), np.array([0]),
                   np.zeros(0, np.int64)):
        np.testing.assert_array_equal(segment_reduce(v, starts, axis=1),
                                      rf.segment_reduce(v, starts, axis=1))
        np.testing.assert_array_equal(segment_reduce(v[0], starts),
                                      rf.segment_reduce(v[0], starts))


def test_csc_bit_identical_sees_order_and_values():
    a = csc_from_dense(_dense(4))
    assert csc_bit_identical(a, a)
    assert csc_bit_identical(a, CSC(a.values.clone(), a.row_indices.copy(),
                                    a.col_ptr.copy(), a.shape))
    v = a.values.clone()
    v[0] = v[0] + 1
    assert not csc_bit_identical(a, CSC(v, a.row_indices, a.col_ptr,
                                        a.shape))
    rows = a.row_indices.copy()
    lo, hi = int(a.col_ptr[0]), int(a.col_ptr[1])
    assert hi - lo >= 2
    rows[lo:hi] = rows[lo:hi][::-1]
    assert not csc_bit_identical(a, CSC(a.values, rows, a.col_ptr, a.shape))
    assert rf.csc_bit_identical(to_ref(a), to_ref(a))


@pytest.mark.parametrize("n, bw, fill, seed", [
    (40, 3, 1.0, 0), (64, 5, 0.6, 1), (30, 0, 1.0, 2), (25, 30, 0.3, 3)])
def test_banded_generator_matches_reference(n, bw, fill, seed):
    got = generate.random_banded_csc(n, bw, fill=fill, seed=seed)
    want = ref_generate.random_banded_csc(n, bw, fill=fill, seed=seed)
    validate_csc(got, sorted_rows=True)
    assert_bit_identical(got, want)
    d = csc_to_dense(got).numpy()
    assert (np.diag(d) != 0).all()
    assert not np.triu(d, bw + 1).any() and not np.tril(d, -bw - 1).any()


def test_load_or_synthesize_caches_in_the_reference_format(tmp_path):
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    m1, st1 = suitesparse.load_or_synthesize("olm1000", seed=0,
                                             cache_dir=str(port_dir))
    m2, st2 = suitesparse.load_or_synthesize("olm1000", seed=0,
                                             cache_dir=str(port_dir))
    assert csc_bit_identical(m1, m2) and st1 == st2
    fresh, _ = suitesparse.synthesize_suitesparse("olm1000", seed=0)
    assert csc_bit_identical(m1, fresh)
    assert sorted(p.name for p in port_dir.iterdir()) == ["olm1000_s0.npz"]
    # the reference's loader reads the port's file, and the port reads the
    # reference's (whose matrix differs: it seeds with hash(name))
    r1, _ = ref_suitesparse.load_or_synthesize("olm1000", seed=0,
                                               cache_dir=str(port_dir))
    assert_bit_identical(m1, r1)
    r2, _ = ref_suitesparse.load_or_synthesize("olm1000", seed=0,
                                               cache_dir=str(ref_dir))
    m3, _ = suitesparse.load_or_synthesize("olm1000", seed=0,
                                           cache_dir=str(ref_dir))
    assert_bit_identical(m3, r2)
    m4, _ = suitesparse.load_or_synthesize("olm1000", seed=0,
                                           cache_dir=None)
    assert csc_bit_identical(m4, fresh)


def test_load_or_synthesize_replaces_a_corrupt_entry(tmp_path):
    (tmp_path / "olm1000_s1.npz").write_bytes(b"not an npz")
    m, _ = suitesparse.load_or_synthesize("olm1000", seed=1,
                                          cache_dir=str(tmp_path))
    assert csc_bit_identical(m, suitesparse.synthesize_suitesparse(
        "olm1000", seed=1)[0])
    again, _ = suitesparse.load_or_synthesize("olm1000", seed=1,
                                              cache_dir=str(tmp_path))
    assert csc_bit_identical(again, m)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_dense_oracle_and_expansion_match_reference(case):
    a, b = adversarial(case)
    ra, rb = to_ref(a), to_ref(b)
    want = ref_reference.dense_product(ra, rb)
    got = reference.dense_product(a, b)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    c = reference.spgemm_dense(a, b)
    validate_csc(c, sorted_rows=True)
    rc = ref_reference.spgemm_dense(ra, rb)
    np.testing.assert_array_equal(_np(c.col_ptr), np.asarray(rc.col_ptr))
    coo, ref_coo = expand.expand_products(a, b), \
        ref_expand.expand_products(ra, rb)
    for f in ("rows", "cols", "values"):
        np.testing.assert_array_equal(_np(getattr(coo, f)),
                                      np.asarray(getattr(ref_coo, f)))
    assert coo.shape == ref_coo.shape
    np.testing.assert_array_equal(expand.product_col_ptr(a, b),
                                  ref_expand.product_col_ptr(ra, rb))
    assert_bit_identical(expand.spgemm_expand(a, b),
                         ref_expand.spgemm_expand(ra, rb))


def test_expand_is_exact_product_stream():
    from repro_torch.sparse.stats import ops_per_column

    a = generate.random_powerlaw_csc(60, 3.0, seed=7)
    coo = expand.expand_products(a, a)
    assert coo.nnz == ops_per_column(a, a).sum()
    d = csc_to_dense(expand.spgemm_expand(a, a))
    np.testing.assert_allclose(d.numpy(),
                               reference.dense_product(a, a).numpy(),
                               rtol=1e-9)
