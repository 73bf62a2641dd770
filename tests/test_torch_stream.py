"""The port's product stream and K1 views against the JAX package's.

``build_product_stream``, ``product_count``/``expand_positions`` and
``stream_seg_ids`` must give the reference's arrays exactly (they are
pattern-only integer work); the fused engine's gradient views must hold the
same products in the same order, compacted to the same ranks and scattered
through the same ``out_map`` as the reference's ``_grad_view`` builds, on
the adversarial patterns of the differential harness and small power-law
matrices.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import expand as ref_expand
from repro.core import fast as ref_fast
from repro.core import jax_stream as ref_jax_stream
from repro.core import pallas_stream as ref_pallas_stream
from repro_torch.core import expand, fast
from repro_torch.core.device_stream import check_int32_stream, stream_seg_ids
from repro_torch.core.fused_stream import _forward_view, _grad_view
from repro_torch.sparse import generate
from repro_torch.sparse.format import _np
from torch_parity import ADVERSARIAL, adversarial, assert_same_stream, to_ref

CASES = ADVERSARIAL + ("powerlaw_32", "powerlaw_64")


def _operands(case):
    if case.startswith("powerlaw_"):
        n = int(case.split("_")[1])
        a = generate.random_powerlaw_csc(n, 3.0, seed=n)
        return a, a
    return adversarial(case)


def _streams(case):
    a, b = _operands(case)
    return (fast.build_product_stream(a, b),
            ref_fast.build_product_stream(to_ref(a), to_ref(b)))


@pytest.mark.parametrize("case", CASES)
def test_product_stream_matches_reference(case):
    got, want = _streams(case)
    assert_same_stream(got, want)


def test_empty_stream_matches_reference():
    got, want = _streams("empty")
    assert got.n_products == 0 and got.nnz == 0
    assert_same_stream(got, want)


@pytest.mark.parametrize("case", CASES)
def test_expansion_matches_reference(case):
    a, b = _operands(case)
    args = (_np(a.col_ptr), _np(b.col_ptr), _np(b.row_indices))
    assert expand.product_count(*args) == ref_expand.product_count(*args)
    for g, w in zip(expand.expand_positions(*args),
                    ref_expand.expand_positions(*args)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("case", ["random", "dup_heavy", "rect_chain"])
def test_guard_matches_reference(case):
    """Above ``max_products`` both packages keep no stream; at it, both do."""
    a, b = _operands(case)
    p = expand.product_count(_np(a.col_ptr), _np(b.col_ptr),
                             _np(b.row_indices))
    assert p > 0
    assert fast.build_product_stream(a, b, p - 1) is None
    assert ref_fast.build_product_stream(to_ref(a), to_ref(b), p - 1) is None
    assert_same_stream(fast.build_product_stream(a, b, p),
                       ref_fast.build_product_stream(to_ref(a), to_ref(b), p))
    assert fast.STREAM_MAX_PRODUCTS == ref_fast.DEFAULT_STREAM_MAX_PRODUCTS


def test_stream_arrays_are_frozen():
    s, _ = _streams("random")
    for f in ("a_pos", "b_pos", "seg_starts", "c_rows", "c_col_ptr"):
        with pytest.raises(ValueError):
            getattr(s, f)[0] = 0


@pytest.mark.parametrize("case", CASES)
def test_seg_ids_match_reference(case):
    got, want = _streams(case)
    ids = stream_seg_ids(got)
    np.testing.assert_array_equal(ids, ref_jax_stream.stream_seg_ids(want))
    assert ids.dtype == np.int32


def _ref_ranks(view, p):
    """Global segment rank of each real product of a reference view."""
    seg_first = np.asarray(view.seg_first).astype(np.int64)
    local = np.asarray(view.local)[:p].astype(np.int64)
    return np.repeat(seg_first, view.block)[:p] + local


def _port_ranks(view):
    ptr = _np(view.seg_ptr).astype(np.int64)
    return np.repeat(np.arange(view.n_out), np.diff(ptr))


@pytest.mark.parametrize("operand", ["a", "b"])
@pytest.mark.parametrize("case", CASES)
def test_grad_views_match_reference(case, operand):
    s, _ = _streams(case)
    seg_ids = stream_seg_ids(s)
    pos, other = (s.a_pos, s.b_pos) if operand == "a" else (s.b_pos, s.a_pos)
    got = _grad_view(pos, other, seg_ids, "cpu")
    want = ref_pallas_stream._grad_view(pos, other, seg_ids, block=8)
    p = s.n_products
    assert got.n_products == p and got.n_out == want.n_out
    np.testing.assert_array_equal(_np(got.out_map), np.asarray(want.out_map))
    if p == 0:
        return
    np.testing.assert_array_equal(_np(got.idx_x), np.asarray(want.idx_x)[:p])
    np.testing.assert_array_equal(_np(got.idx_y), np.asarray(want.idx_y)[:p])
    np.testing.assert_array_equal(_port_ranks(got), _ref_ranks(want, p))
    assert _np(got.seg_ptr)[-1] == p


@pytest.mark.parametrize("case", CASES)
def test_forward_view_is_the_stream(case):
    s, _ = _streams(case)
    v = _forward_view(s, "cpu")
    assert v.n_out == s.nnz and v.n_products == s.n_products
    assert v.out_map is None
    np.testing.assert_array_equal(_np(v.idx_x), s.a_pos)
    np.testing.assert_array_equal(_np(v.idx_y), s.b_pos)
    np.testing.assert_array_equal(_port_ranks(v), stream_seg_ids(s))
    for t in (v.idx_x, v.idx_y, v.seg_ptr):
        assert t.dtype == torch.int32


def test_int32_overflow_raises():
    s, _ = _streams("random")
    small = types.SimpleNamespace(nnz=10)
    huge = types.SimpleNamespace(nnz=2 ** 31)
    check_int32_stream(types.SimpleNamespace(a=small, b=small), s)
    with pytest.raises(ValueError, match="int32"):
        check_int32_stream(types.SimpleNamespace(a=huge, b=small), s)
