"""The port's tile partition primitives (``repro_torch.sparse.partition``)
against the JAX package's (``repro.sparse.partition``): grid boundaries,
column and row slices with their value-gather metadata, the stitch, and the
k-merge, bit for bit on the same seeded numpy inputs; then the merge on the
device (torch ops, here on the CPU) against the host's numpy merge, bit for
bit, including the orders where re-association shows and the ``-0.0``
cases.  Mirrors ``tests/test_partition.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.sparse import partition as ref
from repro_torch.sparse import generate, partition
from repro_torch.sparse.format import CSC, _np, csc_from_dense, \
    csc_to_dense, validate_csc
from torch_parity import assert_bit_identical, to_port, to_ref


def _dense(m):
    return csc_to_dense(m).numpy()


def _vals(m):
    return _np(m.values)[: m.nnz]


# --- slicing ---------------------------------------------------------------


def test_col_slice_matches_dense_value_range_and_reference():
    m = generate.random_powerlaw_csc(40, 3.0, seed=0)
    sl, (lo, hi) = partition.csc_col_slice(m, 5, 21)
    assert sl.shape == (40, 16)
    np.testing.assert_array_equal(_dense(sl), _dense(m)[:, 5:21])
    np.testing.assert_array_equal(_vals(sl), _np(m.values)[lo:hi])
    validate_csc(sl)
    want, rng = ref.csc_col_slice(to_ref(m), 5, 21)
    assert (lo, hi) == rng
    assert_bit_identical(sl, want)


def test_col_slice_hstack_round_trip_bit_identical():
    m = generate.random_powerlaw_csc(30, 4.0, seed=1)
    for bounds in ([0, 7, 13, 30], [0, 30], list(range(31))):
        parts = [partition.csc_col_slice(m, j0, j1)[0]
                 for j0, j1 in zip(bounds[:-1], bounds[1:])]
        back = partition.csc_hstack(parts, m.n_rows)
        assert_bit_identical(back, to_ref(m))
        assert_bit_identical(back, ref.csc_hstack(
            [to_ref(p) for p in parts], m.n_rows))


def test_row_slice_matches_dense_gather_and_reference():
    m = generate.random_density_csc(24, 18, 0.3, seed=2)
    sl, idx = partition.csc_row_slice(m, 6, 17)
    assert sl.shape == (11, 18)
    np.testing.assert_array_equal(_dense(sl), _dense(m)[6:17, :])
    validate_csc(sl)
    want, ref_idx = ref.csc_row_slice(to_ref(m), 6, 17)
    np.testing.assert_array_equal(idx, ref_idx)
    assert_bit_identical(sl, want)
    # the gather is pattern-static: it re-slices any same-pattern value set
    new_vals = np.random.default_rng(0).normal(size=m.nnz)
    resliced = CSC(torch.from_numpy(new_vals[idx]), sl.row_indices,
                   sl.col_ptr, sl.shape)
    full = CSC(torch.from_numpy(new_vals), m.row_indices, m.col_ptr, m.shape)
    np.testing.assert_array_equal(_dense(resliced), _dense(full)[6:17, :])


def test_row_slices_partition_all_entries():
    m = generate.random_powerlaw_csc(32, 3.0, seed=3)
    total = 0
    for i0, i1 in ((0, 10), (10, 20), (20, 32)):
        sl, idx = partition.csc_row_slice(m, i0, i1)
        assert sl.nnz == len(idx)
        total += sl.nnz
    assert total == m.nnz


@pytest.mark.parametrize("call", [
    lambda m: partition.csc_col_slice(m, 3, 11),
    lambda m: partition.csc_col_slice(m, -1, 5),
    lambda m: partition.csc_row_slice(m, 5, 3),
])
def test_slice_range_errors(call):
    with pytest.raises(ValueError, match="out of range"):
        call(generate.random_powerlaw_csc(10, 2.0, seed=4))


def test_empty_slices():
    m = generate.random_powerlaw_csc(12, 2.0, seed=5)
    sl, (lo, hi) = partition.csc_col_slice(m, 4, 4)
    assert sl.shape == (12, 0) and sl.nnz == 0 and lo == hi
    sl, idx = partition.csc_row_slice(m, 7, 7)
    assert sl.shape == (0, 12) and sl.nnz == 0 and len(idx) == 0


# --- the host merge --------------------------------------------------------


def _int_parts(seed, shape=(20, 14), n=3, density=0.3):
    rng = np.random.default_rng(seed)
    parts = []
    for _ in range(n):
        d = rng.integers(-3, 4, size=shape).astype(np.float64)
        d *= rng.uniform(size=shape) < density
        parts.append(csc_from_dense(d))
    return parts


def _real_parts(seed, shape=(30, 20), n=5, dtype=np.float32):
    return [generate.random_density_csc(shape[0], shape[1], 0.25,
                                        seed=seed + i)
            for i in range(n)], dtype


def _as(parts, dtype):
    return [CSC(p.values.to(torch.float32 if dtype == np.float32
                            else torch.float64), p.row_indices, p.col_ptr,
                p.shape) for p in parts]


def test_merge_partials_exact_sum_of_dense_and_reference():
    parts = _int_parts(6)
    merged = partition.merge_csc_partials(parts, (20, 14))
    validate_csc(merged, sorted_rows=True)
    np.testing.assert_array_equal(_dense(merged),
                                  sum(_dense(p) for p in parts))
    assert_bit_identical(merged, ref.merge_csc_partials(
        [to_ref(p) for p in parts], (20, 14)))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("seed", [1, 7, 11])
def test_merge_partials_real_values_bit_identical_to_reference(seed, dtype):
    parts, _ = _real_parts(seed)
    parts = _as(parts, dtype)
    got = partition.merge_csc_partials(parts, (30, 20))
    want = ref.merge_csc_partials([to_ref(p) for p in parts], (30, 20))
    assert_bit_identical(got, want)


def test_merge_single_part_is_passthrough():
    p = generate.random_powerlaw_csc(16, 3.0, seed=7)
    assert partition.merge_csc_partials([p], p.shape) is p


def test_merge_keeps_cancelled_entries_explicit():
    d = np.zeros((4, 3))
    d[1, 1] = 2.5
    merged = partition.merge_csc_partials(
        [csc_from_dense(d), csc_from_dense(-d)], (4, 3))
    assert merged.nnz == 1
    assert float(_vals(merged)[0]) == 0.0


def test_merge_accumulates_in_k_order():
    vals = [1e16, 1.0, -1e16]
    parts = []
    for v in vals:
        d = np.zeros((2, 2))
        d[0, 0] = v
        parts.append(csc_from_dense(d))
    merged = partition.merge_csc_partials(parts, (2, 2))
    assert float(_dense(merged)[0, 0]) == (vals[0] + vals[1]) + vals[2]


def test_merge_empty_and_shape_errors():
    out = partition.merge_csc_partials([], (5, 4))
    assert out.shape == (5, 4) and out.nnz == 0
    with pytest.raises(ValueError):
        partition.merge_csc_partials(
            [partition.csc_empty((3, 3)), partition.csc_empty((3, 4))],
            (3, 3))


def test_hstack_errors():
    with pytest.raises(ValueError):
        partition.csc_hstack([], 4)
    with pytest.raises(ValueError):
        partition.csc_hstack([partition.csc_empty((3, 2)),
                              partition.csc_empty((4, 2))], 3)


# --- grid boundaries -------------------------------------------------------


@pytest.mark.parametrize("n,w", [(10, 4), (8, 8), (3, 100), (0, 4), (1, 1),
                                 (37, 5)])
def test_width_col_bounds_equal_reference(n, w):
    np.testing.assert_array_equal(partition.width_col_bounds(n, w),
                                  ref.width_col_bounds(n, w))


def test_width_col_bounds_rejects_zero():
    with pytest.raises(ValueError):
        partition.width_col_bounds(10, 0)


@pytest.mark.parametrize("nb", [1, 2, 4, 7, 60])
def test_nnz_balanced_bounds_properties_and_reference(nb):
    m = generate.random_powerlaw_csc(60, 3.0, seed=8)
    bounds = partition.nnz_balanced_col_bounds(m, nb)
    assert bounds[0] == 0 and bounds[-1] == m.n_cols
    assert (np.diff(bounds) >= 1).all() and len(bounds) - 1 <= nb
    np.testing.assert_array_equal(
        bounds, ref.nnz_balanced_col_bounds(to_ref(m), nb))


def test_nnz_balanced_bounds_cut_inside_a_dense_head():
    d = np.zeros((32, 32))
    d[:, :4] = 1.0
    d[0, 4:] = 1.0
    assert partition.nnz_balanced_col_bounds(csc_from_dense(d), 2)[1] < 16


@pytest.mark.parametrize("n,z,seed", [(20, 2.0, 9), (600, 40.0, 10),
                                      (300, 60.0, 11)])
def test_auto_tile_grid_equals_reference(n, z, seed):
    m = generate.random_powerlaw_csc(n, z, seed=seed)
    got = partition.auto_tile_grid(m, m)
    assert got == ref.auto_tile_grid(to_ref(m), to_ref(m))
    if n == 20:
        assert got == (1, 1)
    if n == 600:
        assert got[1] > 1


def test_auto_tile_grid_targets():
    m = generate.random_powerlaw_csc(60, 4.0, seed=12)
    assert partition.auto_tile_grid(m, m, n_target=20, k_target=50) == \
        ref.auto_tile_grid(to_ref(m), to_ref(m), n_target=20, k_target=50)
    assert partition.DEFAULT_TILE_NNZ == ref.DEFAULT_TILE_NNZ
    assert partition.DEFAULT_KSPLIT_NNZ == ref.DEFAULT_KSPLIT_NNZ


# --- the device merge against the host merge --------------------------------


def _blocks(seed, widths=(5, 7, 3, 6), m=24, k_parts=(3, 1, 0, 2),
            density=0.3, integer=False):
    """per_block partial lists (f32, on the CPU) over column blocks of the
    given widths, with k_parts[ni] partials in block ni."""
    rng = np.random.default_rng(seed)
    per_block, bounds = {}, [0]
    for ni, (w, kp) in enumerate(zip(widths, k_parts)):
        parts = []
        for _ in range(kp):
            d = (rng.integers(-3, 4, size=(m, w)) if integer
                 else rng.standard_normal((m, w))).astype(np.float32)
            d *= rng.uniform(size=(m, w)) < density
            parts.append(csc_from_dense(d))
        per_block[ni] = parts
        bounds.append(bounds[-1] + w)
    return per_block, np.asarray(bounds, np.int64), m


def _host_merge(per_block, bounds, m):
    blocks = []
    for ni in range(len(bounds) - 1):
        shape = (m, int(bounds[ni + 1] - bounds[ni]))
        parts = per_block[ni]
        blocks.append(partition.merge_csc_partials(parts, shape, np.float32)
                      if parts else partition.csc_empty(shape, np.float32))
    return partition.csc_hstack(blocks, m)


def _assert_bits_equal(got, want):
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_array_equal(_np(got.col_ptr), _np(want.col_ptr))
    np.testing.assert_array_equal(_np(got.row_indices)[: want.nnz],
                                  _np(want.row_indices)[: want.nnz])
    gv = np.ascontiguousarray(_vals(got)).view(np.uint32)
    wv = np.ascontiguousarray(_vals(want).astype(np.float32)).view(np.uint32)
    np.testing.assert_array_equal(gv, wv)


@pytest.mark.parametrize("integer", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_device_merge_equals_host_merge_bit_for_bit(seed, integer):
    per_block, bounds, m = _blocks(seed, integer=integer)
    stats = {}
    got = partition.merge_and_stitch_device(per_block, bounds, m,
                                            torch.device("cpu"), stats)
    assert stats["merge_syncs"] == 1
    _assert_bits_equal(got, _host_merge(per_block, bounds, m))
    assert got.values.dtype == torch.float32
    assert isinstance(got.col_ptr, torch.Tensor)
    validate_csc(got)


def test_device_merge_many_row_blocks_keeps_k_order():
    # five partials on one element: 1e20, -1e20, 1, then two more; any
    # order but k ascending gives other bits (the host's np.add.at order)
    shape = (2, 3)

    def part(v, col):
        cp = np.zeros(4, np.int32)
        cp[col + 1:] = 1
        return CSC(torch.tensor([v], dtype=torch.float32),
                   np.array([1], np.int32), cp, shape)

    parts = [part(1e20, 2), part(-1e20, 2), part(1.0, 2), part(3.0, 0),
             part(0.5, 2)]
    bounds = np.array([0, 3], np.int64)
    got = partition.merge_and_stitch_device({0: parts}, bounds, 2,
                                            torch.device("cpu"))
    want = _host_merge({0: parts}, bounds, 2)
    _assert_bits_equal(got, want)
    assert float(_vals(got)[-1]) == 1.5
    swapped = partition.merge_and_stitch_device(
        {0: [parts[0], parts[2], parts[1], parts[3], parts[4]]}, bounds, 2,
        torch.device("cpu"))
    assert float(_vals(swapped)[-1]) == 0.5


def test_device_merge_signed_zeros():
    # a single-partial block keeps its -0.0; a merged block adds from +0.0,
    # so its -0.0 (alone, or -0.0 + -0.0) becomes +0.0, as on the host
    shape = (3, 1)

    def part(vals, rows):
        return CSC(torch.tensor(vals, dtype=torch.float32),
                   np.array(rows, np.int32),
                   np.array([0, len(rows)], np.int32), shape)

    per_block = {0: [part([-0.0, 2.0], [0, 1])],
                 1: [part([-0.0, 1.0], [0, 2]), part([-0.0], [0])],
                 2: [part([-0.0], [1]), part([4.0], [2])]}
    bounds = np.array([0, 1, 2, 3], np.int64)
    got = partition.merge_and_stitch_device(per_block, bounds, 3,
                                            torch.device("cpu"))
    want = _host_merge(per_block, bounds, 3)
    _assert_bits_equal(got, want)
    signs = np.signbit(_vals(got))
    np.testing.assert_array_equal(signs, [True, False, False, False, False,
                                          False])


def test_device_merge_passthrough_and_empty():
    per_block, bounds, m = _blocks(5, widths=(4,), k_parts=(1,))
    stats = {}
    one = per_block[0][0]
    assert partition.merge_and_stitch_device(
        per_block, bounds, m, torch.device("cpu"), stats) is one
    assert stats["merge_syncs"] == 0
    empty, bounds, m = _blocks(5, widths=(4, 2), k_parts=(0, 0))
    got = partition.merge_and_stitch_device(empty, bounds, m,
                                            torch.device("cpu"))
    assert got.shape == (m, 6) and int(got.col_ptr[-1]) == 0
    none = partition.merge_and_stitch_device({}, np.array([0]), 7,
                                             torch.device("cpu"))
    assert none.shape == (7, 0)


def test_device_merge_of_empty_partials():
    # a merged block whose partials hold nothing reads nothing back
    shape = (4, 2)
    e = partition.csc_empty(shape, np.float32)
    e = CSC(e.values, e.row_indices, e.col_ptr, shape)
    stats = {}
    got = partition.merge_and_stitch_device({0: [e, e]}, np.array([0, 2]),
                                            4, torch.device("cpu"), stats)
    assert stats["merge_syncs"] == 0
    assert got.shape == shape and int(got.col_ptr[-1]) == 0


def test_device_merge_bit_stable_and_order_of_completion_free():
    per_block, bounds, m = _blocks(9, k_parts=(4, 3, 2, 5))
    first = partition.merge_and_stitch_device(per_block, bounds, m,
                                              torch.device("cpu"))
    again = partition.merge_and_stitch_device(
        {ni: list(parts) for ni, parts in per_block.items()}, bounds, m,
        torch.device("cpu"))
    _assert_bits_equal(again, first)


def test_reference_round_trip_of_port_parts():
    # the same partials through both packages' host merges
    parts = [to_port(to_ref(p)) for p in _int_parts(13, n=4)]
    assert_bit_identical(partition.merge_csc_partials(parts, (20, 14)),
                         ref.merge_csc_partials([to_ref(p) for p in parts],
                                                (20, 14)))
