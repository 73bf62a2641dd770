"""The port's ``backend="host"`` against the JAX package's: every method
(the nine kernel methods, ESC and expand) under both host engines (the
naive oracles and the numpy product stream) on the adversarial patterns of
the differential harness, bit for bit, each column's rows in the order the
reference emits them (discovery order for the oracles); the paper's
generators against the dense oracle; the hybrid split at its boundaries
and the HASH accumulator's edge paths (collision chains, exactly-full
tables, empty A columns, b_min == b_max), mirrored from
``test_spgemm_algorithms.py``, ``test_hybrid_split.py`` and
``test_hash_edge_paths.py``.  Both packages run the same numpy on the same
f64 values, so any difference is a fault of the port's copy.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan_spgemm as ref_plan_spgemm
from repro.core import spgemm as ref_spgemm
from repro_torch.core import naive, plan_spgemm, spgemm, spgemm_batched
from repro_torch.core.analysis import HASH_C, hash_table_size, preprocess
from repro_torch.core.planner import ALGORITHMS
from repro_torch.core.reference import spgemm_dense
from repro_torch.sparse import generate
from repro_torch.sparse.format import BatchedCSC, _np, csc_equal, \
    csc_from_dense, validate_csc
from repro_torch.sparse.stats import ops_per_column
from torch_parity import ADVERSARIAL, adversarial, assert_bit_identical, \
    to_ref

METHODS = tuple(ALGORITHMS)


def _both(a, b, method, engine=None, **kw):
    got = spgemm(a, b, method, backend="host", engine=engine, cache=False,
                 **kw)
    want = ref_spgemm(to_ref(a), to_ref(b), method, backend="host",
                      engine=engine, cache=False, **kw)
    return got, want


@pytest.mark.parametrize("engine", ["naive", "stream"])
@pytest.mark.parametrize("case", ADVERSARIAL)
@pytest.mark.parametrize("method", METHODS)
def test_host_backend_bit_identical_to_reference(method, case, engine):
    a, b = adversarial(case)
    got, want = _both(a, b, method, engine)
    assert_bit_identical(got, want)
    assert got.values.device.type == "cpu"


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("gen,seed", [
    ("uniform2", 0), ("uniform6", 1), ("powerlaw", 2), ("density", 3),
])
def test_algorithms_match_oracle_and_reference(method, gen, seed):
    a = {
        "uniform2": lambda: generate.random_uniform_csc(120, 2, seed=seed),
        "uniform6": lambda: generate.random_uniform_csc(90, 6, seed=seed),
        "powerlaw": lambda: generate.random_powerlaw_csc(100, 4.0,
                                                         seed=seed),
        "density": lambda: generate.random_density_csc(80, 80, 0.08,
                                                       seed=seed),
    }[gen]()
    got, want = _both(a, a, method)
    validate_csc(got)
    assert csc_equal(got, spgemm_dense(a, a), rtol=1e-9, atol=1e-11)
    assert_bit_identical(got, want)


def test_rectangular_spgemm():
    a = generate.random_density_csc(40, 60, 0.1, seed=5)
    b = generate.random_density_csc(60, 25, 0.15, seed=6)
    for method in ("spa", "spars-40/40", "hash-256/256", "esc"):
        got, want = _both(a, b, method)
        assert csc_equal(got, spgemm_dense(a, b), rtol=1e-9)
        assert_bit_identical(got, want)


def test_discovery_order_is_kept():
    """The host oracles emit each column's rows in discovery order (not
    sorted), exactly as the reference: a column whose rows are found
    out of order keeps that order."""
    d_a = np.zeros((3, 9))
    d_a[[1, 2], 0] = 1.0
    d_a[0, 1] = 2.0
    d_b = np.zeros((9, 2))
    d_b[[0, 1], 0] = 1.0
    d_b[1, 1] = 1.0
    a, b = csc_from_dense(d_a), csc_from_dense(d_b)
    for method in ("spa", "spars-40/40", "hash-256/256", "h-hash-256/256"):
        got, want = _both(a, b, method)
        assert_bit_identical(got, want)
        assert _np(got.row_indices)[:3].tolist() == [1, 2, 0]


@pytest.mark.parametrize("t_kind", ("all_above", "all_below", "exact"))
def test_hybrid_end_to_end_at_boundaries(t_kind):
    a = generate.random_powerlaw_csc(48, 3.0, seed=1)
    ops = ops_per_column(a, a)
    if t_kind == "all_above":
        t = float(ops.min())
    elif t_kind == "all_below":
        t = float(ops.max()) + 1.0
    else:
        t = float(np.sort(ops)[len(ops) // 2])
    pre = preprocess(a, a, t=t, b_min=32, b_max=64)
    assert pre.split == int((ops >= t).sum())
    for method in ("h-hash-32/256", "h-spa-16/64"):
        got, want = _both(a, a, method, t=t)
        assert csc_equal(got, spgemm_dense(a, a), rtol=1e-9, atol=1e-11)
        assert_bit_identical(got, want)
        assert dict(plan_spgemm(a, a, method, backend="host",
                                t=t).params)["t"] == t


def test_hybrid_limits_match_pure():
    """t=0 is SPA, t=inf SPARS/HASH (Section 3.3)."""
    a = generate.random_powerlaw_csc(60, 3.0, seed=9)
    ref = spgemm_dense(a, a)
    for acc in ("spa", "hash"):
        for t in (0.0, np.inf):
            c = naive.hybrid_numpy(a, a, t=t, b_min=40, b_max=40,
                                   accumulator=acc)
            assert csc_equal(c, ref, rtol=1e-9)


def test_work_stealing_spars_matches_oracle_and_reference():
    from repro.core.naive import spars_ws_numpy as ref_spars_ws

    for seed in (0, 1):
        a = generate.random_powerlaw_csc(90, 4.0, seed=seed)
        for kw in ({}, dict(b_min=8, b_max=8)):
            got = naive.spars_ws_numpy(a, a, **kw)
            assert csc_equal(got, spgemm_dense(a, a), rtol=1e-9)
            assert_bit_identical(got, ref_spars_ws(to_ref(a), to_ref(a),
                                                   **kw))


# --- the HASH accumulator's edge paths --------------------------------------


def _colliding_rows(h: int, count: int, m: int) -> np.ndarray:
    rows = np.arange(0, count) * h + 1
    assert rows.max() < m and len(set((rows * HASH_C) % h)) == 1
    return rows


def _single_chain_case(count: int, table: int):
    m = table * count + 2
    rows = _colliding_rows(table, count, m)
    a_dense = np.zeros((m, m))
    a_dense[rows, 0] = np.arange(1.0, count + 1)
    b_dense = np.zeros((m, m))
    b_dense[0, :3] = (2.0, -1.0, 0.5)
    return csc_from_dense(a_dense), csc_from_dense(b_dense)


@pytest.mark.parametrize("h", [4, 8, 16])
def test_hash_high_load_collision_chain(h):
    from repro.core import hash_numpy as ref_hash_numpy
    from repro.core import preprocess as ref_preprocess

    a, b = _single_chain_case(h - 1, table=h)
    pre = preprocess(a, b, t=np.inf, b_min=4, b_max=4)
    assert int(pre.hash_sizes[0]) == h == hash_table_size(h - 1)
    c = naive.hash_numpy(a, b, pre)
    validate_csc(c)
    assert csc_equal(c, spgemm_dense(a, b), rtol=1e-12, atol=0)
    assert np.diff(_np(c.col_ptr))[:3].tolist() == [h - 1] * 3
    ra, rb = to_ref(a), to_ref(b)
    assert_bit_identical(c, ref_hash_numpy(
        ra, rb, ref_preprocess(ra, rb, t=np.inf, b_min=4, b_max=4)))


@pytest.mark.parametrize("h", [2, 4, 8])
def test_hash_exactly_full_table(h):
    a, b = _single_chain_case(h, table=h)
    pre = preprocess(a, b, t=np.inf, b_min=4, b_max=4)
    assert int(pre.hash_sizes[0]) == 2 * h
    full = dataclasses.replace(
        pre, hash_sizes=np.full(pre.blocks.n_blocks, h, np.int64))
    c = naive.hash_numpy(a, b, full)
    validate_csc(c)
    assert csc_equal(c, spgemm_dense(a, b), rtol=1e-12, atol=0)


def test_hash_accumulates_through_collisions():
    h = 4
    m = h * h + 2
    rows = _colliding_rows(h, h, m)
    a_dense = np.zeros((m, m))
    a_dense[rows, 0] = 1.0
    a_dense[rows, 1] = 10.0
    b_dense = np.zeros((m, m))
    b_dense[0, 0] = 1.0
    b_dense[1, 0] = 1.0
    a, b = csc_from_dense(a_dense), csc_from_dense(b_dense)
    c = naive.hash_numpy(a, b, preprocess(a, b, t=np.inf, b_min=4, b_max=4))
    got = _np(spgemm_dense(c, csc_from_dense(np.eye(m))).values)
    assert (got[: len(rows)] == 11.0).all()
    assert csc_equal(c, spgemm_dense(a, b), rtol=1e-12, atol=0)


def test_empty_a_column_consumes_b_entry():
    m = 12
    a_dense = np.zeros((m, m))
    a_dense[1, 3] = 2.0
    b_dense = np.zeros((m, m))
    b_dense[0, 5] = 1.0
    b_dense[3, 5] = 4.0
    b_dense[7, 5] = 1.0
    a, b = csc_from_dense(a_dense), csc_from_dense(b_dense)
    for method in ("hash-256/256", "spars-40/40", "h-hash-32/256"):
        got, want = _both(a, b, method)
        assert csc_equal(got, spgemm_dense(a, b), rtol=1e-12, atol=0)
        assert_bit_identical(got, want)
        cuda = spgemm(a, b, method, device="cpu", cache=False)
        assert csc_equal(cuda, spgemm_dense(a, b), rtol=1e-5, atol=1e-6)


def test_h_hash_degenerate_equal_block_bounds():
    """b_min == b_max: every block b_min wide but the tail; the host
    oracles block so, the cuda kernels still block by 128 lanes."""
    a = generate.random_powerlaw_csc(50, 3.0, seed=3)
    pre = preprocess(a, a, t=40.0, b_min=8, b_max=8)
    sizes = pre.blocks.sizes
    assert (sizes[:-1] == 8).all() and sizes[-1] <= 8
    ref = spgemm_dense(a, a)
    kw = dict(t=40.0, b_min=8, b_max=8)
    got, want = _both(a, a, "h-hash-256/256", **kw)
    assert csc_equal(got, ref, rtol=1e-9, atol=1e-11)
    assert_bit_identical(got, want)
    c_cuda = spgemm(a, a, "h-hash-256/256", device="cpu", cache=False, **kw)
    assert csc_equal(c_cuda, ref, rtol=1e-4, atol=1e-5)


def test_h_hash_all_columns_blocked():
    a = generate.random_uniform_csc(40, 3, seed=4)
    got, want = _both(a, a, "h-hash-256/256", t=1e9)
    assert csc_equal(got, spgemm_dense(a, a), rtol=1e-9, atol=1e-11)
    assert_bit_identical(got, want)
    assert preprocess(a, a, t=1e9, b_min=256, b_max=256).split == 0


# --- batched host execution -------------------------------------------------


@pytest.mark.parametrize("engine", ["naive", "stream"])
@pytest.mark.parametrize("method", ["spa", "hash-32/256", "esc", "expand"])
def test_batched_host_matches_reference_and_loop(method, engine):
    """SPA's naive engine runs one vectorized pass over the value axis, the
    other oracles a loop, the stream 2-D passes: each element equals the
    reference's batched result and a looped execute bit for bit."""
    from repro.sparse.format import BatchedCSC as RefBatchedCSC

    a = generate.random_powerlaw_csc(40, 3.0, seed=6)
    vals = np.random.default_rng(7).normal(size=(3, a.nnz))
    sa = BatchedCSC.from_values(a, torch.from_numpy(vals))
    stats: dict = {}
    got = spgemm_batched(sa, sa, method, backend="host", engine=engine,
                         cache=False)
    plan = plan_spgemm(a, a, method, backend="host")
    again = plan.execute_batched(sa, sa, engine=engine, stats=stats)
    rs = RefBatchedCSC.from_values(to_ref(a), vals)
    ref_stats: dict = {}
    want = ref_plan_spgemm(to_ref(a), to_ref(a), method).execute_batched(
        rs, rs, engine=engine, stats=ref_stats)
    assert stats["path"] == ref_stats["path"]
    for k in range(3):
        assert_bit_identical(got[k], want[k])
        assert_bit_identical(again[k], want[k])
        assert_bit_identical(plan.execute(sa[k], sa[k], engine=engine),
                             want[k])
