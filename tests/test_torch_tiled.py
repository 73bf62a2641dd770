"""The port's tiled ``method="auto"`` path (``plan_spgemm_tiled``,
``TiledSpgemmPlan.execute[_batched]``, ``spgemm(method="auto")``) against
the JAX package's, on the CPU, mirroring ``tests/test_tiled.py``.

The port's backends are the reference's under their port names (``cuda``
is ``pallas``, ``torch`` is ``jax``, the ``"torch"`` candidate ``"jax"``).
On the same seeded inputs:

- the per-tile methods equal the reference's tile for tile, on all three
  backends;
- the output structure is bit-identical; values are exact on integer
  values; on real values host grids and cuda grids (whose kernels' plain
  versions keep the per-cell order, against the reference's Pallas path in
  interpret mode) are bit-identical, torch grids within the reference's
  rtol 1e-5 / atol 1e-6;
- a grid with one row block equals the untiled method bit for bit,
  batched equals looped bit for bit, and the plan cache, stats, argument
  errors and degenerate grids behave as the reference's.

The reference's Pallas kernels run in interpret mode here, so its cuda-grid
cases stay small (a few dozen rows, a few tiles).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan_spgemm_tiled as ref_plan_spgemm_tiled
from repro.core import spgemm as ref_spgemm
from repro_torch.core import (
    ALGORITHMS,
    AUTO_CANDIDATES,
    cached_plan,
    get_backend,
    plan_cache_clear,
    plan_cache_info,
    plan_spgemm,
    plan_spgemm_tiled,
    spgemm,
    spgemm_batched,
)
from repro_torch.core.api import PLAN_CACHE, _cached_tiled_plan
from repro_torch.kernels import _checks, spgemm_cuda
from repro_torch.sparse import generate
from repro_torch.sparse.format import CSC, BatchedCSC, _np, \
    csc_bit_identical, csc_from_dense, csc_to_dense, validate_csc
from torch_parity import ADVERSARIAL, adversarial, assert_bit_identical, \
    assert_same_csc, assert_same_groups, integer_valued, to_ref, \
    value_stack

REF_BACKEND = {"cuda": "pallas", "torch": "jax", "host": "host"}
RTOL, ATOL = 1e-5, 1e-6     # the reference's own (tests/test_jax_stream.py)
CPU = "cpu"


def _f32(m: CSC) -> CSC:
    return CSC(m.values.to(torch.float32), m.row_indices, m.col_ptr, m.shape)


def _ref_methods(ref_plan) -> dict:
    return {k: ("torch" if v == "jax" else v)
            for k, v in ref_plan.methods.items()}


def _dense(c) -> np.ndarray:
    return csc_to_dense(c).cpu().double().numpy()


def _check_against_reference(backend, a, b, tile, *, exact_real,
                             candidates=None):
    """Plan and execute the grid in both packages; assert equal methods,
    bit-identical structure and the values of point 6."""
    if backend != "host":
        a, b = _f32(a), _f32(b)
    ref_cands = None if candidates is None else tuple(
        "jax" if c == "torch" else c for c in candidates)
    rplan = ref_plan_spgemm_tiled(to_ref(a), to_ref(b),
                                  backend=REF_BACKEND[backend], tile=tile,
                                  candidates=ref_cands, cache=False)
    plan = plan_spgemm_tiled(a, b, backend=backend, tile=tile,
                             candidates=candidates, cache=False, device=CPU)
    assert plan.grid == rplan.grid
    np.testing.assert_array_equal(plan.k_bounds, rplan.k_bounds)
    np.testing.assert_array_equal(plan.n_bounds, rplan.n_bounds)
    assert plan.methods == _ref_methods(rplan)
    got = plan.execute(a, b)
    want = rplan.execute(to_ref(a), to_ref(b))
    if exact_real:
        assert_bit_identical(got, want)
    else:
        assert tuple(got.shape) == tuple(want.shape)
        np.testing.assert_array_equal(_np(got.col_ptr),
                                      np.asarray(want.col_ptr))
        np.testing.assert_array_equal(_np(got.row_indices)[: want.nnz],
                                      np.asarray(want.row_indices))
        np.testing.assert_allclose(_np(got.values)[: want.nnz],
                                   np.asarray(want.values), rtol=RTOL,
                                   atol=ATOL)
    return plan, got


# --- method="auto" against the reference's -----------------------------------


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_auto_grid_host_bit_identical_to_reference(case):
    a, b = adversarial(case)
    for tile in (None, (8, 8), (5, 11)):
        _check_against_reference("host", a, b, tile, exact_real=True)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_auto_grid_torch_matches_reference(case):
    a, b = adversarial(case)
    for tile in (None, (8, 8)):
        _check_against_reference("torch", a, b, tile, exact_real=False)
    ai = integer_valued(a, 1)
    bi = ai if a is b else integer_valued(b, 2)
    _check_against_reference("torch", ai, bi, (8, 8), exact_real=True)


@pytest.mark.parametrize("case", ADVERSARIAL)
def test_auto_grid_cuda_bit_identical_to_reference_auto_sized(case):
    a, b = adversarial(case)
    _check_against_reference("cuda", a, b, None, exact_real=True)


@pytest.mark.parametrize("case", ("random", "empty_cols", "dup_heavy",
                                  "rect_chain"))
def test_auto_grid_cuda_2d_bit_identical_to_reference(case):
    a, b = adversarial(case)
    plan, _ = _check_against_reference("cuda", a, b, (12, 12),
                                       exact_real=True)
    assert plan.grid[0] > 1


def test_auto_grid_cuda_integer_values_exact():
    a, b = adversarial("random")
    ai = integer_valued(a, 3)
    plan, got = _check_against_reference("cuda", ai, ai, (12, 12),
                                         exact_real=True)
    d = _dense(ai)
    np.testing.assert_array_equal(_dense(got), d @ d)


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_per_tile_methods_equal_reference_on_larger_grids(backend):
    # plans only: the grids' choices, tile for tile, on mixed-density and
    # Table-1-shaped patterns
    mats = [generate.random_powerlaw_csc(150, 4.0, seed=31)]
    d = np.zeros((120, 120))
    rng = np.random.default_rng(32)
    d[:, :30] = rng.uniform(size=(120, 30)) < 0.6
    d[:, 30:] = rng.uniform(size=(120, 90)) < 0.03
    mats.append(csc_from_dense(d))
    for a in mats:
        for tile in ((40, 40), (None, 25), 17):
            rplan = ref_plan_spgemm_tiled(
                to_ref(a), to_ref(a), backend=REF_BACKEND[backend],
                tile=tile, cache=False)
            plan = plan_spgemm_tiled(a, a, backend=backend, tile=tile,
                                     cache=False, device=CPU)
            assert plan.methods == _ref_methods(rplan)
            assert len(plan.tiles) == len(rplan.tiles)
            for t, r in zip(plan.tiles, rplan.tiles):
                assert (t.k, t.n, t.a_vals) == (r.k, r.n, r.a_vals)
                np.testing.assert_array_equal(t.b_vals, r.b_vals)


def test_cuda_grid_mixes_families_like_the_reference():
    d = np.zeros((96, 96))
    rng = np.random.default_rng(33)
    d[:, :24] = rng.uniform(size=(96, 24)) < 0.7
    d[:, 24:] = rng.uniform(size=(96, 72)) < 0.02
    a = csc_from_dense(d * rng.uniform(0.5, 1.5, size=d.shape))
    plan = plan_spgemm_tiled(a, a, backend="cuda", tile=(96, 24),
                             cache=False, device=CPU)
    assert {"spa"} < set(plan.methods.values())
    # the children run the kernel families the grid chose
    kinds = {g.kind for t in plan.tiles for g in t.plan.layout.groups}
    assert "spa" in kinds and kinds & {"hash", "spars"}


# --- one row block: bit-identical to the untiled method ----------------------


@pytest.mark.parametrize("method", sorted(ALGORITHMS))
def test_column_tiling_bit_identical_host(method):
    a = generate.random_powerlaw_csc(48, 3.0, seed=11)
    fresh = spgemm(a, a, method, backend="host", cache=False)
    plan = plan_spgemm_tiled(a, a, backend="host", tile=(a.n_cols, 7),
                             candidates=(method,), cache=False)
    assert plan.grid[0] == 1
    got = plan.execute(a, a)
    assert csc_bit_identical(got, fresh), method
    assert_bit_identical(got, ref_plan_spgemm_tiled(
        to_ref(a), to_ref(a), tile=(a.n_cols, 7), candidates=(method,),
        cache=False).execute(to_ref(a), to_ref(a)))


@pytest.mark.parametrize("method", ("spa", "spars-40/40", "h-hash-256/256"))
def test_column_tiling_bit_identical_cuda(method):
    a = _f32(generate.random_powerlaw_csc(36, 3.0, seed=12))
    fresh = spgemm(a, a, method, cache=False, device=CPU)
    plan = plan_spgemm_tiled(a, a, backend="cuda", tile=(a.n_cols, 12),
                             candidates=(method,), cache=False, device=CPU)
    assert plan.grid == (1, 3)
    assert csc_bit_identical(plan.execute(a, a), fresh), method


@pytest.mark.parametrize("cand,engine", [("torch", None),
                                         ("fused", "fused")])
def test_column_tiling_bit_identical_torch(cand, engine):
    a = _f32(generate.random_powerlaw_csc(36, 3.0, seed=13))
    fresh = spgemm(a, a, backend="torch", engine=engine, cache=False,
                   device=CPU)
    plan = plan_spgemm_tiled(a, a, backend="torch", tile=(a.n_cols, 10),
                             candidates=(cand,), cache=False, device=CPU)
    assert set(plan.methods.values()) == {cand}
    assert csc_bit_identical(plan.execute(a, a), fresh)


def test_single_tile_is_the_child_result_on_device_grids():
    a = _f32(generate.random_powerlaw_csc(20, 3.0, seed=14))
    plan = plan_spgemm_tiled(a, a, backend="cuda", tile=(1000, 1000),
                             candidates=("hash-256/256",), cache=False,
                             device=CPU)
    assert plan.grid == (1, 1) and len(plan.tiles) == 1
    assert csc_bit_identical(plan.execute(a, a), spgemm(
        a, a, "hash-256/256", cache=False, device=CPU))


# --- host grids with device tiles ---------------------------------------------


@pytest.mark.parametrize("cand", ["torch", "fused"])
def test_host_grid_device_tiles_match_reference(cand):
    a = generate.random_powerlaw_csc(30, 3.0, seed=15)
    ai = integer_valued(a, 4)
    ref_cand = "jax" if cand == "torch" else cand
    plan = plan_spgemm_tiled(ai, ai, backend="host", tile=(12, 12),
                             candidates=(cand,), cache=False, device=CPU)
    assert set(plan.methods.values()) == {cand}
    assert all(t.plan.backend == "torch" and t.plan.device.type == "cpu"
               for t in plan.tiles)
    got = plan.execute(ai, ai)
    assert got.values.device.type == "cpu"
    assert not isinstance(got.col_ptr, torch.Tensor)
    rplan = ref_plan_spgemm_tiled(to_ref(ai), to_ref(ai), tile=(12, 12),
                                  candidates=(ref_cand,), cache=False)
    assert plan.methods == _ref_methods(rplan)
    # the device tiles' f32 results come back and merge in f64, as the
    # reference's
    assert_bit_identical(got, rplan.execute(to_ref(ai), to_ref(ai)))
    d = _dense(ai)
    np.testing.assert_array_equal(_dense(got), d @ d)


def test_host_grid_mixes_numpy_and_device_tiles():
    a = generate.random_powerlaw_csc(30, 3.0, seed=16)
    plan = plan_spgemm_tiled(a, a, backend="host", tile=(30, 10),
                             candidates=("torch", "spa"), cache=False,
                             device=CPU)
    stats = {}
    got = plan.execute(a, a, stats=stats)
    assert stats["methods"] == ["torch"]
    d = _dense(a)
    np.testing.assert_allclose(_dense(got), d @ d, rtol=RTOL, atol=ATOL)
    with pytest.raises(ValueError, match="not available on every tile"):
        plan.execute(a, a, engine="naive")
    with pytest.raises(ValueError, match="not available on the 'host'"):
        plan.execute(a, a, engine="fused")


def test_host_grid_needs_no_card_without_device_tiles():
    a = generate.random_powerlaw_csc(24, 3.0, seed=17)
    c = spgemm(a, a, method="auto", backend="host", cache=False)
    assert csc_bit_identical(c, spgemm(a, a, "expand", backend="host",
                                       cache=False))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_spgemm_tiled(a, a, backend="host", candidates=("torch",),
                              cache=False)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            plan_spgemm_tiled(a, a, backend="cuda", cache=False)


# --- degenerate tiles ----------------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_tile_larger_than_matrix_is_single_tile(backend):
    a = _f32(generate.random_powerlaw_csc(20, 3.0, seed=13))
    cand = {"host": "spa", "cuda": "spa", "torch": "torch"}[backend]
    plan = plan_spgemm_tiled(a, a, backend=backend, tile=(1000, 1000),
                             candidates=(cand,), cache=False, device=CPU)
    assert plan.grid == (1, 1) and len(plan.tiles) == 1
    untiled = spgemm(a, a, None if cand == "torch" else cand,
                     backend=backend, cache=False,
                     device=None if backend == "host" else CPU)
    assert csc_bit_identical(plan.execute(a, a), untiled)


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_all_empty_column_blocks(backend):
    d = np.zeros((32, 32))
    rng = np.random.default_rng(14)
    d[:, :8] = rng.normal(size=(32, 8)) * (rng.uniform(size=(32, 8)) < 0.4)
    d[:, 24:] = rng.normal(size=(32, 8)) * (rng.uniform(size=(32, 8)) < 0.4)
    a = csc_from_dense(d)
    plan, c = _check_against_reference(backend, a, a, (8, 8),
                                       exact_real=backend != "torch")
    assert {t.n for t in plan.tiles}.isdisjoint({1, 2})
    assert {t.k for t in plan.tiles}.isdisjoint({1, 2})
    validate_csc(c)
    np.testing.assert_allclose(_dense(c), d @ d, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_empty_operands_produce_no_tiles(backend):
    e = csc_from_dense(np.zeros((16, 16), np.float32))
    plan = plan_spgemm_tiled(e, e, backend=backend, tile=(4, 4),
                             cache=False, device=CPU)
    assert plan.tiles == ()
    c = plan.execute(e, e)
    assert tuple(c.shape) == (16, 16) and int(_np(c.col_ptr)[-1]) == 0
    z = csc_from_dense(np.zeros((5, 0), np.float32))
    c = plan_spgemm_tiled(csc_from_dense(np.zeros((4, 5), np.float32)), z,
                          backend=backend, cache=False,
                          device=CPU).execute(
        csc_from_dense(np.zeros((4, 5), np.float32)), z)
    assert tuple(c.shape) == (4, 0)


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_tiles_with_only_empty_a_columns_are_skipped(backend):
    # B's entries in rows 0..7 name A columns that are empty: flops == 0
    rng = np.random.default_rng(18)
    da = rng.normal(size=(16, 16)) * (rng.uniform(size=(16, 16)) < 0.4)
    da[:, :8] = 0.0
    db = rng.normal(size=(16, 16)) * (rng.uniform(size=(16, 16)) < 0.4)
    db[8:, :8] = 0.0
    a, b = csc_from_dense(da), csc_from_dense(db)
    plan, c = _check_against_reference(backend, a, b, (8, 8),
                                       exact_real=backend != "torch")
    assert (0, 0) not in plan.methods and (1, 0) not in plan.methods
    np.testing.assert_allclose(_dense(c), da @ db, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("backend,cand", [("host", "expand"),
                                          ("cuda", "spa"),
                                          ("torch", "torch")])
def test_width_one_tiles(backend, cand):
    a = _f32(generate.random_powerlaw_csc(12, 2.0, seed=15))
    plan = plan_spgemm_tiled(a, a, backend=backend, tile=(a.n_cols, 1),
                             candidates=(cand,), cache=False, device=CPU)
    assert plan.grid[1] == a.n_cols
    untiled = spgemm(a, a, None if cand == "torch" else cand,
                     backend=backend, cache=False,
                     device=None if backend == "host" else CPU)
    assert csc_bit_identical(plan.execute(a, a), untiled)


@pytest.mark.parametrize("cand", ["spars-40/40", "spa", "hash-256/256"])
def test_zero_row_a_on_cuda_grids(cand):
    # the 0-row A of F-port-1: every A tile is empty, so no tile runs
    a = generate.random_density_csc(0, 10, 0.3, seed=19)
    b = _f32(generate.random_density_csc(10, 12, 0.3, seed=20))
    a = _f32(a)
    c = spgemm(a, b, method="auto", candidates=(cand,), tile=(4, 4),
               cache=False, device=CPU)
    assert tuple(c.shape) == (0, 12) and int(_np(c.col_ptr)[-1]) == 0
    want = ref_spgemm(to_ref(a), to_ref(b), method="auto", backend="pallas",
                      candidates=(cand,), tile=(4, 4), cache=False)
    assert_bit_identical(c, want)


# --- batched ---------------------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_auto_batched_bit_identical_to_looped(backend):
    a = generate.random_powerlaw_csc(40, 3.0, seed=16)
    vals = value_stack(a, 4, "real", seed=17)
    if backend == "host":
        vals = vals.astype(np.float64)
    plan = plan_spgemm_tiled(a, a, backend=backend, tile=(13, 9),
                             cache=False, device=CPU)
    looped = [plan.execute(vals[i], vals[i]) for i in range(4)]
    stats = {}
    batched = plan.execute_batched(vals, vals, stats=stats)
    assert len(batched) == 4 and stats["batch"] == 4
    for x, y in zip(batched, looped):
        assert csc_bit_identical(x, y)
    ab = BatchedCSC.from_values(a, torch.from_numpy(vals))
    via_api = spgemm_batched(ab, ab, method="auto", backend=backend,
                             tile=(13, 9), cache=False,
                             device=None if backend == "host" else CPU)
    for x, y in zip(via_api, looped):
        assert csc_bit_identical(x, y)


def test_auto_batched_matches_reference_batched():
    a = _f32(generate.random_powerlaw_csc(24, 2.0, seed=18))
    vals = value_stack(a, 3, "real", seed=19)
    plan = plan_spgemm_tiled(a, a, backend="cuda", tile=(12, 12),
                             cache=False, device=CPU)
    rplan = ref_plan_spgemm_tiled(to_ref(a), to_ref(a), backend="pallas",
                                  tile=(12, 12), cache=False)
    stats, rstats = {}, {}
    got = plan.execute_batched(vals, vals, stats=stats)
    want = rplan.execute_batched(vals, vals, stats=rstats)
    for g, w in zip(got, want):
        assert_bit_identical(g, w)
    assert stats["n_launches"] == rstats["n_launches"] > 0
    assert stats["batch"] == rstats["batch"] == 3
    # the launches do not depend on B: one launch set per tile
    one = {}
    plan.execute_batched(vals[:1], vals[:1], stats=one)
    assert one["n_launches"] == stats["n_launches"]


def test_auto_batched_past_max_batch(monkeypatch):
    monkeypatch.setattr(_checks, "MAX_BATCH", 3)
    a = _f32(generate.random_powerlaw_csc(24, 2.0, seed=20))
    vals = value_stack(a, 7, "real", seed=21)
    plan = plan_spgemm_tiled(a, a, backend="cuda", tile=(12, 12),
                             cache=False, device=CPU)
    batched = plan.execute_batched(vals, vals)
    for i, c in enumerate(batched):
        assert csc_bit_identical(c, plan.execute(vals[i], vals[i]))


def test_batched_cuda_children_may_differ_in_structure():
    # value set 1 cancels one product exactly: its per-group child drops
    # the entry, so the merge runs per element
    a = csc_from_dense(np.array([[1.0, 1.0], [0.0, 1.0]], np.float32))
    b = csc_from_dense(np.array([[1.0, 0.0], [1.0, 1.0]], np.float32))
    av = np.array([[1, 1, 1], [1, 1, 1]], np.float32)
    bv = np.array([[1, 1, 1], [1, -1, 1]], np.float32)
    plan = plan_spgemm_tiled(a, b, backend="cuda", tile=(1, 1),
                             candidates=("spa",), cache=False, device=CPU)
    batched = plan.execute_batched(av, bv)
    for i, c in enumerate(batched):
        loop = plan.execute(av[i], bv[i])
        assert csc_bit_identical(c, loop)
        ref = ref_plan_spgemm_tiled(
            to_ref(a), to_ref(b), backend="pallas", tile=(1, 1),
            candidates=("spa",), cache=False).execute(av[i], bv[i])
        assert_bit_identical(c, ref)


# --- plan cache and tile sharing -------------------------------------------


@pytest.mark.parametrize("backend", ["host", "cuda", "torch"])
def test_tiled_plan_cached_and_tiles_shared(backend):
    plan_cache_clear()
    a = _f32(generate.random_powerlaw_csc(30, 3.0, seed=20))
    dup = csc_from_dense(np.hstack([_dense(a)[:, :15]] * 2).astype(
        np.float32))
    dev = None if backend == "host" else CPU
    c1 = spgemm(a, dup, method="auto", backend=backend, tile=(a.n_cols, 15),
                device=dev)
    plan = _cached_tiled_plan(a, dup, get_backend(backend), (a.n_cols, 15),
                              None, dev)
    assert len(plan.tiles) == 2
    assert plan.tiles[0].plan is plan.tiles[1].plan
    before = plan_cache_info()["hits"]
    c2 = spgemm(a, dup, method="auto", backend=backend, tile=(a.n_cols, 15),
                device=dev)
    assert plan_cache_info()["hits"] > before
    assert csc_bit_identical(c1, c2)
    # an explicit candidate set equal to the default is the same entry
    size = plan_cache_info()["size"]
    spgemm(a, dup, method="auto", backend=backend, tile=(a.n_cols, 15),
           candidates=AUTO_CANDIDATES[backend], device=dev)
    assert plan_cache_info()["size"] == size
    assert plan.cache_key in PLAN_CACHE._plans
    plan_cache_clear()


def test_plan_cache_counts_child_streams_once():
    plan_cache_clear()
    a = _f32(generate.random_powerlaw_csc(30, 3.0, seed=22))
    dup = csc_from_dense(np.hstack([_dense(a)[:, :15]] * 2).astype(
        np.float32))
    spgemm(a, dup, method="auto", backend="torch", tile=(a.n_cols, 15),
           device=CPU)
    info = plan_cache_info()
    # the shared child (one LRU entry of its own) and the tiled plan hold
    # one stream between them
    child = [p for p in PLAN_CACHE._plans.values()
             if getattr(p, "method", None) == "expand"]
    assert len(child) == 1
    assert info["device_stream_bytes"] == child[0].device_stream_nbytes > 0
    assert info["stream_bytes"] == child[0].stream_nbytes > 0
    plan_cache_clear()


def test_tiled_held_plan_through_spgemm():
    a = _f32(generate.random_powerlaw_csc(26, 3.0, seed=21))
    plan = plan_spgemm_tiled(a, a, tile=(9, 9), cache=False, device=CPU)
    assert csc_bit_identical(spgemm(a, a, plan=plan), plan.execute(a, a))
    assert csc_bit_identical(spgemm(a, a, plan=plan, method="auto",
                                    tile=(9, 9), device=CPU),
                             plan.execute(a, a))
    bigger = generate.random_powerlaw_csc(26, 5.0, seed=22)
    with pytest.raises(ValueError, match="pattern does not match"):
        spgemm(bigger, bigger, plan=plan)
    same_nnz = CSC(a.values, np.roll(a.row_indices, 1), a.col_ptr, a.shape)
    with pytest.raises(ValueError, match="fingerprint"):
        spgemm(same_nnz, same_nnz, plan=plan, validate="fingerprint")
    for kw, word in ((dict(tile=(4, 4)), "tile"),
                     (dict(candidates=("spa",)), "candidates"),
                     (dict(t=40.0), "t="), (dict(backend="host"), "backend"),
                     (dict(method="spa"), "method")):
        with pytest.raises(ValueError, match=word):
            spgemm(a, a, plan=plan, **kw)


def test_tiled_execute_stats():
    a = _f32(generate.random_powerlaw_csc(40, 3.0, seed=23))
    plan = plan_spgemm_tiled(a, a, tile=(13, 9), cache=False, device=CPU)
    stats = {}
    plan.execute(a, a, stats=stats)
    k_blocks, n_blocks = stats["grid"]
    assert k_blocks > 1 and n_blocks > 1
    assert stats["tiles"] and all(
        set(t) == {"k", "n", "method"} for t in stats["tiles"])
    assert stats["merged_blocks"] > 0
    assert stats["result_shape"] == (40, 40)
    # one wait per per-group child, and the merge's one
    assert stats["host_syncs"] == len(plan.tiles) + 1
    assert stats["n_launches"] == sum(len(t.plan.layout.groups)
                                      for t in plan.tiles)
    fused = {}
    plan.execute(a, a, stats=fused, engine="fused")
    assert fused["host_syncs"] == 1
    single = plan_spgemm_tiled(a, a, tile=(40, 9), cache=False, device=CPU)
    one = {}
    single.execute(a, a, stats=one)
    assert one["host_syncs"] == len(single.tiles)
    torch_grid = plan_spgemm_tiled(a, a, backend="torch", tile=(13, 9),
                                   cache=False, device=CPU)
    ts = {}
    torch_grid.execute(a, a, stats=ts)
    assert ts["host_syncs"] == 1 and "n_launches" not in ts


# --- block_cols / tile_cols on cuda plans ------------------------------------


@pytest.mark.parametrize("method", ["spa", "spars-16/64", "hash-256/256",
                                    "h-hash-256/256"])
@pytest.mark.parametrize("block_cols,tile_cols", [(16, 32), (8, None),
                                                  (16, 64)])
def test_block_and_tile_cols_match_reference(method, block_cols, tile_cols):
    from repro.core import plan_spgemm as ref_plan_spgemm

    a = _f32(generate.random_powerlaw_csc(48, 3.0, seed=24))
    plan = plan_spgemm(a, a, method, block_cols=block_cols,
                       tile_cols=tile_cols, device=CPU)
    rplan = ref_plan_spgemm(to_ref(a), to_ref(a), method, backend="pallas",
                            block_cols=block_cols, tile_cols=tile_cols)
    assert plan.layout.block_cols == block_cols
    assert plan.layout.tile_cols == (tile_cols or block_cols)
    assert_same_groups(plan, rplan)
    got = plan.execute(a, a)
    assert_bit_identical(got, rplan.execute(to_ref(a), to_ref(a)))
    # the launch width changes launches, never values
    assert_same_csc(got, to_ref(spgemm(a, a, method, cache=False,
                                       device=CPU)), exact=True)


def test_block_and_tile_cols_errors():
    a = _f32(generate.random_powerlaw_csc(16, 2.0, seed=25))
    with pytest.raises(ValueError, match="not a multiple"):
        plan_spgemm(a, a, "spa", block_cols=16, tile_cols=24, device=CPU)
    with pytest.raises(ValueError, match="block_cols/tile_cols"):
        plan_spgemm(a, a, "spa", backend="host", block_cols=16)
    with pytest.raises(ValueError, match="block_cols/tile_cols"):
        plan_spgemm(a, a, "spa", backend="torch", tile_cols=256,
                    device=CPU)


def test_spgemm_cuda_auto_and_launch_widths():
    a = _f32(generate.random_powerlaw_csc(30, 3.0, seed=26))
    auto = spgemm_cuda(a, a, "auto", tile=(10, 10), device=CPU)
    assert csc_bit_identical(auto, plan_spgemm_tiled(
        a, a, tile=(10, 10), cache=False, device=CPU).execute(a, a))
    narrow = spgemm_cuda(a, a, "hash-256/256", block_cols=8, tile_cols=16,
                         device=CPU)
    want = ref_spgemm(to_ref(a), to_ref(a), "hash-256/256", backend="pallas",
                      cache=False)
    assert_bit_identical(narrow, want)
    for kw in (dict(t=20.0), dict(block_cols=64), dict(tile_cols=256),
               dict(b_min=16)):
        with pytest.raises(ValueError, match="do not apply"):
            spgemm_cuda(a, a, "auto", device=CPU, **kw)
    with pytest.raises(ValueError, match="tile= only applies"):
        spgemm_cuda(a, a, "spa", tile=(4, 4), device=CPU)
    with pytest.raises(ValueError, match="host-only"):
        spgemm_cuda(a, a, "expand", device=CPU)


# --- argument validation ---------------------------------------------------


def test_auto_argument_errors():
    a = _f32(generate.random_powerlaw_csc(16, 2.0, seed=27))
    with pytest.raises(ValueError, match="auto"):
        spgemm(a, a, method="auto", t=40.0, device=CPU)
    with pytest.raises(ValueError, match="auto"):
        spgemm(a, a, method="spa", tile=(4, 4), device=CPU)
    with pytest.raises(ValueError, match="auto"):
        spgemm_batched(BatchedCSC.stack([a]), BatchedCSC.stack([a]),
                       method="spa", candidates=("spa",), device=CPU)
    with pytest.raises(ValueError, match="tile"):
        plan_spgemm_tiled(a, a, tile=(4, 4, 4), device=CPU)
    with pytest.raises(ValueError, match="tile"):
        plan_spgemm_tiled(a, a, tile=0, device=CPU)
    with pytest.raises(ValueError, match="host-only"):
        plan_spgemm_tiled(a, a, backend="cuda", candidates=("expand",),
                          device=CPU)
    with pytest.raises(ValueError, match="host-only"):
        plan_spgemm_tiled(a, a, backend="cuda", candidates=("torch",),
                          device=CPU)
    with pytest.raises(ValueError, match="empty candidate"):
        plan_spgemm_tiled(a, a, candidates=(), device=CPU)
    for name in ("jax", "pallas"):
        with pytest.raises(ValueError, match="does not know"):
            plan_spgemm_tiled(a, a, backend="host", candidates=(name,))
        with pytest.raises(ValueError, match="unknown backend"):
            plan_spgemm_tiled(a, a, backend=name, device=CPU)
    with pytest.raises(ValueError, match="no cuda kernel family"):
        plan_spgemm_tiled(a, a, backend="cuda", candidates=("fused",),
                          device=CPU)
    with pytest.raises(ValueError, match="shape mismatch"):
        plan_spgemm_tiled(a, generate.random_powerlaw_csc(12, 2.0, seed=28),
                          device=CPU)
    with pytest.raises(ValueError, match="plan_spgemm_tiled"):
        cached_plan(a, a, "auto", device=CPU)
    with pytest.raises(ValueError, match="or 'auto'"):
        spgemm(a, a, method="bogus", device=CPU)


def test_auto_on_torch_rejects_method_knobs_before_planning():
    a = _f32(generate.random_powerlaw_csc(16, 2.0, seed=29))
    with pytest.raises(ValueError, match="auto"):
        spgemm(a, a, method="auto", backend="torch", b_min=16, device=CPU)
