"""The port's sparse substrate and plan-time numpy against the JAX package's:
padded layouts, statistics, the paper's pre-processing, generators, the
Table-1 synthesizer, on-device compaction, conversion and the plan LRU."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core.analysis as ref_analysis
import repro.sparse.format as ref_format
import repro.sparse.generate as ref_generate
import repro.sparse.stats as ref_stats
import repro.sparse.suitesparse as ref_suitesparse
from repro_torch.convert import csc_from_reference
from repro_torch.core import analysis
from repro_torch.core.api import (
    PlanCache, cached_plan, plan_cache_clear, plan_cache_info,
    plan_cache_resize,
)
from repro_torch.sparse import generate, stats, suitesparse
from repro_torch.sparse.format import (
    CSCBuilder, ColumnSlots, _np, csc_equal, csc_from_dense, csc_pad_gather, csc_to_dense,
    validate_csc,
)
from torch_parity import adversarial, to_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _operands():
    yield "powerlaw", generate.random_powerlaw_csc(60, 4.0, seed=2)
    yield "density", generate.random_density_csc(30, 25, 0.2, seed=3)
    yield "uniform", generate.random_uniform_csc(20, 3, seed=4)
    yield "empty", generate.random_uniform_csc(9, 0)
    yield "oscil_dcop_30", suitesparse.synthesize_suitesparse(
        "oscil_dcop_30", seed=0)[0]


OPERANDS = dict(_operands())


@pytest.mark.parametrize("name", OPERANDS)
@pytest.mark.parametrize("pad_to", [None, 64])
def test_pad_gather_matches_reference(name, pad_to):
    m = OPERANDS[name]
    for got, want in zip(csc_pad_gather(m, pad_to),
                         ref_format.csc_pad_gather(to_ref(m), pad_to)):
        assert np.array_equal(got, want) and got.dtype == want.dtype


@pytest.mark.parametrize("name", OPERANDS)
def test_stats_match_reference(name):
    m = OPERANDS[name]
    r = to_ref(m)
    if m.n_rows == m.n_cols:
        assert np.array_equal(stats.ops_per_column(m, m),
                              ref_stats.ops_per_column(r, r))
        assert np.array_equal(stats.steps_per_column(m, m),
                              ref_stats.steps_per_column(r, r))
    assert np.array_equal(stats.column_nnz(m), ref_stats.column_nnz(r))
    if m.nnz and m.n_rows == m.n_cols:
        got = stats.matrix_stats(m)
        want = ref_stats.matrix_stats(r)
        for f in ("nnz", "nnz_min", "nnz_max", "nnz_avg", "nnz_var",
                  "mult_min", "mult_max", "mult_avg", "mult_var"):
            assert getattr(got, f) == getattr(want, f), f


@pytest.mark.parametrize("name", ["powerlaw", "uniform", "oscil_dcop_30"])
@pytest.mark.parametrize("knobs", [dict(), dict(t=40.0, b_min=16, b_max=64),
                                   dict(t=np.inf, b_min=128, b_max=128),
                                   dict(t=3.0, b_min=8, b_max=8)])
def test_preprocess_matches_reference(name, knobs):
    m = OPERANDS[name]
    r = to_ref(m)
    got = analysis.preprocess(m, m, **knobs)
    want = ref_analysis.preprocess(r, r, **knobs)
    for f in ("ops", "perm", "ops_sorted", "hash_sizes"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f
    assert got.split == want.split
    assert np.array_equal(got.blocks.starts, want.blocks.starts)
    assert np.array_equal(got.blocks.sizes, want.blocks.sizes)


def test_generators_match_reference():
    pairs = [
        (generate.random_uniform_csc(30, 4, seed=9),
         ref_generate.random_uniform_csc(30, 4, seed=9)),
        (generate.random_density_csc(20, 17, 0.3, seed=1),
         ref_generate.random_density_csc(20, 17, 0.3, seed=1)),
        (generate.random_powerlaw_csc(40, 3.0, seed=5),
         ref_generate.random_powerlaw_csc(40, 3.0, seed=5)),
    ]
    for got, want in pairs:
        assert np.array_equal(_np(got.col_ptr), want.col_ptr)
        assert np.array_equal(_np(got.row_indices), want.row_indices)
        assert np.array_equal(_np(got.values), want.values)


@pytest.mark.parametrize("n", [1, 24, 50])
def test_uniform_generator_accepts_z0(n):
    """The reference raises ZeroDivisionError at z=0 (its generate.py:31);
    the port returns the empty n×n matrix."""
    m = generate.random_uniform_csc(n, 0, seed=3)
    validate_csc(m)
    assert m.shape == (n, n) and m.nnz == 0
    assert np.array_equal(_np(m.col_ptr), np.zeros(n + 1))
    with pytest.raises(ValueError):
        generate.random_uniform_csc(n, n + 1)


FAST = ("poli", "olm1000", "oscil_dcop_30", "str_200", "iprob")


@pytest.mark.parametrize("name", FAST)
def test_synthesized_stats_match_published(name):
    spec = suitesparse.by_name(name)
    m, st = suitesparse.synthesize_suitesparse(spec, seed=0)
    validate_csc(m)
    assert st.nnz == spec.nnz
    assert st.n_rows == spec.n
    assert st.nnz_min == spec.nnz_min
    assert st.nnz_max == spec.nnz_max
    assert abs(st.nnz_var - spec.nnz_var) <= max(0.15 * spec.nnz_var, 0.3)
    assert abs(st.mult_avg - spec.mult_avg) <= max(0.15 * spec.mult_avg, 1.0)
    if name == "iprob":          # the arrow structure is forced
        assert st.mult_min >= 2900


def test_table1_matches_reference():
    assert suitesparse.SUITESPARSE_TABLE1 == tuple(
        suitesparse.MatrixSpec(*(getattr(s, f.name) for f in
                                 ref_suitesparse.dataclasses.fields(s)))
        for s in ref_suitesparse.SUITESPARSE_TABLE1)


_DIGEST = """
import hashlib
from repro_torch.sparse.format import _np
from repro_torch.sparse.suitesparse import synthesize_suitesparse
m, _ = synthesize_suitesparse("oscil_dcop_30", seed=1)
h = hashlib.sha256()
for x in (m.col_ptr, m.row_indices, m.values):
    h.update(_np(x).tobytes())
print(h.hexdigest())
"""


def test_synthesizer_is_stable_across_processes():
    """The reference seeds from Python's per-process ``hash`` of the name
    (its suitesparse.py:325); the port's CRC salt gives one matrix in every
    process, whatever the hash seed."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    digests = set()
    for hash_seed in ("1", "2"):
        out = subprocess.run(
            [sys.executable, "-c", _DIGEST], capture_output=True, text=True,
            env=dict(env, PYTHONHASHSEED=hash_seed), timeout=120, check=True)
        digests.add(out.stdout.strip())
    assert len(digests) == 1


def test_dense_round_trip_matches_reference():
    rng = np.random.default_rng(0)
    d = rng.normal(size=(13, 9)) * (rng.uniform(size=(13, 9)) < 0.4)
    got = csc_from_dense(d)
    want = ref_format.csc_from_dense(d)
    assert np.array_equal(_np(got.col_ptr), want.col_ptr)
    assert np.array_equal(_np(got.row_indices), want.row_indices)
    assert np.array_equal(_np(got.values), want.values)
    assert np.array_equal(csc_to_dense(got).numpy(), d)
    assert csc_equal(got, csc_from_dense(d.copy()))
    assert not csc_equal(got, csc_from_dense(d * 2))
    validate_csc(got, sorted_rows=True)


def test_validate_rejects_bad_structure():
    m = generate.random_uniform_csc(6, 2, seed=0)
    bad = type(m)(m.values, _np(m.row_indices) + 6, m.col_ptr, m.shape)
    with pytest.raises(ValueError, match="row bounds"):
        validate_csc(bad)


def test_convert_round_trip():
    r = ref_generate.random_powerlaw_csc(30, 3.0, seed=1)
    m = csc_from_reference(r.values, r.row_indices, r.col_ptr, r.shape,
                           device="cpu")
    assert m.values.dtype == torch.float64 and m.device.type == "cpu"
    back = to_ref(m)
    for f in ("values", "row_indices", "col_ptr"):
        assert np.array_equal(getattr(back, f), getattr(r, f))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_compaction_matches_reference_builder(seed):
    """On-device compaction of dense tiles and hash tables equals the
    reference's host CSCBuilder, entry for entry."""
    rng = np.random.default_rng(seed)
    m, n, h = 11, 20, 8
    perm = rng.permutation(n)
    dense_cols, hash_cols = perm[:12], perm[12:]
    tile = (rng.integers(-2, 3, size=(m, 12))
            * (rng.uniform(size=(m, 12)) < 0.4)).astype(np.float32)
    keys = np.full((h, 8), -1, np.int32)
    vals = np.zeros((h, 8), np.float32)
    for lane in range(8):
        rows = rng.choice(m, size=rng.integers(0, h + 1), replace=False)
        slots = rng.choice(h, size=len(rows), replace=False)
        keys[slots, lane] = rows
        vals[slots, lane] = rng.integers(-2, 3, size=len(rows))
    want_b = ref_format.CSCBuilder((m, n), np.float32)
    want_b.add_dense_tile(dense_cols, tile)
    want_b.add_hash_tables(hash_cols, keys, vals)
    want = want_b.build()
    got_b = CSCBuilder((m, n), ColumnSlots.of(np.full(n, m), max(m, h) * 12,
                                              "cpu"))
    got_b.add_dense_tile(torch.from_numpy(dense_cols), torch.from_numpy(tile))
    got_b.add_hash_tables(torch.from_numpy(hash_cols), torch.from_numpy(keys),
                          torch.from_numpy(vals))
    got = got_b.build()
    assert np.array_equal(_np(got.col_ptr), want.col_ptr)
    assert np.array_equal(_np(got.row_indices), want.row_indices)
    assert np.array_equal(_np(got.values), want.values)
    assert got_b.tile_shapes == want_b.tile_shapes


def test_plan_lru_hit_miss_eviction():
    plan_cache_clear()
    before = plan_cache_resize(2)
    try:
        assert before["size"] == 0 and before["max_size"] == 2
        ops = [adversarial(c)[0] for c in ("random", "single_row", "empty")]
        p0 = cached_plan(ops[0], ops[0], device="cpu")
        assert cached_plan(ops[0], ops[0], device="cpu") is p0
        info = plan_cache_info()
        assert (info["hits"], info["misses"], info["evictions"]) == (1, 1, 0)
        cached_plan(ops[1], ops[1], device="cpu")
        cached_plan(ops[2], ops[2], device="cpu")   # evicts ops[0]'s plan
        info = plan_cache_info()
        assert info["size"] == 2 and info["evictions"] == 1
        assert cached_plan(ops[0], ops[0], device="cpu") is not p0
        # another method is another key
        assert cached_plan(ops[2], ops[2], "spa", device="cpu").method == "spa"
        assert plan_cache_resize(0)["size"] == 0
    finally:
        plan_cache_resize(64)
        plan_cache_clear()


def test_plan_cache_threads_keep_counts():
    """More threads than cores hammer one small LRU: every lookup is counted
    once and the size bound holds (a lost update would break either)."""
    cache = PlanCache(max_size=3)
    n_threads, per_thread = 16, 200
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        def work(i):
            for j in range(per_thread):
                key = (i + j) % 5
                cache.get_or_build(key, lambda k=key: ("plan", k))

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
            assert not t.is_alive()
    finally:
        sys.setswitchinterval(switch)
    info = cache.info()
    assert info["hits"] + info["misses"] == n_threads * per_thread
    assert info["size"] <= 3
