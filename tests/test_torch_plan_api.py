"""The port's plan/execute API and its host stream engine, mirroring
``test_plan_executor.py`` and ``test_fast_engine.py``: ``plan=``,
``cache=``, ``validate="fingerprint"``, ``t``/``b_min``/``b_max`` (and
unregistered ``family-x/y`` names), the LRU (hits, misses, evictions, the
keys of the canonical method and of the stream guard), conflicts with a
held plan, ``kernels.spgemm_cuda``, where the host backend runs, and the
host stream engine (its default for ``expand``, both batched strategies,
the guard's transient rebuild, frozen result structure, empty operands) —
each result held bit for bit against the JAX package's where it has one.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import plan_spgemm as ref_plan_spgemm
from repro.core import spgemm as ref_spgemm
from repro_torch.core import (
    fast,
    pattern_fingerprint,
    plan_cache_clear,
    plan_cache_info,
    plan_cache_resize,
    plan_spgemm,
    spgemm,
    spgemm_batched,
)
from repro_torch.core.api import cached_plan
from repro_torch.core.planner import ALGORITHMS, resolve_params
from repro_torch.kernels import spgemm_cuda
from repro_torch.sparse import generate
from repro_torch.sparse.format import CSC, BatchedCSC, _np, \
    csc_bit_identical, csc_equal, csc_from_dense, segment_reduce, \
    validate_csc
from repro_torch.core.reference import spgemm_dense
from torch_parity import assert_bit_identical, assert_same_groups, to_ref

KERNEL_METHODS = [m for m in ALGORITHMS if m not in ("esc", "expand")]


def _reweight(m: CSC, seed: int) -> CSC:
    rng = np.random.default_rng(seed)
    return CSC(torch.from_numpy(rng.normal(size=m.nnz)), m.row_indices,
               m.col_ptr, m.shape)


# --- plan reuse, plan=, cache= ----------------------------------------------


@pytest.mark.parametrize("method", sorted(ALGORITHMS))
def test_plan_reuse_bit_identical_host(method):
    a = generate.random_powerlaw_csc(80, 3.0, seed=1)
    plan = plan_spgemm(a, a, method, backend="host")
    a2 = _reweight(a, seed=7)
    fresh = spgemm(a2, a2, method, backend="host", cache=False)
    reused = plan.execute(a2, a2)
    assert csc_bit_identical(reused, fresh), method
    validate_csc(reused)
    raw = plan.execute(_np(a2.values), _np(a2.values))
    assert csc_bit_identical(raw, fresh), method
    assert_bit_identical(reused, ref_spgemm(to_ref(a2), to_ref(a2), method,
                                            backend="host", cache=False))


@pytest.mark.parametrize("method", sorted(KERNEL_METHODS))
def test_plan_reuse_bit_identical_cuda(method):
    a = generate.random_powerlaw_csc(64, 3.0, seed=2)
    plan = plan_spgemm(a, a, method, device="cpu")
    a2 = _reweight(a, seed=8)
    fresh = spgemm(a2, a2, method, device="cpu", cache=False)
    assert csc_bit_identical(plan.execute(a2, a2), fresh), method
    assert csc_bit_identical(spgemm(a2, a2, plan=plan), fresh), method


def test_cache_false_bypasses_the_lru():
    plan_cache_clear()
    a = generate.random_uniform_csc(40, 3, seed=3)
    for backend, kw in (("host", {}), ("cuda", dict(device="cpu")),
                        ("torch", dict(device="cpu"))):
        c = spgemm(a, a, backend=backend, cache=False, **kw)
        assert csc_bit_identical(c, spgemm(a, a, backend=backend, **kw))
    info = plan_cache_info()
    assert (info["misses"], info["hits"], info["size"]) == (3, 0, 3)
    plan_cache_clear()


def test_unknown_and_family_method_names():
    a = generate.random_uniform_csc(32, 2, seed=0)
    for backend, kw in (("host", {}), ("cuda", dict(device="cpu"))):
        with pytest.raises(ValueError, match="unknown method"):
            plan_spgemm(a, a, "bogus", backend=backend, **kw)
    with pytest.raises(ValueError, match="unknown method"):
        spgemm_cuda(a, a, method="bogus", device="cpu")
    # unregistered but well-formed family names are accepted by the planner
    # (the reference's seed behavior), not by spgemm()
    plan = plan_spgemm(a, a, "spars-128/128", device="cpu")
    assert plan.method == "spars-128/128"
    assert dict(plan.params) == resolve_params("spars-128/128") == dict(
        b_min=128, b_max=128)
    ref = ref_plan_spgemm(to_ref(a), to_ref(a), "spars-128/128",
                          backend="pallas")
    assert_same_groups(plan, ref)
    assert dict(plan_spgemm(a, a, "h-spa-8/8", backend="host").params) == \
        dict(ref_plan_spgemm(to_ref(a), to_ref(a), "h-spa-8/8").params)
    for bad in ("hash-64", "spars-16//64", "hash-a/b"):
        with pytest.raises(ValueError, match="malformed|unknown"):
            plan_spgemm(a, a, bad, device="cpu")
    with pytest.raises(ValueError, match="unknown method"):
        spgemm(a, a, "spars-128/128", device="cpu")


def test_host_only_methods_rejected_on_cuda():
    a = generate.random_uniform_csc(32, 2, seed=0)
    for method in ("esc", "expand"):
        for fn in (lambda: plan_spgemm(a, a, method, device="cpu"),
                   lambda: spgemm_cuda(a, a, method, device="cpu"),
                   lambda: spgemm(a, a, method, device="cpu")):
            with pytest.raises(ValueError, match="host-only"):
                fn()


def test_execute_rejects_mismatched_operands():
    a = generate.random_uniform_csc(32, 2, seed=0)
    for backend, kw in (("host", {}), ("cuda", dict(device="cpu")),
                        ("torch", dict(device="cpu"))):
        plan = plan_spgemm(a, a, "hash-256/256" if backend != "torch"
                           else "expand", backend=backend, **kw)
        with pytest.raises(ValueError, match="shape"):
            plan.execute(generate.random_uniform_csc(16, 2, seed=1), a)
        bigger = generate.random_uniform_csc(32, 4, seed=2)
        with pytest.raises(ValueError, match="pattern does not match"):
            spgemm(bigger, bigger, plan=plan)
        stack = torch.zeros((3, a.nnz))
        with pytest.raises(ValueError, match="execute_batched"):
            plan.execute(stack, stack)


# --- validate="fingerprint" -------------------------------------------------


def _colliding_pair(n=16):
    a = csc_from_dense(np.eye(n))
    b = csc_from_dense(np.roll(np.eye(n), 1, axis=0))
    assert np.array_equal(_np(a.col_ptr), _np(b.col_ptr))
    return a, b


@pytest.mark.parametrize("backend, engine", [
    ("host", "naive"), ("host", "stream"), ("cuda", "naive"),
    ("cuda", "fused"), ("torch", "stream"), ("torch", "fused")])
def test_validate_fingerprint_rejects_corrupt_pattern(backend, engine):
    a, corrupt = _colliding_pair()
    kw = {} if backend == "host" else dict(device="cpu")
    plan = plan_spgemm(a, a, "spa" if backend != "torch" else "expand",
                       backend=backend, **kw)
    plan.execute(corrupt, corrupt, engine=engine)     # O(1): accepted
    with pytest.raises(ValueError, match="fingerprint"):
        plan.execute(corrupt, corrupt, engine=engine,
                     validate="fingerprint")
    with pytest.raises(ValueError, match="fingerprint"):
        spgemm(corrupt, corrupt, plan=plan, engine=engine,
               validate="fingerprint")
    ok = plan.execute(a, a, engine=engine, validate="fingerprint")
    assert ok.shape == (16, 16)
    # raw values carry no structure: the check has nothing to read
    v = torch.ones(a.nnz)
    plan.execute(v, v, engine=engine, validate="fingerprint")
    bad = BatchedCSC.stack([corrupt, corrupt])
    with pytest.raises(ValueError, match="fingerprint"):
        spgemm_batched(bad, bad, plan=plan, engine=engine,
                       validate="fingerprint")
    with pytest.raises(ValueError, match="validate"):
        plan.execute(a, a, engine=engine, validate="full")


# --- the LRU -----------------------------------------------------------------


def test_plan_cache_distinct_entries_for_colliding_shape_nnz():
    plan_cache_clear()
    a, b = _colliding_pair()
    assert pattern_fingerprint(a) != pattern_fingerprint(b)
    ca = spgemm(a, a, "spa", backend="host")
    cb = spgemm(b, b, "spa", backend="host")
    info = plan_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (0, 2, 2)
    assert csc_equal(ca, spgemm_dense(a, a), rtol=1e-12, atol=0)
    assert csc_equal(cb, spgemm_dense(b, b), rtol=1e-12, atol=0)
    assert csc_bit_identical(spgemm(a, a, "spa", backend="host"), ca)
    assert plan_cache_info()["hits"] == 1
    plan_cache_clear()


def test_plan_cache_keys_params_backend_device_and_guard():
    """The key holds the resolved parameters (an explicit default hits the
    named method's entry), the backend, the device and the guard in force:
    a new guard plans afresh."""
    plan_cache_clear()
    a = generate.random_powerlaw_csc(40, 3.0, seed=30)
    p = cached_plan(a, a, "h-hash-256/256", backend="host")
    assert cached_plan(a, a, "h-hash-256/256", backend="host", t=40,
                       b_min=256, b_max=256) is p
    assert cached_plan(a, a, "h-hash-256/256", backend="host", t=7.0) \
        is not p
    q = cached_plan(a, a, "h-hash-256/256", device="cpu")
    assert q is not p and q.backend == "cuda"
    assert cached_plan(a, a, "h-hash-256/256", device="cpu", t=7.0) is not q
    misses = plan_cache_info()["misses"]
    old = fast.STREAM_MAX_PRODUCTS
    try:
        fast.STREAM_MAX_PRODUCTS = old + 1
        r = cached_plan(a, a, "h-hash-256/256", device="cpu")
        assert r is not q and r.stream_limit == old + 1
        assert plan_cache_info()["misses"] == misses + 1
    finally:
        fast.STREAM_MAX_PRODUCTS = old
    plan_cache_clear()


def test_plan_cache_hit_miss_eviction_and_resize():
    plan_cache_clear()
    mats = [generate.random_powerlaw_csc(40, 3.0, seed=s) for s in range(4)]
    for m in mats:
        spgemm(m, m, "spa", backend="host")
    spgemm(_reweight(mats[0], 1), _reweight(mats[0], 2), "spa",
           backend="host")
    info = plan_cache_info()
    assert (info["hits"], info["misses"], info["size"]) == (1, 4, 4)
    info = plan_cache_resize(2)
    assert info["size"] == 2 and info["evictions"] == 2
    spgemm(mats[1], mats[1], "spa", backend="host")     # evicted: a miss
    assert plan_cache_info()["misses"] == 5
    assert plan_cache_resize(0)["size"] == 0
    plan_cache_resize(64)
    plan_cache_clear()
    assert plan_cache_info() == {
        "hits": 0, "misses": 0, "evictions": 0, "size": 0, "max_size": 64,
        "hit_rate": 0.0, "stream_bytes": 0, "device_stream_bytes": 0,
        "fused_stream_bytes": 0}


# --- held-plan conflicts -----------------------------------------------------


@pytest.mark.parametrize("backend", ["host", "cuda"])
def test_held_plan_conflicting_arguments_raise(backend):
    a = generate.random_uniform_csc(32, 3, seed=5)
    kw = {} if backend == "host" else dict(device="cpu")
    plan = plan_spgemm(a, a, "h-hash-256/256", backend=backend, **kw)
    for bad, match in ((dict(method="spa"), "method"),
                       (dict(backend="torch"), "backend"),
                       (dict(t=7.0), "t="), (dict(b_min=16), "b_min"),
                       (dict(b_max=16), "b_max")):
        with pytest.raises(ValueError, match=f"conflict.*{match}"):
            spgemm(a, a, plan=plan, **bad)
    other = "cuda" if backend == "host" else "cpu"
    if backend == "cuda":
        other = "meta"
    with pytest.raises(ValueError, match="conflict.*device"):
        spgemm(a, a, plan=plan, device=other)
    c = spgemm(a, a, "h-hash-256/256", backend=backend, t=40, b_min=256,
               b_max=256, plan=plan, device="cpu")
    assert csc_bit_identical(c, plan.execute(a, a))
    spa_plan = plan_spgemm(a, a, "spa", backend=backend, **kw)
    with pytest.raises(ValueError, match="conflict"):
        spgemm(a, a, t=40.0, plan=spa_plan)


def test_held_plan_conflicts_batched():
    a = generate.random_uniform_csc(24, 2, seed=6)
    plan = plan_spgemm(a, a, "spa", backend="host")
    ab = BatchedCSC.stack([a, a])
    with pytest.raises(ValueError, match="conflict"):
        spgemm_batched(ab, ab, "hash-256/256", plan=plan)
    with pytest.raises(ValueError, match="conflict"):
        spgemm_batched(ab, ab, b_min=8, plan=plan)
    got = spgemm_batched(ab, ab, "spa", plan=plan)
    assert csc_bit_identical(got[0], plan.execute(a, a))


# --- t/b_min/b_max on the cuda backend, and spgemm_cuda ----------------------


@pytest.mark.parametrize("t", [1.0, 25.0, 40.0, 1e9])
def test_t_moves_the_cuda_hybrid_split_as_the_reference(t):
    """``t`` reaches the cuda planner as it reaches ``_plan_pallas``: the
    SPA head and the blocked tail move, the groups equal the reference's;
    ``b_min``/``b_max`` select nothing there (the lanes block by 128)."""
    a = generate.random_powerlaw_csc(300, 4.0, seed=11)
    ra = to_ref(a)
    for method in ("h-hash-256/256", "h-spa-16/64"):
        plan = plan_spgemm(a, a, method, t=t, b_min=8, b_max=8,
                           device="cpu")
        ref = ref_plan_spgemm(ra, ra, method, backend="pallas", t=t,
                              b_min=8, b_max=8)
        assert_same_groups(plan, ref)
        assert dict(plan.params)["t"] == t
        c = spgemm(a, a, method, t=t, device="cpu", cache=False)
        assert csc_equal(c, spgemm_dense(a, a), rtol=1e-4, atol=1e-5)


def test_spgemm_cuda_takes_t_bounds_and_a_plan():
    a = generate.random_powerlaw_csc(200, 4.0, seed=12)
    want = spgemm(a, a, "h-hash-32/256", t=10.0, device="cpu", cache=False)
    got = spgemm_cuda(a, a, "h-hash-32/256", t=10.0, device="cpu")
    assert csc_bit_identical(got, want)
    plan = plan_spgemm(a, a, "h-hash-32/256", t=10.0, device="cpu")
    assert csc_bit_identical(spgemm_cuda(a, a, "h-hash-32/256", plan=plan),
                             want)
    assert csc_bit_identical(
        spgemm_cuda(a, a, "spars-64/64", b_min=8, device="cpu"),
        spgemm(a, a, "spars-16/64", device="cpu", cache=False))


# --- where the host backend runs --------------------------------------------


def test_host_backend_runs_on_the_cpu_only():
    a = generate.random_uniform_csc(16, 2, seed=0)
    assert plan_spgemm(a, a, "spa", backend="host").device.type == "cpu"
    assert spgemm(a, a, "spa", backend="host",
                  device="cpu").values.device.type == "cpu"
    for fn in (lambda: spgemm(a, a, "spa", backend="host", device="cuda"),
               lambda: plan_spgemm(a, a, "spa", backend="host",
                                   device="cuda"),
               lambda: cached_plan(a, a, "spa", backend="host",
                                   device="cuda")):
        with pytest.raises(ValueError, match="runs numpy on the host"):
            fn()


# --- the host stream engine --------------------------------------------------


def test_stream_is_default_engine_for_expand_only():
    a = generate.random_powerlaw_csc(40, 3.0, seed=1)
    for method, engine in (("expand", "stream"), ("spa", "naive"),
                           ("h-hash-256/256", "naive")):
        stats: dict = {}
        plan_spgemm(a, a, method, backend="host").execute(a, a, stats=stats)
        assert stats["engine"] == engine, method


@pytest.mark.parametrize("n, avg", [(24, 2.0), (96, 5.0)])
def test_stream_batched_bit_identical_to_looped_and_reference(n, avg):
    from repro.sparse.format import BatchedCSC as RefBatchedCSC

    a = generate.random_powerlaw_csc(n, avg, seed=2)
    plan = plan_spgemm(a, a, "expand", backend="host")
    assert (plan.stream.n_products <= fast.STREAM_BATCH_VECTOR_MAX) == \
        (n == 24)
    vals = np.random.default_rng(3).normal(size=(4, a.nnz))
    stats: dict = {}
    outs = plan.execute_batched(vals, vals, stats=stats)
    assert stats["path"] == ("vectorized" if n == 24 else "rowloop")
    rs = RefBatchedCSC.from_values(to_ref(a), vals)
    want = ref_plan_spgemm(to_ref(a), to_ref(a), "expand").execute_batched(
        rs, rs)
    for k, o in enumerate(outs):
        assert csc_bit_identical(o, plan.execute(vals[k], vals[k]))
        assert_bit_identical(o, want[k])


def test_memory_guard_fallback_bit_identical():
    a = generate.random_powerlaw_csc(50, 4.0, seed=9)
    full = plan_spgemm(a, a, "expand", backend="host")
    guarded = plan_spgemm(a, a, "expand", backend="host", stream_limit=1)
    assert full.stream is not None and guarded.stream is None
    stats_g, stats_f = {}, {}
    c_g = guarded.execute(a, a, stats=stats_g)
    c_f = full.execute(a, a, stats=stats_f)
    assert csc_bit_identical(c_g, c_f)
    assert stats_g["stream_cached"] is False and stats_f["stream_cached"]
    vals = np.random.default_rng(10).normal(size=(3, a.nnz))
    for x, y in zip(guarded.execute_batched(vals, vals),
                    full.execute_batched(vals, vals)):
        assert csc_bit_identical(x, y)


def test_stream_result_structure_is_frozen():
    a = generate.random_powerlaw_csc(30, 3.0, seed=31)
    c = plan_spgemm(a, a, "expand", backend="host").execute(a, a)
    with pytest.raises(ValueError):
        np.asarray(c.row_indices)[0] = 99
    with pytest.raises(ValueError):
        np.asarray(c.col_ptr)[0] = 1


def test_stream_empty_operands():
    ea = CSC(torch.zeros(0), np.zeros(0, np.int32), np.zeros(13, np.int32),
             (10, 12))
    eb = CSC(torch.zeros(0), np.zeros(0, np.int32), np.zeros(8, np.int32),
             (12, 7))
    for backend, kw in (("host", {}), ("torch", dict(device="cpu"))):
        plan = plan_spgemm(ea, eb, "expand", backend=backend, **kw)
        c = plan.execute(ea, eb)
        assert c.shape == (10, 7) and c.nnz == 0
        outs = plan.execute_batched(torch.zeros((2, 0)), torch.zeros((2, 0)))
        assert all(o.nnz == 0 for o in outs)


def test_segment_reduce_edges():
    from repro.sparse.format import segment_reduce as ref_segment_reduce

    assert segment_reduce(np.zeros(0), np.zeros(0, np.int64)).shape == (0,)
    assert segment_reduce(np.zeros((3, 0)), np.zeros(0, np.int64),
                          axis=1).shape == (3, 0)
    v = np.random.default_rng(0).normal(size=(3, 50))
    starts = np.array([0, 7, 7, 30])
    np.testing.assert_array_equal(segment_reduce(v, starts, axis=1),
                                  ref_segment_reduce(v, starts, axis=1))
    np.testing.assert_array_equal(segment_reduce(v[1], starts),
                                  segment_reduce(v, starts, axis=1)[1])
