"""The port's plan LRU under threads and its background builder
(``repro_torch.core.api``'s single-flight, ``core.plan_builder``) against
the JAX package's, on the CPU.

Mirrors ``tests/test_plan_builder.py`` test for test: the LRU is safe under
concurrent readers and writers (no lost entries, no double builds,
consistent counters), ``peek`` neither promotes nor counts, and
``PlanBuilder`` keeps plan construction off the calling thread -- a
latency-critical tick gets a host plan at once while the device build
lands behind it.  The port's device backend is ``"torch"`` on
``device="cpu"`` here.  Then the port against the reference: the same call
sequence gives the same ``plan_cache_info()`` counters in both packages,
and ``RetryPolicy.delay`` draws the same sequence.  Every wait and join
has a timeout.
"""

import random
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.core as ref_core
from repro.core import api as ref_api
from repro.sparse import random_density_csc as ref_random_density_csc
from repro_torch.core import (
    PlanBuilder, RetryPolicy, api, cached_plan, plan_cache_clear,
    plan_cache_info, plan_cache_key, plan_cache_peek, spgemm, warm_plan,
)
from repro_torch.sparse import random_density_csc
from repro_torch.sparse.format import csc_to_dense

DEV = dict(backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def fresh_cache():
    plan_cache_clear()
    yield
    api.plan_cache_resize(64)
    plan_cache_clear()


def _mats(n_patterns, n=24, density=0.2):
    return [(random_density_csc(n, n, density, seed=2 * i),
             random_density_csc(n, n, density, seed=2 * i + 1))
            for i in range(n_patterns)]


@pytest.fixture
def counting_builds(monkeypatch):
    """Count real plan constructions through the LRU."""
    calls = []
    real = api.plan_spgemm

    def counting(*a, **kw):
        calls.append(1)
        time.sleep(0.002)  # widen the race window
        return real(*a, **kw)

    monkeypatch.setattr(api, "plan_spgemm", counting)
    return calls


def _join(threads):
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()


# -- the LRU's locking and single-flight ---------------------------------------


@pytest.fixture
def short_switches():
    """Switch threads every 10 microseconds: races show within a test."""
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        yield
    finally:
        sys.setswitchinterval(switch)


@pytest.mark.parametrize("backend", ["host", "torch"])
def test_concurrent_hammer_no_double_builds(counting_builds, backend,
                                            short_switches):
    """16 threads (more than the cores) x 4 patterns: each pattern's plan
    is built exactly once, nothing is lost, and the hit/miss counters stay
    consistent."""
    mats = _mats(4)
    n_threads, reps = 16, 6
    plans: dict = {}
    errs = []
    barrier = threading.Barrier(n_threads)
    kw = dict(backend=backend, device="cpu")

    def worker(tid):
        try:
            barrier.wait(timeout=30)
            for _ in range(reps):
                for i, (a, b) in enumerate(mats):
                    p = cached_plan(a, b, "expand", **kw)
                    prev = plans.setdefault(i, p)
                    assert p is prev  # everyone sees the one shared plan
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(n_threads)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errs
    assert len(counting_builds) == len(mats)  # no double builds
    info = plan_cache_info()
    assert info["size"] == len(mats)
    assert info["misses"] == len(mats)
    assert info["hits"] + info["misses"] == n_threads * reps * len(mats)
    assert info["in_flight"] == 0


def test_plan_memo_and_lift_under_threads(monkeypatch, short_switches):
    """Threads asking one spgemm-path matrix for its torch and host plans
    at once (a warm and a serving tick): one memo entry per key, one plan
    build per key, one device lift."""
    import importlib

    from repro_torch.models.sparse_ffn import SparseMatmul

    # the module (``repro_torch.core.device_stream`` is also its function)
    ds = importlib.import_module("repro_torch.core.device_stream")

    lifts = []
    real_lift = ds._lift_stream
    monkeypatch.setattr(ds, "_lift_stream",
                        lambda *a: lifts.append(1) or real_lift(*a))
    w = np.random.default_rng(0).normal(size=(3, 48, 32)).astype(np.float32)
    mat, _ = SparseMatmul.from_shared_pattern(w, keep_density=0.5,
                                              device="cpu")
    n_threads = 16
    barrier = threading.Barrier(n_threads)
    got, errs = [], []

    def worker(i):
        try:
            barrier.wait(timeout=30)
            backend = "torch" if i % 2 else "host"
            entry = mat._spgemm_plan(2, backend=backend)
            if backend == "torch":
                ds.device_stream(entry[0])
            got.append((backend, entry))
        except BaseException as e:  # noqa: BLE001
            errs.append(e)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    _join(threads)
    assert not errs
    for backend in ("torch", "host"):
        entries = [e for b, e in got if b == backend]
        assert len(entries) == n_threads // 2
        assert all(e is entries[0] for e in entries)
    assert len(mat._spgemm_memo) == 2
    assert plan_cache_info()["misses"] == 2
    assert len(lifts) == 1


def test_single_flight_failed_build_retries(monkeypatch):
    """A failed owner build wakes its waiters; a later caller rebuilds."""
    a, b = _mats(1)[0]
    real = api.plan_spgemm
    boom = {"on": True}

    def flaky(*args, **kw):
        if boom["on"]:
            raise RuntimeError("injected build failure")
        return real(*args, **kw)

    monkeypatch.setattr(api, "plan_spgemm", flaky)
    with pytest.raises(RuntimeError, match="injected"):
        cached_plan(a, b, "expand", backend="host")
    assert plan_cache_info()["in_flight"] == 0  # no leaked build event
    boom["on"] = False
    plan = cached_plan(a, b, "expand", backend="host")
    assert plan is plan_cache_peek(
        plan_cache_key(a, b, "expand", backend="host"))


def test_peek_does_not_promote_or_count():
    a, b = _mats(1)[0]
    key = plan_cache_key(a, b, "expand", backend="host")
    assert plan_cache_peek(key) is None
    before = plan_cache_info()
    assert plan_cache_peek(key) is None
    after = plan_cache_info()
    assert (before["hits"], before["misses"]) == (after["hits"],
                                                  after["misses"])
    plan = cached_plan(a, b, "expand", backend="host")
    assert plan_cache_peek(key) is plan


def test_cache_key_is_cached_plans_key_and_refuses_auto():
    """The key holds the stream limit and the device; every method
    spelling on the torch backend shares one key; ``method="auto"``
    raises."""
    a, b = _mats(1)[0]
    plan = cached_plan(a, b, "spa", **DEV)
    for method in ("expand", "spa", "h-hash-256/256"):
        assert plan_cache_peek(plan_cache_key(a, b, method, **DEV)) is plan
    key = plan_cache_key(a, b, "expand", **DEV)
    assert key[-2:] == (api.fast.STREAM_MAX_PRODUCTS, "cpu")
    assert plan_cache_key(a, b, "expand", stream_limit=7, **DEV) != key
    with pytest.raises(ValueError, match="auto"):
        plan_cache_key(a, b, "auto", **DEV)


def test_eviction_counter():
    mats = _mats(5)
    api.plan_cache_resize(2)
    for a, b in mats:
        cached_plan(a, b, "expand", backend="host")
    info = plan_cache_info()
    assert info["size"] == 2
    assert info["evictions"] == 3


# -- PlanBuilder: background builds, dedup, shedding, the fallback ------------


def test_builder_submit_and_poll():
    a, b = _mats(1)[0]
    with PlanBuilder() as builder:
        status = builder.submit(a, b, "expand", backend="host", warm=False)
        assert status == "submitted"
        assert builder.wait_idle(30)
        results = builder.poll()
    assert len(results) == 1
    assert results[0].ok
    key = plan_cache_key(a, b, "expand", backend="host")
    assert results[0].key == key
    assert plan_cache_peek(key) is results[0].plan


def test_builder_dedup_and_cached_statuses():
    a, b = _mats(1)[0]
    gate = threading.Event()
    with PlanBuilder() as builder:
        builder.submit_task(lambda: gate.wait(30), tag="gate")
        assert builder.submit(a, b, "expand", backend="host") == "submitted"
        assert builder.submit(a, b, "expand", backend="host") == "inflight"
        assert builder.stats["deduped"] == 1
        gate.set()
        assert builder.wait_idle(30)
        assert builder.submit(a, b, "expand", backend="host") == "cached"
        assert builder.stats["cached"] == 1


def test_builder_sheds_over_max_pending():
    mats = _mats(4)
    gate = threading.Event()
    with PlanBuilder(max_pending=2) as builder:
        builder.submit_task(lambda: gate.wait(30), tag="gate")
        statuses = [builder.submit(a, b, "expand", backend="host")
                    for a, b in mats]
        assert statuses.count("shed") >= 2
        gate.set()
        assert builder.wait_idle(30)
    assert builder.stats["shed"] >= 2


def test_builder_shutdown_rejects_new_work():
    builder = PlanBuilder()
    builder.shutdown()
    a, b = _mats(1)[0]
    with pytest.raises(RuntimeError, match="shut down"):
        builder.submit(a, b, "expand", backend="host")


def test_builder_reports_failed_builds(monkeypatch):
    a, b = _mats(1)[0]
    monkeypatch.setattr(api, "plan_spgemm",
                        lambda *x, **k: (_ for _ in ()).throw(
                            RuntimeError("injected")))
    with PlanBuilder() as builder:
        builder.submit(a, b, "expand", backend="host", warm=False)
        assert builder.wait_idle(30)
        results = builder.poll()
    assert len(results) == 1
    assert not results[0].ok
    assert "injected" in str(results[0].error)
    assert builder.stats["failed"] == 1


def test_builder_device_defaults_to_the_card():
    """``submit`` plans on the torch backend on the card unless asked: with
    no card it raises before queueing anything."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: device=None runs on it")
    a, b = _mats(1)[0]
    with PlanBuilder() as builder:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            builder.submit(a, b, "expand")
        assert builder.pending() == 0


def test_plan_or_fallback_never_blocks_then_promotes():
    """Cold pattern: the call returns a host plan at once (status
    ``"fallback"``) while the torch build runs behind it; once it lands,
    the same call serves the torch plan (``"ready"``)."""
    a, b = _mats(1)[0]
    with PlanBuilder() as builder:
        plan, status = builder.plan_or_fallback(a, b, "expand", **DEV)
        assert status == "fallback"
        assert plan.backend == "host"
        assert builder.wait_idle(120)
        plan2, status2 = builder.plan_or_fallback(a, b, "expand", **DEV)
    assert status2 == "ready"
    assert plan2.backend == "torch"
    assert plan2.device_stream_nbytes > 0   # warmed in the worker


def test_warm_plan_materializes_stream():
    a, b = _mats(1)[0]
    plan = cached_plan(a, b, "expand", **DEV)
    assert plan.stream_nbytes == 0  # lazy until warmed
    warm_plan(plan)
    assert plan.stream_nbytes > 0
    assert plan.device_stream_nbytes > 0
    host = cached_plan(a, b, "expand", backend="host")
    warm_plan(host)     # a host plan: the host stream alone
    assert host.stream_nbytes > 0 and host.device_stream_nbytes == 0


def test_allmiss_churn_bit_identical_to_cold_cache():
    """Eviction churn does not change numerics: results under a too-small
    LRU (every request misses and evicts) equal uncached cold builds bit
    for bit, whichever of the fallback (host) or promoted (torch) plan
    serves a lap.  Small integers make every f32 sum exact."""

    def integerize(m, seed):
        rng = np.random.default_rng(seed)
        vals = rng.integers(1, 4, size=m.nnz).astype(np.float64)
        return type(m)(torch.from_numpy(vals), m.row_indices, m.col_ptr,
                       m.shape)

    mats = [(integerize(a, 3 * i), integerize(b, 3 * i + 1))
            for i, (a, b) in enumerate(_mats(6, n=32, density=0.15))]
    ref = [csc_to_dense(spgemm(a, b, method="expand", backend="host",
                               cache=False))
           for a, b in mats]
    api.plan_cache_resize(2)
    statuses = set()
    with PlanBuilder(max_pending=2) as builder:
        for _ in range(3):  # three churn laps
            for (a, b), r in zip(mats, ref):
                plan, status = builder.plan_or_fallback(
                    a, b, "expand", warm=False, **DEV)
                statuses.add(status)
                got = csc_to_dense(plan.execute(a, b))
                np.testing.assert_array_equal(np.asarray(got, np.float64),
                                              np.asarray(r, np.float64))
        assert builder.wait_idle(120)
    assert plan_cache_info()["evictions"] > 0   # churn happened
    assert "fallback" in statuses


# -- wasted builds and re-warm -------------------------------------------------


def test_wasted_builds_counts_insert_then_evict():
    """A build completing into a cache too small to keep it is counted."""
    a, b = _mats(1)[0]
    gate = threading.Event()
    with PlanBuilder() as builder:
        builder.submit_task(lambda: gate.wait(30), tag="gate")
        assert builder.submit(a, b, "expand", backend="host",
                              warm=False) == "submitted"
        api.plan_cache_resize(0)
        gate.set()
        assert builder.wait_idle(60)
    info = plan_cache_info()
    assert info["size"] == 0
    assert info["wasted_builds"] == 1, info
    # a hit-then-evicted entry is not waste
    api.plan_cache_resize(2)
    plan = cached_plan(a, b, "expand", backend="host")
    assert cached_plan(a, b, "expand", backend="host") is plan
    api.plan_cache_resize(0)
    assert plan_cache_info()["wasted_builds"] == 1


def test_rewarm_hook_rebuilds_after_shrink():
    mats = _mats(2)
    api.plan_cache_resize(4)
    with PlanBuilder() as builder:
        builder.enable_rewarm()
        builder.enable_rewarm()   # idempotent
        for a, b in mats:
            builder.submit(a, b, "expand", backend="host", warm=False)
        assert builder.wait_idle(60)
        keys = [plan_cache_key(a, b, "expand", backend="host")
                for a, b in mats]
        assert all(plan_cache_peek(k) is not None for k in keys)
        # the shrink evicts the LRU entry; the listener resubmits it
        api.plan_cache_resize(1)
        assert builder.wait_idle(60)
        assert builder.stats["rewarmed"] == 1, builder.stats
        # the re-warmed build evicted the survivor by ordinary capacity
        # pressure, which does not notify (no listener ping-pong)
        rewarmed = builder.stats["rewarmed"]
        assert sum(plan_cache_peek(k) is not None for k in keys) == 1
        assert builder.stats["rewarmed"] == rewarmed
    assert api.PLAN_CACHE._listeners == []   # shutdown unhooked it
    api.plan_cache_resize(0)


def test_rewarm_skips_unknown_keys():
    a, b = _mats(1)[0]
    with PlanBuilder() as builder:
        key = plan_cache_key(a, b, "expand", backend="host")
        assert builder.rewarm([key, ("bogus",)]) == 0
        builder.submit(a, b, "expand", backend="host", warm=False)
        assert builder.wait_idle(60)
        api.plan_cache_resize(0)
        api.plan_cache_resize(64)
        assert builder.rewarm([key]) == 1
        assert builder.wait_idle(60)
        assert plan_cache_peek(key) is not None


# -- against the reference -------------------------------------------------------


COUNTERS = ("hits", "misses", "evictions", "wasted_builds", "listener_errors",
            "wait_timeouts", "size", "max_size", "in_flight")


def _sequence(mod_api, cached, gen, info, clear):
    """One call sequence on a package's LRU: misses, hits, a shrink that
    evicts, a re-insert past capacity, a waste, a raising listener; the
    counters after each step."""
    mats = [(gen(24, 24, 0.2, seed=2 * i), gen(24, 24, 0.2, seed=2 * i + 1))
            for i in range(5)]
    clear()
    out = []

    def bad(keys, reason):
        raise RuntimeError("boom")

    mod_api.register_eviction_listener(bad)
    try:
        for a, b in mats[:4]:
            cached(a, b, "expand", backend="host")
        cached(*mats[0], "expand", backend="host")
        out.append({k: info()[k] for k in COUNTERS})
        mod_api.plan_cache_resize(2)
        out.append({k: info()[k] for k in COUNTERS})
        cached(*mats[4], "expand", backend="host")
        cached(*mats[1], "spa", backend="host")
        out.append({k: info()[k] for k in COUNTERS})
        mod_api.plan_cache_resize(0)
        out.append({k: info()[k] for k in COUNTERS})
    finally:
        mod_api.unregister_eviction_listener(bad)
        mod_api.plan_cache_resize(64)
        clear()
    return out


def test_cache_counters_equal_the_reference():
    """The same call sequence gives the same counters in both packages."""
    got = _sequence(api, cached_plan, random_density_csc, plan_cache_info,
                    plan_cache_clear)
    want = _sequence(ref_api, ref_core.cached_plan, ref_random_density_csc,
                     ref_core.plan_cache_info, ref_core.plan_cache_clear)
    assert got == want
    assert got[-1]["wasted_builds"] > 0 and got[-1]["listener_errors"] == 2


@pytest.mark.parametrize("policy", [
    dict(), dict(max_attempts=5, base_delay=0.01, jitter=0.0),
    dict(base_delay=0.3, max_delay=1.0, jitter=0.9, seed=17)])
def test_retry_delays_equal_the_reference(policy):
    """``RetryPolicy.delay`` on an RNG seeded by the policy's seed draws the
    reference's sequence, capped and jittered alike."""
    ours, theirs = RetryPolicy(**policy), ref_core.RetryPolicy(**policy)
    r1, r2 = random.Random(ours.seed), random.Random(theirs.seed)
    got = [ours.delay(k, r1) for k in range(1, 12)]
    want = [theirs.delay(k, r2) for k in range(1, 12)]
    assert got == want
    assert max(got) <= ours.max_delay * (1 + ours.jitter)
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)
