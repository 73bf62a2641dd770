"""The port's resilience layer under real injected faults, on the CPU.

Mirrors ``tests/test_resilience.py`` on ``repro_torch``: seeded
deterministic faults from ``core.faults`` (not mocks) show that retry and
backoff recover transient build failures, the watchdog fails hung builds
and recycles the worker (no slot is lost), a single-flight waiter never
blocks past its deadline, the backpressure policies shed deliberately,
eviction listeners' errors are counted, shutdown is idempotent, and the
serving circuit breaker walks degraded, pinned and back through a
half-open probe -- its ``info()`` equal to the reference's under one event
sequence and fake clock -- while a smoke qwen2-0.5b at keep 0.5 serves the
same greedy tokens as a fault-free run.  Hangs are short and every wait
has a timeout.
"""

import threading
import time

import pytest

torch = pytest.importorskip("torch")

from repro.serving import CircuitBreaker as RefBreaker
from repro_torch.configs import get_config
from repro_torch.core import (
    BuildCancelled, BuildShed, BuildTimeoutError, InjectedFault,
    PlanBuildTimeout, PlanBuilder, RetryPolicy, api, cached_plan, faults,
    plan_cache_clear, plan_cache_info,
)
from repro_torch.models import init_model, smoke
from repro_torch.models.sparse_ffn import sparsify_ffn_params
from repro_torch.serving import CircuitBreaker, Health, ServeEngine, \
    breaker_for, reset_breakers
from repro_torch.sparse import random_density_csc

DEV = dict(backend="torch", device="cpu")


@pytest.fixture(autouse=True)
def fresh_cache():
    plan_cache_clear()
    yield
    faults.uninstall()      # never leak a fault plan into the next test
    plan_cache_clear()


def _pair(seed=0, n=24, density=0.2):
    return (random_density_csc(n, n, density, seed=2 * seed),
            random_density_csc(n, n, density, seed=2 * seed + 1))


# -- retry, backoff, watchdog ----------------------------------------------------


def test_retry_recovers_transient_build_failures():
    a, b = _pair(0)
    with faults.inject(faults.FaultRule("builder_worker", "fail",
                                        every=1, max_fires=2)):
        with PlanBuilder(retry=RetryPolicy(base_delay=0.01)) as builder:
            assert builder.submit(a, b, "expand", **DEV) == "submitted"
            assert builder.wait_idle(30)
            (res,) = builder.poll()
    assert res.ok and res.attempts == 3     # 2 injected failures + success
    assert builder.stats["retries"] == 2
    assert builder.stats["completed"] == 1
    assert builder.stats["failed"] == 0
    assert api.plan_cache_peek(res.key) is not None


def test_retries_exhausted_reports_failure():
    a, b = _pair(1)
    with faults.inject(faults.FaultRule("builder_worker", "fail", every=1)):
        with PlanBuilder(retry=RetryPolicy(max_attempts=2,
                                           base_delay=0.01)) as builder:
            builder.submit(a, b, "expand", **DEV)
            assert builder.wait_idle(30)
            (res,) = builder.poll()
    assert not res.ok and isinstance(res.error, InjectedFault)
    assert res.attempts == 2
    assert builder.stats["failed"] == 1


def test_device_build_faults_leave_the_host_fallback_alone():
    """``plan_spgemm`` failing on ``match="torch"``: the background torch
    build fails after its retries, the foreground host plan builds."""
    a, b = _pair(2)
    with faults.inject(faults.FaultRule("plan_spgemm", "fail", every=1,
                                        match="torch")) as fp:
        with PlanBuilder(retry=RetryPolicy(max_attempts=2,
                                           base_delay=0.01)) as builder:
            plan, status = builder.plan_or_fallback(a, b, "expand", **DEV)
            assert status == "fallback" and plan.backend == "host"
            assert builder.wait_idle(30)
            (res,) = builder.poll()
    assert isinstance(res.error, InjectedFault)
    assert fp.fired("plan_spgemm") == 2


def test_watchdog_recycles_hung_worker():
    """A hung build fails at its deadline and its worker is replaced: the
    builder keeps serving new work at full capacity."""
    with faults.inject(faults.FaultRule("builder_worker", "hang",
                                        every=1, max_fires=1, seconds=10)):
        with PlanBuilder(build_deadline=0.2) as builder:
            builder.submit_task(lambda: "wedged", tag="hung")
            assert builder.wait_idle(30)
            (res,) = builder.poll()
            assert isinstance(res.error, BuildTimeoutError)
            assert builder.stats["timed_out"] == 1
            assert builder.stats["workers_recycled"] == 1
            assert builder.info()["workers"] == 1   # capacity restored

            builder.submit_task(lambda: "fresh", tag="after")
            assert builder.wait_idle(30)
            (res2,) = builder.poll()
            assert res2.ok and res2.plan == "fresh"


def test_waiter_deadline_on_single_flight_build(monkeypatch):
    """A caller joining another thread's in-flight build times out at its
    own deadline instead of blocking for the build's whole length."""
    a, b = _pair(2)
    gate = threading.Event()
    started = threading.Event()
    real = api.plan_spgemm

    def slow_plan(*args, **kw):
        started.set()
        gate.wait(30)
        return real(*args, **kw)

    monkeypatch.setattr(api, "plan_spgemm", slow_plan)
    owner = threading.Thread(
        target=lambda: cached_plan(a, b, "expand", backend="host"),
        daemon=True)
    owner.start()
    assert started.wait(10)
    with pytest.raises(PlanBuildTimeout):
        cached_plan(a, b, "expand", backend="host", build_timeout=0.05)
    assert plan_cache_info()["wait_timeouts"] == 1
    gate.set()
    owner.join(30)
    assert not owner.is_alive()
    # the owner's build landed; a fresh call hits the cache
    assert cached_plan(a, b, "expand", backend="host") is not None
    assert plan_cache_info()["wait_timeouts"] == 1


def test_default_build_timeout_applies(monkeypatch):
    """``DEFAULT_BUILD_TIMEOUT`` bounds a waiter that passes none."""
    a, b = _pair(3)
    gate, started = threading.Event(), threading.Event()
    real = api.plan_spgemm

    def slow_plan(*args, **kw):
        started.set()
        gate.wait(30)
        return real(*args, **kw)

    monkeypatch.setattr(api, "plan_spgemm", slow_plan)
    monkeypatch.setattr(api, "DEFAULT_BUILD_TIMEOUT", 0.05)
    owner = threading.Thread(
        target=lambda: cached_plan(a, b, "expand", backend="host",
                                   build_timeout=30), daemon=True)
    owner.start()
    assert started.wait(10)
    t0 = time.monotonic()
    with pytest.raises(PlanBuildTimeout, match="in-flight"):
        cached_plan(a, b, "expand", backend="host")
    assert time.monotonic() - t0 < 5
    gate.set()
    owner.join(30)
    assert not owner.is_alive()


# -- backpressure ----------------------------------------------------------------


def _pin_worker(builder):
    """Occupy the single worker behind a gate; returns the gate."""
    gate = threading.Event()
    running = threading.Event()

    def task():
        running.set()
        gate.wait(30)

    builder.submit_task(task, tag="pin")
    assert running.wait(10)
    return gate


def test_shed_by_key_age_evicts_oldest_queued():
    with PlanBuilder(max_pending=2,
                     backpressure="shed-by-key-age") as builder:
        gate = _pin_worker(builder)
        assert builder.submit_task(lambda: "old", tag="old") == "submitted"
        # queue full: admitting "new" evicts "old", not the new arrival
        assert builder.submit_task(lambda: "new", tag="new") == "submitted"
        shed = [r for r in builder.poll()
                if isinstance(r.error, BuildShed)]
        assert [r.tag for r in shed] == ["old"]
        assert builder.stats["shed"] == 1
        gate.set()
        assert builder.wait_idle(30)
        done = {r.tag: r for r in builder.poll()}
    assert done["new"].ok and done["new"].plan == "new"
    assert done["pin"].ok


def test_block_with_deadline_blocks_then_sheds():
    with PlanBuilder(max_pending=1, backpressure="block-with-deadline",
                     block_timeout=0.15) as builder:
        gate = _pin_worker(builder)
        t0 = time.monotonic()
        assert builder.submit_task(lambda: "late", tag="late") == "shed"
        assert time.monotonic() - t0 >= 0.1     # blocked for the window
        # once capacity frees mid-wait, the submit goes through instead
        timer = threading.Timer(0.03, gate.set)
        timer.start()
        assert builder.submit_task(lambda: "ok", tag="ok") == "submitted"
        assert builder.wait_idle(30)
        timer.join(10)


def test_unknown_backpressure_policy_rejected():
    with pytest.raises(ValueError, match="backpressure"):
        PlanBuilder(backpressure="drop-everything")
    with pytest.raises(ValueError, match="workers"):
        PlanBuilder(workers=0)


# -- listener errors, shutdown -----------------------------------------------------


def test_listener_error_counted_not_propagated():
    """One raising eviction listener does not starve the others or reach
    the resizing caller."""
    for i in range(4):
        cached_plan(*_pair(10 + i), "expand", backend="host")
    seen = []

    def bad(keys, reason):
        raise RuntimeError("boom")

    def good(keys, reason):
        seen.append((tuple(keys), reason))

    api.register_eviction_listener(bad)
    api.register_eviction_listener(good)
    try:
        api.plan_cache_resize(2)
    finally:
        api.unregister_eviction_listener(bad)
        api.unregister_eviction_listener(good)
        api.plan_cache_resize(64)
    assert seen and seen[0][1] == "resize"
    assert len(seen[0][0]) == 2
    assert plan_cache_info()["listener_errors"] == 1


def test_shutdown_is_idempotent():
    builder = PlanBuilder()
    builder.submit_task(lambda: "x")
    builder.shutdown()
    builder.shutdown()
    builder.shutdown(drain=True)
    assert builder.pending() == 0


def test_shutdown_drain_finishes_queued_work():
    done = []
    builder = PlanBuilder()
    gate = _pin_worker(builder)
    builder.submit_task(lambda: done.append("a"), tag="a")
    builder.submit_task(lambda: done.append("b"), tag="b")
    timer = threading.Timer(0.05, gate.set)
    timer.start()
    builder.shutdown(drain=True)
    timer.join(10)
    assert done == ["a", "b"]
    assert builder.stats["cancelled"] == 0
    with pytest.raises(RuntimeError, match="shut down"):
        builder.submit_task(lambda: None)


def test_default_shutdown_cancels_queued_work():
    builder = PlanBuilder()
    gate = _pin_worker(builder)
    builder.submit_task(lambda: "queued", tag="queued")
    builder.shutdown(wait=False)        # non-drain: the queued task goes
    gate.set()
    for _ in range(100):
        if builder.stats["cancelled"]:
            break
        time.sleep(0.01)
    assert builder.stats["cancelled"] == 1
    cancelled = [r for r in builder.poll()
                 if r.error is not None and r.tag == "queued"]
    assert len(cancelled) == 1 and isinstance(cancelled[0].error,
                                              BuildCancelled)
    assert builder.wait_idle(30)


def test_builders_listed_in_cache_info():
    with PlanBuilder(max_pending=3) as builder:
        infos = plan_cache_info()["builders"]
        assert any(i["max_pending"] == 3 for i in infos)
    assert all(i["max_pending"] != 3 for i in plan_cache_info()["builders"])


# -- the circuit breaker ----------------------------------------------------------


def test_breaker_degrade_pin_recover_cycle():
    t = [0.0]
    br = CircuitBreaker(degrade_after=1, pin_after=3, cooldown=5.0,
                        cooldown_factor=2.0, clock=lambda: t[0])
    assert br.health is Health.HEALTHY
    assert br.allow_attempt()
    br.record_failure()
    assert br.health is Health.DEGRADED
    assert br.allow_attempt()
    br.record_failure()
    br.record_failure()
    assert br.health is Health.FALLBACK_PINNED
    assert not br.allow_attempt()           # cooldown running
    t[0] = 5.1
    assert br.allow_attempt()               # the half-open probe
    assert not br.allow_attempt()           # one probe at a time
    br.record_failure()                     # probe failed: re-pin, back off
    assert br.health is Health.FALLBACK_PINNED
    t[0] = 10.3
    assert not br.allow_attempt()           # cooldown doubled
    t[0] = 15.3
    assert br.allow_attempt()
    br.record_success()
    assert br.health is Health.HEALTHY
    assert br.info()["cooldown"] == 5.0
    assert br.info()["trips"] == 2


def test_breaker_probe_cancelled_rearms():
    t = [0.0]
    br = CircuitBreaker(pin_after=1, cooldown=1.0, clock=lambda: t[0])
    br.record_failure()
    assert br.health is Health.FALLBACK_PINNED
    t[0] = 1.5
    assert br.allow_attempt()
    br.probe_cancelled()
    assert br.allow_attempt()


EVENTS = ["allow", "fail", "allow", "fail", "fail", "allow", ("t", 2.0),
          "allow", "allow", "fail", ("t", 5.0), "allow", "cancel", "allow",
          "fail", ("t", 20.0), "allow", "ok", "fail", "allow", "ok"]


@pytest.mark.parametrize("cfg", [
    dict(), dict(degrade_after=1, pin_after=2, cooldown=1.5),
    dict(degrade_after=2, pin_after=3, cooldown=0.5, cooldown_factor=3.0,
         max_cooldown=4.0)])
def test_breaker_info_equals_the_reference(cfg):
    """One event sequence and fake clock: after every event the breaker's
    answers and ``info()`` equal the reference's."""
    t = [0.0]
    ours = CircuitBreaker(clock=lambda: t[0], **cfg)
    theirs = RefBreaker(clock=lambda: t[0], **cfg)
    for ev in EVENTS:
        if isinstance(ev, tuple):
            t[0] += ev[1]
            outs = (None, None)
        else:
            outs = tuple({"allow": br.allow_attempt,
                          "fail": br.record_failure,
                          "ok": br.record_success,
                          "cancel": br.probe_cancelled}[ev]()
                         for br in (ours, theirs))
        assert str(outs[0]) == str(outs[1]), ev
        assert ours.info() == theirs.info(), ev
    with pytest.raises(ValueError, match="pin_after"):
        CircuitBreaker(degrade_after=3, pin_after=2)


def test_breaker_registry_per_engine():
    reset_breakers()
    e1, e2 = object(), object()
    b1 = breaker_for("torch", e1, pin_after=5)
    assert breaker_for("torch", e1) is b1 and b1.pin_after == 5
    assert breaker_for("torch", e2) is not b1
    reset_breakers()
    assert breaker_for("torch", e1) is not b1
    reset_breakers()


# -- serving under injected warm failures ----------------------------------------


@pytest.fixture(scope="module")
def sparse_model():
    torch.set_num_threads(1)
    cfg = smoke(get_config("qwen2-0.5b"))
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    sparse_params, overlay = sparsify_ffn_params(cfg, params,
                                                 keep_density=0.5)
    return cfg, sparse_params, overlay


def _engine(sparse_model, **kw):
    cfg, sparse_params, overlay = sparse_model
    return ServeEngine(cfg, sparse_params, sparse_ffn=overlay, device="cpu",
                       **kw)


def test_engine_degrades_pins_and_recovers(sparse_model):
    """Under injected warm failures every tick completes, the breaker walks
    healthy, degraded, pinned, a half-open probe recovers to device ticks,
    greedy output equals a fault-free run, and no builder worker is
    lost."""
    t = [0.0]
    br = CircuitBreaker(degrade_after=1, pin_after=2, cooldown=5.0,
                        clock=lambda: t[0])
    prompt, new = [1, 2, 3], 8
    with faults.inject(faults.FaultRule("warm_compile", "fail", every=1,
                                        max_fires=2, match="serve-warm")):
        with PlanBuilder() as builder:
            eng = _engine(sparse_model, max_batch=2, cache_len=32,
                          plan_builder=builder, breaker=br)
            assert builder.wait_idle(60)    # init warm: injected failure 1
            assert br.health is Health.DEGRADED
            rid = eng.submit(prompt, max_new_tokens=new)

            assert eng.step()               # resubmits: injected failure 2
            assert builder.wait_idle(60)
            assert br.health is Health.FALLBACK_PINNED
            assert eng.tick_stats["warm_failures"] == 2

            pinned_ticks = 0
            while not eng.sparse_ready() and (eng.queue or any(eng.slots)):
                assert eng.step()           # every tick completes, pinned
                pinned_ticks += 1
                assert builder.wait_idle(60)
                if pinned_ticks == 3:
                    t[0] = 5.1              # the next tick probes
            assert eng.wait_sparse(120)
            assert br.health is Health.HEALTHY
            done = eng.run_to_completion()
            stats = eng.stats()
            assert stats["jit_ticks"] > 0
            assert stats["fallback_ticks"] >= 3
            assert stats["health"] == "healthy"
            assert stats["breaker"]["trips"] == 1
            assert stats["breaker"]["probes"] == 1
            assert builder.info()["workers"] == 1   # no worker lost
    chaos_gen = done[rid].generated
    assert len(chaos_gen) == new

    ref = _engine(sparse_model, max_batch=2, cache_len=32)
    rid2 = ref.submit(prompt, max_new_tokens=new)
    assert ref.run_to_completion()[rid2].generated == chaos_gen


def test_engine_close_detaches_from_shared_builder(sparse_model):
    """``close()`` stops an engine's warms without touching the shared
    builder: a late warm completion for a closed engine is discarded."""
    gate = threading.Event()
    with PlanBuilder() as builder:
        builder.submit_task(lambda: gate.wait(30), tag="gate")
        eng = _engine(sparse_model, max_batch=1, cache_len=32,
                      plan_builder=builder)
        eng.close()
        eng.close()                     # idempotent
        gate.set()
        assert builder.wait_idle(120)
        assert not eng.sparse_ready()   # the late warm was discarded
        builder.submit_task(lambda: "alive", tag="alive")
        assert builder.wait_idle(30)
        assert any(r.tag == "alive" and r.ok for r in builder.poll())


def test_engine_warm_deadline_counts_a_hung_warm(sparse_model):
    """A warm hung past the watchdog's deadline is failed and its worker
    recycled; the engine counts the failure and serves on."""
    with faults.inject(faults.FaultRule("builder_worker", "hang", every=1,
                                        max_fires=1, seconds=10)):
        with PlanBuilder(build_deadline=0.3) as builder:
            eng = _engine(sparse_model, max_batch=1, cache_len=32,
                          plan_builder=builder, warm_deadline=0.3)
            rid = eng.submit([4, 5], max_new_tokens=4)
            assert eng.step()               # fallback while the warm hangs
            assert builder.wait_idle(30)
            assert builder.stats["workers_recycled"] == 1
            time.sleep(0.6)                 # past warm_deadline + 0.25
            done = eng.run_to_completion()
            assert eng.tick_stats["warm_failures"] == 1
            assert eng.wait_sparse(60)
            assert builder.info()["workers"] == 1
    assert len(done[rid].generated) == 4
