"""Background plan construction: the symbolic phase off the latency path.

The port of the JAX package's ``repro/core/plan_builder.py``.  Serving
ticks must never wait on a plan build: under live traffic a plan-cache
miss enqueues the build *here* -- a small pool of daemon worker threads
feeding a completion queue -- and the caller proceeds at once on a
fallback (the synchronous host stream, or a queued request).  The costly
part of a device plan is not only its symbolic phase but what hangs off
it: the host product stream and its lift to the card.  ``warm=True`` (the
default) forces both inside the worker, with one throwaway replay on the
card, so by the time a build completes the serving thread's next call is a
pure replay.

All builds go through :func:`repro_torch.core.api.cached_plan`, the shared
locked plan LRU: its single-flight protocol makes a build racing a
foreground request run the symbolic phase once, whichever thread gets
there first.  The builder adds its own dedup on top (``submit`` of a key
already queued or building is a no-op) so a hot pattern arriving on every
tick does not flood the queue.

Resilience: failed attempts retry under a seeded, jittered
capped-exponential :class:`RetryPolicy`; per-task deadlines are enforced
by a watchdog thread that marks an over-deadline task failed
(:class:`BuildTimeoutError`) and *recycles the worker* -- the wedged
thread is abandoned (daemon, unwedges eventually) and a fresh worker takes
its slot, so one hung build can never eat a worker slot forever.  Excess
load is governed by a backpressure policy (``"shed-newest"``,
``"shed-by-key-age"``, ``"block-with-deadline"``).  Every failure path
here is exercised by real injected faults (``core.faults``).

The device backend is ``"torch"`` (the JAX package's ``"jax"``), and
``device=None`` means the card; a worker builds and warms a card's plan
under ``torch.cuda.device`` of that card.
"""

from __future__ import annotations

import contextlib
import dataclasses
import queue
import random
import threading
import time
from collections import deque
from typing import Any, Callable, Optional

import torch

from repro_torch.core import api, backends, faults
from repro_torch.core.planner import plan_device

#: backpressure policies for PlanBuilder(max_pending=..., backpressure=...)
BACKPRESSURE_POLICIES = ("shed-newest", "shed-by-key-age",
                         "block-with-deadline")

_WATCHDOG_TICK = 0.05   # seconds between watchdog deadline scans


class BuildTimeoutError(TimeoutError):
    """A build exceeded its deadline; the watchdog failed the task and
    recycled the worker running it."""


class BuildCancelled(RuntimeError):
    """A queued task was dropped before starting (non-drain shutdown)."""


class BuildShed(RuntimeError):
    """A queued task was evicted by backpressure (``shed-by-key-age``)."""


@dataclasses.dataclass
class RetryPolicy:
    """Capped-exponential backoff with deterministic (seeded) jitter.

    Attempt ``k`` (1-based) that fails with ``k < max_attempts`` sleeps
    ``min(max_delay, base_delay * 2**(k-1))`` scaled by a jitter factor
    drawn uniformly from ``[1 - jitter, 1 + jitter]`` before retrying.
    Deadline (watchdog) expiry does NOT retry -- a hung build is assumed
    to hang again; only raising builds are considered transient.
    """

    max_attempts: int = 3
    base_delay: float = 0.05
    max_delay: float = 2.0
    jitter: float = 0.5
    seed: int = 0

    def __post_init__(self):
        if self.max_attempts < 1:
            raise ValueError(
                f"max_attempts must be >= 1, got {self.max_attempts}")

    def delay(self, attempt: int, rng: random.Random) -> float:
        d = min(self.max_delay, self.base_delay * (2 ** (attempt - 1)))
        if self.jitter:
            d *= 1.0 + self.jitter * (2.0 * rng.random() - 1.0)
        return max(0.0, d)


@dataclasses.dataclass
class BuildResult:
    """One completed background task, as drained from :meth:`poll`."""

    tag: Any
    key: Optional[tuple]
    plan: Any = None
    error: Optional[BaseException] = None
    seconds: float = 0.0
    attempts: int = 1

    @property
    def ok(self) -> bool:
        return self.error is None


@dataclasses.dataclass
class _Task:
    tag: Any
    key: Optional[tuple]
    fn: Callable[[], Any]
    deadline: Optional[float]       # per-attempt wall budget, seconds
    max_attempts: int
    enqueued: float = 0.0


class _Running:
    """One attempt in flight on one worker thread (watchdog bookkeeping)."""

    __slots__ = ("task", "started", "deadline", "abandoned")

    def __init__(self, task: _Task):
        self.task = task
        self.started = time.monotonic()
        self.deadline = task.deadline
        self.abandoned = False


def device_scope(dev):
    """``torch.cuda.device(dev)`` for a card, else a no-op context: work
    on a builder thread runs on the card its plan lives on."""
    dev = torch.device(dev)
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def warm_plan(plan) -> None:
    """Materialize a plan's expensive lazy state inside the builder.

    Touches the host product stream (the lazy build), and on the torch
    backend also lifts the device stream and runs one throwaway
    ``stream_apply`` on zeros on the plan's device, waiting for the card --
    the state a serving tick would otherwise pay for on first use.  Guarded
    plans (``plan.stream is None``) have nothing to warm.  Safe to call on
    any plan; unknown plan types are ignored.
    """
    faults.check("warm_compile", key=getattr(plan, "backend", None))
    stream = getattr(plan, "stream", None)
    if stream is None:
        return
    if getattr(plan, "backend", None) == "torch":
        dev = plan.device
        with device_scope(dev):
            plan.stream_apply(torch.zeros(plan.a.nnz, device=dev),
                              torch.zeros(plan.b.nnz, device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)


class PlanBuilder:
    """Thread-pool plan builder with a completion queue.

    ::

        builder = PlanBuilder()
        builder.submit(a, b, "expand")                  # torch, non-blocking
        ...
        for res in builder.poll():                      # drain completions
            ...
        plan, status = builder.plan_or_fallback(a, b, "expand")

    ``workers=1`` (the default) keeps device builds serialized: serving
    cares about the *foreground* tick latency, not build throughput.  All workers are
    daemon threads; call :meth:`shutdown` (or use the context manager) for
    a deterministic exit.

    Resilience knobs: ``retry`` (a :class:`RetryPolicy`;
    failed attempts back off and retry inside the worker),
    ``build_deadline`` (default per-attempt wall budget -- past it the
    watchdog fails the task with :class:`BuildTimeoutError` and recycles
    the worker), ``backpressure`` + ``max_pending`` (what happens when
    the queue is full: ``"shed-newest"`` rejects the new submit,
    ``"shed-by-key-age"`` evicts the oldest still-queued task to admit
    the new one, ``"block-with-deadline"`` blocks the submitter up to
    ``block_timeout`` seconds for a slot, then sheds).
    """

    def __init__(self, workers: int = 1, max_pending: int | None = None,
                 *, backpressure: str = "shed-newest",
                 retry: RetryPolicy | None = None,
                 build_deadline: float | None = None,
                 block_timeout: float = 1.0):
        if workers < 1:
            raise ValueError(f"workers must be >= 1, got {workers}")
        if backpressure not in BACKPRESSURE_POLICIES:
            raise ValueError(
                f"unknown backpressure policy {backpressure!r}; one of "
                f"{BACKPRESSURE_POLICIES}")
        self._queue: "deque[_Task]" = deque()
        self._completions: "queue.Queue" = queue.Queue()
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._inflight: set = set()     # plan keys queued or building
        self._pending = 0               # tasks queued or running
        self._stopped = False           # no new submissions
        self._exit_event = threading.Event()    # workers + watchdog leave
        self._stop_event = threading.Event()    # cuts backoff sleeps short
        self._running: "dict[threading.Thread, _Running]" = {}
        self.max_pending = max_pending
        self.backpressure = backpressure
        self.retry = retry if retry is not None else RetryPolicy()
        self.build_deadline = build_deadline
        self.block_timeout = block_timeout
        self._jitter_rng = random.Random(self.retry.seed)
        self.stats = {"submitted": 0, "completed": 0, "failed": 0,
                      "deduped": 0, "shed": 0, "cached": 0, "rewarmed": 0,
                      "retries": 0, "timed_out": 0, "cancelled": 0,
                      "workers_recycled": 0}
        self._known: dict = {}          # plan key -> submit() kwargs
        self._rewarm_cb = None
        self._worker_seq = workers
        self._threads = [
            threading.Thread(target=self._worker, daemon=True,
                             name=f"plan-builder-{i}")
            for i in range(workers)]
        for t in self._threads:
            t.start()
        self._watchdog_thread = threading.Thread(
            target=self._watchdog, daemon=True, name="plan-builder-watchdog")
        self._watchdog_thread.start()
        api._register_builder(self)

    # -- submission ----------------------------------------------------------

    def submit(self, a, b, method: str | None = None, *,
               backend: str = "torch", t: float | None = None,
               b_min: int | None = None, b_max: int | None = None,
               stream_limit: int | None = None, device=None,
               warm: bool = True, deadline: float | None = None,
               retries: int | None = None, tag: Any = None) -> str:
        """Enqueue a background build of ``cached_plan(a, b, method, ...)``.

        Returns a status string, never blocks on the build itself (except
        under ``backpressure="block-with-deadline"``, which may wait up to
        ``block_timeout`` for a queue slot):

        * ``"cached"``    -- the plan is already in the LRU; nothing queued.
        * ``"inflight"``  -- the same key is already queued or building.
        * ``"shed"``      -- backpressure dropped the build (the caller
          keeps using its fallback and may resubmit later).
        * ``"submitted"`` -- queued; a :class:`BuildResult` will appear in
          :meth:`poll` when it lands in the LRU.

        ``device`` is the plan's (``None``: the card on the device
        backends).  ``deadline`` overrides the builder's
        ``build_deadline`` for this task; ``retries`` overrides
        ``retry.max_attempts``.
        """
        key = api.plan_cache_key(a, b, method, backend=backend, t=t,
                                 b_min=b_min, b_max=b_max,
                                 stream_limit=stream_limit, device=device)
        dev = plan_device(backends.get_backend(backend), device)
        with self._lock:
            # remember how to rebuild this key so a post-shrink re-warm
            # (rewarm / enable_rewarm) can resubmit it without the caller
            self._known[key] = dict(a=a, b=b, method=method,
                                    backend=backend, t=t, b_min=b_min,
                                    b_max=b_max, stream_limit=stream_limit,
                                    device=device, warm=warm)
        if api.plan_cache_peek(key) is not None:
            self.stats["cached"] += 1
            return "cached"

        def build():
            with device_scope(dev):
                plan = api.cached_plan(a, b, method, backend=backend, t=t,
                                       b_min=b_min, b_max=b_max,
                                       stream_limit=stream_limit,
                                       device=dev)
                if warm:
                    warm_plan(plan)
            return plan

        return self._enqueue(_Task(
            tag=key if tag is None else tag, key=key, fn=build,
            deadline=self.build_deadline if deadline is None else deadline,
            max_attempts=(self.retry.max_attempts if retries is None
                          else max(1, int(retries)))))

    def submit_task(self, fn: Callable[[], Any], tag: Any = None, *,
                    deadline: float | None = None,
                    retries: int | None = None) -> str:
        """Enqueue an arbitrary warm job (no key dedup).

        The serving engine uses this to warm its sparse decode step in the
        background (every overlay plan builds through the locked LRU and
        lifts its device stream as a side effect).  The callable's return value
        rides in ``BuildResult.plan``.  Default ``retries=1``: arbitrary
        callables are not assumed idempotent, so the builder does not
        retry them unless asked.
        """
        return self._enqueue(_Task(
            tag=tag, key=None, fn=fn,
            deadline=self.build_deadline if deadline is None else deadline,
            max_attempts=1 if retries is None else max(1, int(retries))))

    def _enqueue(self, task: _Task) -> str:
        with self._cv:
            if self._stopped:
                raise RuntimeError("PlanBuilder is shut down")
            if task.key is not None and task.key in self._inflight:
                self.stats["deduped"] += 1
                return "inflight"
            if self.max_pending is not None \
                    and self._pending >= self.max_pending:
                if self.backpressure == "block-with-deadline":
                    ok = self._cv.wait_for(
                        lambda: self._stopped
                        or self._pending < self.max_pending,
                        timeout=self.block_timeout)
                    if self._stopped:
                        raise RuntimeError("PlanBuilder is shut down")
                    if not ok:
                        self.stats["shed"] += 1
                        return "shed"
                    if task.key is not None \
                            and task.key in self._inflight:
                        # a duplicate was admitted while we blocked
                        self.stats["deduped"] += 1
                        return "inflight"
                elif self.backpressure == "shed-by-key-age" and self._queue:
                    # evict the oldest still-queued task to admit the new
                    # one; its submitter learns through the completion
                    old = self._queue.popleft()
                    self.stats["shed"] += 1
                    self._finalize_locked(old, error=BuildShed(
                        "evicted from the build queue by newer work "
                        "(backpressure: shed-by-key-age)"))
                else:   # shed-newest, or nothing queued to evict
                    self.stats["shed"] += 1
                    return "shed"
            if task.key is not None:
                self._inflight.add(task.key)
            task.enqueued = time.monotonic()
            self._pending += 1
            self.stats["submitted"] += 1
            self._queue.append(task)
            self._cv.notify()
        return "submitted"

    def plan_or_fallback(self, a, b, method: str | None = None, *,
                         backend: str = "torch",
                         fallback_backend: str = "host",
                         stream_limit: int | None = None, device=None,
                         warm: bool = True):
        """Non-blocking plan fetch for a latency-critical tick.

        Probes the LRU for the ``backend`` plan on ``device`` without
        mutating it; on a miss, enqueues the background build and
        synchronously returns the cheap ``fallback_backend`` plan instead
        (host symbolic phase only -- no device lift, no replay on the
        card).  Returns ``(plan, status)`` with status ``"ready"`` (device
        plan served) or ``"fallback"``.
        """
        key = api.plan_cache_key(a, b, method, backend=backend,
                                 stream_limit=stream_limit, device=device)
        plan = api.plan_cache_peek(key)
        if plan is not None:
            return plan, "ready"
        self.submit(a, b, method, backend=backend,
                    stream_limit=stream_limit, device=device, warm=warm)
        fb = api.cached_plan(a, b, method, backend=fallback_backend,
                             stream_limit=stream_limit)
        return fb, "fallback"

    # -- post-shrink re-warm ---------------------------------

    def rewarm(self, keys) -> int:
        """Resubmit builds for evicted plan keys this builder has seen.

        ``plan_cache_resize()`` shrinking below the number of in-flight
        builds silently evicts completed builds (the ``wasted_builds``
        counter in ``plan_cache_info()``); this re-queues the known ones so
        the cache re-converges in the background.  Keys this builder never
        built are skipped.  Returns the number of builds resubmitted.
        """
        count = 0
        for key in keys:
            with self._lock:
                spec = self._known.get(key)
            if spec is None:
                continue
            spec = dict(spec)
            a, b, method = spec.pop("a"), spec.pop("b"), spec.pop("method")
            try:
                if self.submit(a, b, method, tag=("rewarm", key),
                               **spec) == "submitted":
                    count += 1
                    self.stats["rewarmed"] += 1
            except RuntimeError:
                break   # shut down mid-notification; nothing to re-queue
        return count

    def enable_rewarm(self) -> None:
        """Hook :meth:`rewarm` to the plan cache's post-shrink evictions.

        Registers an ``api.register_eviction_listener`` callback that
        resubmits this builder's evicted keys after every
        ``plan_cache_resize()`` shrink (capacity-pressure evictions never
        notify, so re-warming cannot fight the LRU).  Idempotent;
        unhooked automatically by :meth:`shutdown`.
        """
        if self._rewarm_cb is None:
            def cb(keys, reason):
                if reason == "resize":
                    self.rewarm(keys)

            self._rewarm_cb = cb
            api.register_eviction_listener(cb)

    def disable_rewarm(self) -> None:
        """Unhook the :meth:`enable_rewarm` listener (idempotent)."""
        if self._rewarm_cb is not None:
            api.unregister_eviction_listener(self._rewarm_cb)
            self._rewarm_cb = None

    # -- completion / lifecycle ----------------------------------------------

    def poll(self) -> list:
        """Drain the completion queue (non-blocking)."""
        out = []
        while True:
            try:
                out.append(self._completions.get_nowait())
            except queue.Empty:
                return out

    def pending(self) -> int:
        with self._lock:
            return self._pending

    def info(self) -> dict:
        """Stats + live queue depth / worker counts -- surfaced alongside
        the cache telemetry in ``plan_cache_info()['builders']``."""
        with self._lock:
            return dict(self.stats, pending=self._pending,
                        queue_depth=len(self._queue),
                        running=len(self._running),
                        workers=len(self._threads),
                        max_pending=self.max_pending,
                        backpressure=self.backpressure)

    def wait_idle(self, timeout: float | None = None) -> bool:
        """Block until every queued/running task completed (tests, drain)."""
        with self._cv:
            return self._cv.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, wait: bool = True, drain: bool = False) -> None:
        """Stop accepting work and exit the workers.  Idempotent: a second
        call is a no-op.

        ``drain=True`` finishes all queued work first (blocks until the
        queue and running tasks empty, then joins).  ``drain=False`` (the
        default) cancels queued-but-unstarted tasks -- each is delivered to
        :meth:`poll` with a :class:`BuildCancelled` error and counted as
        ``cancelled`` -- and cuts retry backoffs short; running attempts
        finish.  ``wait=False`` skips joining the worker threads.
        """
        self.disable_rewarm()
        with self._cv:
            if self._stopped:
                return
            self._stopped = True
        api._unregister_builder(self)
        if drain:
            self.wait_idle()
        else:
            self._stop_event.set()
            with self._cv:
                cancelled, self._queue = list(self._queue), deque()
                for task in cancelled:
                    self.stats["cancelled"] += 1
                    self._finalize_locked(task, error=BuildCancelled(
                        "builder shut down before the task started"))
        self._stop_event.set()
        self._exit_event.set()
        with self._cv:
            self._cv.notify_all()
        if wait:
            for t in list(self._threads):
                t.join()
            self._watchdog_thread.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.shutdown()
        return False

    # -- internals -----------------------------------------------------------

    def _finalize_locked(self, task: _Task, plan=None, error=None,
                         seconds: float = 0.0, attempts: int = 1) -> None:
        """Account one task's terminal state (lock held) and publish it."""
        if task.key is not None:
            self._inflight.discard(task.key)
        self._pending -= 1
        if error is None:
            self.stats["completed"] += 1
        elif isinstance(error, Exception) \
                and not isinstance(error, (BuildCancelled, BuildShed)):
            self.stats["failed"] += 1
        self._cv.notify_all()
        self._completions.put(BuildResult(task.tag, task.key, plan, error,
                                          seconds, attempts))

    def _next_task(self) -> Optional[_Task]:
        with self._cv:
            while True:
                if self._queue:
                    return self._queue.popleft()
                if self._exit_event.is_set():
                    return None
                self._cv.wait()

    def _worker(self) -> None:
        me = threading.current_thread()
        while True:
            task = self._next_task()
            if task is None:
                return
            if not self._run_task(me, task):
                return      # abandoned by the watchdog: slot was recycled

    def _run_task(self, me: threading.Thread, task: _Task) -> bool:
        """Run one task to a terminal state (retrying per policy).

        Returns False when the watchdog abandoned this thread mid-attempt
        (the task was already finalized and the worker slot recycled) --
        the zombie thread must exit instead of touching shared state.
        """
        attempt = 0
        while True:
            attempt += 1
            rec = _Running(task)
            with self._lock:
                self._running[me] = rec
            plan, err = None, None
            t0 = time.perf_counter()
            try:
                faults.check("builder_worker",
                             key=task.key if task.key is not None
                             else task.tag)
                with self._lock:
                    if rec.abandoned:
                        # the watchdog finalized this attempt while we were
                        # wedged before fn even started -- don't burn the
                        # zombie thread on a build nobody will receive
                        return False
                plan = task.fn()
            except BaseException as e:  # noqa: BLE001 -- reported via poll()
                err = e
            dt = time.perf_counter() - t0
            with self._cv:
                mine = self._running.pop(me, None)
                if rec.abandoned or mine is not rec:
                    return False    # watchdog finalized + replaced us
                if err is None:
                    self._finalize_locked(task, plan=plan, seconds=dt,
                                          attempts=attempt)
                    return True
                if attempt >= task.max_attempts \
                        or self._stop_event.is_set():
                    self._finalize_locked(task, error=err, seconds=dt,
                                          attempts=attempt)
                    return True
                self.stats["retries"] += 1
                backoff = self.retry.delay(attempt, self._jitter_rng)
            # outside the lock: backoff sleep, cut short by shutdown
            self._stop_event.wait(backoff)
            if self._stop_event.is_set():
                with self._cv:
                    self._finalize_locked(task, error=err, seconds=dt,
                                          attempts=attempt)
                return True

    def _watchdog(self) -> None:
        """Fail over-deadline attempts and recycle their workers.

        A worker past its task's deadline is presumed wedged (a hung
        device lift, a stuck gather): the task is finalized as failed
        with :class:`BuildTimeoutError`, the thread is abandoned (daemon;
        it exits on its own once the hang releases -- its late result is
        discarded) and a fresh worker thread takes the slot, so capacity
        is never permanently lost.
        """
        while not self._exit_event.wait(_WATCHDOG_TICK):
            now = time.monotonic()
            with self._cv:
                for th, rec in list(self._running.items()):
                    if rec.deadline is None or rec.abandoned:
                        continue
                    if now - rec.started < rec.deadline:
                        continue
                    rec.abandoned = True
                    del self._running[th]
                    self.stats["timed_out"] += 1
                    self.stats["workers_recycled"] += 1
                    self._finalize_locked(rec.task, error=BuildTimeoutError(
                        f"build exceeded its {rec.deadline:.3f}s deadline; "
                        "worker recycled"))
                    try:
                        self._threads.remove(th)
                    except ValueError:
                        pass
                    nt = threading.Thread(
                        target=self._worker, daemon=True,
                        name=f"plan-builder-{self._worker_seq}")
                    self._worker_seq += 1
                    self._threads.append(nt)
                    nt.start()
