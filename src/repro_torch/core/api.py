"""Public SpGEMM API of the port: ``spgemm(A, B, method=...)`` over cached
plans.

Methods mirror the paper's evaluated algorithms (and the host-only ``esc``
and ``expand``); the default is the paper's best, ``"h-hash-256/256"``.
``spgemm`` builds — or fetches from a bounded, thread-safe LRU keyed on
pattern fingerprints, the method, its resolved parameters, the backend, the
stream limit and the device — a
:class:`~repro_torch.core.planner.SpgemmPlan` and executes it against the
operand values::

    plan = cached_plan(a, b)                 # symbolic phase, once
    c1 = plan.execute(a_vals_1, b_vals_1)    # numeric phase only
    c2 = spgemm(a2, b2, plan=plan)           # the same, spelled as a call

Backends (``core.backends``): ``"cuda"`` (the default; the per-group
kernels, or K1 under ``engine="fused"``), ``"torch"`` (the product stream
in PyTorch ops, differentiable through ``plan.stream_apply``; every method
spelling shares one canonical plan) and ``"host"`` (the numpy oracles and
stream, bit for bit the JAX package's host backend).  ``t``/``b_min``/
``b_max`` override the named method's parameters (the torch backend
rejects them); a held ``plan=`` carries its own method, backend, parameters
and device, and explicit arguments that conflict with it raise;
``cache=False`` plans afresh outside the LRU; ``validate="fingerprint"``
re-hashes the operands' structure against the plan.

``spgemm_batched(A, B)`` multiplies B same-pattern value sets
(:class:`~repro_torch.sparse.format.BatchedCSC`) through one execution of
the same plan.

``method="auto"`` builds a :class:`~repro_torch.core.planner.
TiledSpgemmPlan`: the operands are cut into a 2-D tile grid (sized from
their nnz, or by ``tile=``) and each tile runs the candidate the cost model
(``core.cost``) predicts cheapest; ``candidates=`` restricts the choice.

``backend="mesh"`` shards the product stream over ``shards`` shards
(``distributed.spgemm_mesh``; default one a visible card), the plan-memory
guard applying per shard: ``device=None`` runs shard d on ``cuda:d``, a
named device runs every shard there.  With ``method="auto"`` the cost
model's ``should_distribute`` decides whether to shard at all, else the
torch backend's tile grid runs on one device.

``device=None`` means the card (``"cuda"``) on the device backends, and
raises without one; pass ``device="cpu"`` to run the kernels' plain
versions and the torch stream on the host.  The host backend runs on the
CPU, and asking it for another device raises.

The LRU builds each key once across threads (single-flight: a waiter
takes the owner's plan, bounded by ``build_timeout=``), and a background
:class:`~repro_torch.core.plan_builder.PlanBuilder` shares it:
``plan_cache_key`` and ``plan_cache_peek`` probe it without building or
counting, and eviction listeners hear of a ``plan_cache_resize`` shrink.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict

import torch

from repro_torch.core import backends, fast, profile
from repro_torch.core.cost import check_candidates, should_distribute
from repro_torch.core.planner import (
    ALGORITHMS,
    SpgemmPlan,
    TiledSpgemmPlan,
    normalize_tile_spec,
    pattern_fingerprint,
    plan_device,
    plan_spgemm,
    plan_spgemm_tiled,
    resolve_params,
    tiled_device,
    tiled_plan_key,
)
from repro_torch.device import resolve_device
from repro_torch.sparse.format import CSC, BatchedCSC
from repro_torch.sparse.stats import tile_stats

DEFAULT_METHOD = "h-hash-256/256"
DEFAULT_BACKEND = "cuda"


def _held(plans, attr: str) -> int:
    """Bytes ``attr`` over the plans, each plan once: a tiled plan counts
    through its children, which the LRU may also hold on their own."""
    seen = {}
    for p in plans:
        for sp in [t.plan for t in getattr(p, "tiles", ())] or [p]:
            seen[id(sp)] = getattr(sp, attr, 0)
    return sum(seen.values())


class PlanBuildTimeout(TimeoutError):
    """A single-flight waiter outlived its deadline on another thread's
    in-flight build (the build itself may still complete later)."""


#: Default bound (seconds) on how long a caller may wait on ANOTHER
#: thread's in-flight build of the same key before it raises
#: :class:`PlanBuildTimeout`.  ``None`` waits forever;
#: ``cached_plan(build_timeout=...)`` overrides it per call.  Owners are
#: never interrupted -- only waiters time out.
DEFAULT_BUILD_TIMEOUT: float | None = None

# Weak references to live PlanBuilders: plan_cache_info() lists their
# queue-depth / retry / recycle counters next to the cache's, so one probe
# reads the whole pipeline's health.
_BUILDERS: "list[weakref.ref]" = []
_BUILDERS_LOCK = threading.Lock()


def _register_builder(builder) -> None:
    with _BUILDERS_LOCK:
        _BUILDERS[:] = [r for r in _BUILDERS if r() is not None]
        _BUILDERS.append(weakref.ref(builder))


def _unregister_builder(builder) -> None:
    with _BUILDERS_LOCK:
        _BUILDERS[:] = [r for r in _BUILDERS
                        if r() is not None and r() is not builder]


class PlanCache:
    """Bounded LRU of plans with hit/miss/eviction counters, single-flight.

    Every read or write of the entries and counters holds the lock; the
    symbolic build itself runs outside it.  One ``threading.Event`` per key
    with a build in flight makes concurrent requests for that key wait for
    the owner's build instead of duplicating it: a waiter takes the owner's
    result (a hit), and a failed owner wakes the waiters, one of which
    builds again.  ``wasted_builds`` counts evicted entries that were never
    hit after insertion (a build the cache could not keep: a
    :meth:`resize` below the builds in flight); ``wait_timeouts`` waiters
    past their deadline; ``listener_errors`` eviction listeners that
    raised.
    """

    def __init__(self, max_size: int = 64):
        self.max_size = int(max_size)
        self._lock = threading.RLock()
        self._plans: "OrderedDict[tuple, SpgemmPlan]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0,
                       "wasted_builds": 0, "listener_errors": 0,
                       "wait_timeouts": 0}
        self._building: "dict[tuple, threading.Event]" = {}
        # keys inserted but never since hit: evicting one is a wasted build
        self._never_hit: set = set()
        # fn(keys, reason), called outside the lock after a resize() shrink
        self._listeners: list = []

    def get_or_build(self, key, build, timeout: float | None = None):
        """The plan of ``key`` from the LRU, or ``build()`` run exactly
        once across threads.  ``timeout`` (default
        :data:`DEFAULT_BUILD_TIMEOUT`) bounds how long a *waiter* blocks on
        another thread's build of the same key; past it
        :class:`PlanBuildTimeout` is raised.  With ``max_size == 0`` the
        published entry is evicted at once, so every caller builds."""
        if timeout is None:
            timeout = DEFAULT_BUILD_TIMEOUT
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            with self._lock:
                plan = self._plans.get(key)
                if plan is not None:
                    self._plans.move_to_end(key)
                    self._stats["hits"] += 1
                    self._never_hit.discard(key)
                    return plan
                done = self._building.get(key)
                owner = done is None
                if owner:
                    done = self._building[key] = threading.Event()
                    self._stats["misses"] += 1
            if owner:
                try:
                    plan = build()
                    self._put(key, plan)
                finally:
                    with self._lock:
                        self._building.pop(key, None)
                    done.set()
                return plan
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if (remaining is not None and remaining <= 0) \
                    or not done.wait(remaining):
                with self._lock:
                    self._stats["wait_timeouts"] += 1
                raise PlanBuildTimeout(
                    f"waited {timeout:.3f}s on another thread's in-flight "
                    f"build of plan key {key[2:4]}; the build may still "
                    "land later -- retry, or serve a fallback plan")

    def _put(self, key, plan) -> None:
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            self._never_hit.add(key)
            while len(self._plans) > self.max_size:
                self._evict_locked()

    def _evict_locked(self):
        """Pop the LRU head (lock held); counts the eviction and a waste,
        returns its key."""
        key, _ = self._plans.popitem(last=False)
        self._stats["evictions"] += 1
        if key in self._never_hit:
            self._never_hit.discard(key)
            self._stats["wasted_builds"] += 1
        return key

    def peek(self, key):
        """The plan of ``key`` or ``None``: no promotion, no counting."""
        with self._lock:
            return self._plans.get(key)

    def info(self) -> dict:
        with self._lock:
            lookups = self._stats["hits"] + self._stats["misses"]
            plans = list(self._plans.values())
            return dict(self._stats, size=len(self._plans),
                        max_size=self.max_size,
                        hit_rate=(self._stats["hits"] / lookups
                                  if lookups else 0.0),
                        in_flight=len(self._building),
                        stream_bytes=_held(plans, "stream_nbytes"),
                        device_stream_bytes=_held(plans,
                                                  "device_stream_nbytes"),
                        fused_stream_bytes=_held(plans,
                                                 "fused_stream_nbytes"),
                        mesh_stream_bytes=sum(
                            {id(p): getattr(p, "mesh_stream_nbytes", 0)
                             for p in plans}.values()))

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            self._never_hit.clear()
            for k in self._stats:
                self._stats[k] = 0

    def resize(self, n: int) -> dict:
        """Set the capacity, evicting the least recently used overflow;
        the evicted keys go to each listener as ``fn(keys, "resize")``,
        outside the lock (a listener may re-enter the cache).  A raising
        listener is counted in ``listener_errors`` and does not stop the
        others or reach the caller."""
        n = int(n)
        if n < 0:
            raise ValueError(f"cache size must be >= 0, got {n}")
        evicted = []
        with self._lock:
            self.max_size = n
            while len(self._plans) > self.max_size:
                evicted.append(self._evict_locked())
        if evicted:
            for fn in list(self._listeners):
                try:
                    fn(tuple(evicted), "resize")
                except Exception:
                    with self._lock:
                        self._stats["listener_errors"] += 1
        return self.info()


#: the process-wide plan LRU behind spgemm() and cached_plan()
PLAN_CACHE = PlanCache()


def plan_cache_info() -> dict:
    """Occupancy, hit/miss/eviction counters and hit rate of the plan LRU.

    ``stream_bytes`` totals the host product streams the cached plans hold,
    ``device_stream_bytes`` the torch stream's index tensors on their
    devices (``core.device_stream``) and ``fused_stream_bytes`` the K1 views
    (``core.fused_stream``); each is built at a plan's first execution
    through its engine, one plan may hold all three, and a guarded plan
    holds none.  A tiled or mesh plan's streams are its children's, counted
    once however many tiles or cache entries share a child;
    ``mesh_stream_bytes`` adds the mesh plans' own sharded streams (host
    index arrays and the shards' device views).  ``profile`` is the
    machine profile's provenance and counters (``core.profile``): which
    constants auto plans rank under, how old the calibration is, and how
    often auto ranked device engines on the uncalibrated defaults.

    The resilience counters: ``in_flight`` builds now running,
    ``wasted_builds`` entries evicted before their first hit,
    ``wait_timeouts`` single-flight waiters past their ``build_timeout``,
    ``listener_errors`` eviction listeners that raised, and ``builders``
    each live :class:`~repro_torch.core.plan_builder.PlanBuilder`'s
    ``info()`` (queue depth, retries, timeouts, recycled workers,
    backpressure policy).
    """
    out = PLAN_CACHE.info()
    with _BUILDERS_LOCK:
        refs = list(_BUILDERS)
    # builder.info() takes the builder's own lock: outside ours
    out["builders"] = [b.info() for b in (r() for r in refs)
                       if b is not None]
    out["profile"] = profile.profile_info()
    return out


def plan_cache_clear() -> None:
    """Drop all cached plans and reset the counters."""
    PLAN_CACHE.clear()


def plan_cache_resize(n: int) -> dict:
    """Set the LRU capacity (evicting least-recently-used overflow, which
    the eviction listeners hear of); ``n == 0`` disables caching.  Returns
    :func:`plan_cache_info`."""
    PLAN_CACHE.resize(n)
    return plan_cache_info()


def plan_cache_peek(key):
    """Non-mutating lookup: the plan of ``key`` (from
    :func:`plan_cache_key`) or ``None``, with no LRU promotion and no
    counter update -- the probe a latency-critical tick makes while a
    background builder owns the build."""
    return PLAN_CACHE.peek(key)


def register_eviction_listener(fn) -> None:
    """Register ``fn(keys, reason)`` for post-shrink eviction batches.

    Called outside the cache lock after :func:`plan_cache_resize` evicts
    entries (``reason="resize"``); capacity-pressure evictions from normal
    inserts never notify.  A listener's exception is counted in
    ``listener_errors`` and swallowed.  The standard listener is
    ``PlanBuilder.enable_rewarm()``, which re-queues the evicted keys'
    builds.
    """
    if fn not in PLAN_CACHE._listeners:
        PLAN_CACHE._listeners.append(fn)


def unregister_eviction_listener(fn) -> None:
    """Remove a listener registered by :func:`register_eviction_listener`."""
    if fn in PLAN_CACHE._listeners:
        PLAN_CACHE._listeners.remove(fn)


def _resolve_method_backend(method, backend):
    method = DEFAULT_METHOD if method is None else method
    backend = DEFAULT_BACKEND if backend is None else backend
    if method != "auto" and method not in ALGORITHMS:
        raise ValueError(
            f"unknown method {method!r}; one of {list(ALGORITHMS)} or "
            "'auto'")
    return method, backends.get_backend(backend)


def _plan_key(a: CSC, b: CSC, method: str, contract, params: dict,
              dev, stream_limit: int | None = None) -> tuple:
    """The LRU key: both patterns, the method and its resolved parameters
    (the canonical method and its defaults on a canonical-method backend,
    so every spelling shares one entry), the backend, the plan's stream
    limit (``stream_limit``, else the guard in force at build time) and the
    device."""
    if contract.canonical_method:
        method = contract.canonical_method
        params = resolve_params(method)
    limit = (fast.STREAM_MAX_PRODUCTS if stream_limit is None
             else int(stream_limit))
    return (pattern_fingerprint(a), pattern_fingerprint(b), method,
            contract.name, tuple(sorted(params.items())), limit, str(dev))


def plan_cache_key(a: CSC, b: CSC, method: str | None = None, *,
                   backend: str | None = None, t: float | None = None,
                   b_min: int | None = None, b_max: int | None = None,
                   stream_limit: int | None = None, device=None,
                   shards: int | None = None) -> tuple:
    """The LRU key :func:`cached_plan` would use for these arguments.

    For non-blocking probes: compute the key once, then
    :func:`plan_cache_peek` it on the latency path while a background
    :class:`~repro_torch.core.plan_builder.PlanBuilder` owns the build.
    Costs two pattern fingerprints (O(nnz)), no plan construction; the key
    holds the stream limit and the device.  On ``backend="mesh"`` it holds
    the shard count (``shards``, default one a visible card), the
    per-shard guard, the tile spec and the profile's tag as well.
    """
    method, contract = _resolve_method_backend(method, backend)
    _check_shards(contract, shards)
    if method == "auto":
        raise ValueError(
            "plan_cache_key addresses single-method plans; method='auto' "
            "uses the tiled entry points")
    backends.check_method_knobs(contract, t, b_min, b_max)
    if contract.name == "mesh":
        return _mesh_plan_key(a, b, shards, None, stream_limit, device)
    params = resolve_params(method, t=t, b_min=b_min, b_max=b_max)
    return _plan_key(a, b, method, contract, params,
                     plan_device(contract, device), stream_limit)


def cached_plan(a: CSC, b: CSC, method: str | None = None, *,
                backend: str | None = None, t: float | None = None,
                b_min: int | None = None, b_max: int | None = None,
                stream_limit: int | None = None,
                device=None,
                shards: int | None = None,
                build_timeout: float | None = None) -> SpgemmPlan:
    """Fetch-or-build a plan through the shared LRU.

    Arguments as in :func:`spgemm`; on ``backend="mesh"`` a
    :class:`~repro_torch.distributed.spgemm_mesh.ShardedSpgemmPlan`, with
    ``stream_limit`` its per-shard guard.  ``stream_limit`` overrides the
    stream guard for this plan only (part of the key), without touching the
    global ``fast.STREAM_MAX_PRODUCTS``; with ``None`` the plan keeps the
    guard in force when it was built, which is part of the key too.  One
    key builds once across threads (single-flight); ``build_timeout``
    bounds how long this call may wait on *another* thread's build of the
    same key (:class:`PlanBuildTimeout` past it; default
    :data:`DEFAULT_BUILD_TIMEOUT`).
    """
    method, contract = _resolve_method_backend(method, backend)
    _check_shards(contract, shards)
    if method == "auto":
        raise ValueError(
            "cached_plan builds single-method plans; use plan_spgemm_tiled "
            "for method='auto'")
    backends.check_method_knobs(contract, t, b_min, b_max)
    if contract.name == "mesh":
        return _cached_mesh_plan(a, b, shards, None, stream_limit, device,
                                 build_timeout)
    params = resolve_params(method, t=t, b_min=b_min, b_max=b_max)
    dev = plan_device(contract, device)
    return PLAN_CACHE.get_or_build(
        _plan_key(a, b, method, contract, params, dev, stream_limit),
        lambda: plan_spgemm(a, b, method, backend=contract.name, t=t,
                            b_min=b_min, b_max=b_max, device=dev,
                            stream_limit=stream_limit),
        timeout=build_timeout)


def _cached_tiled_plan(a: CSC, b: CSC, contract, tile, candidates,
                       device) -> TiledSpgemmPlan:
    """Fetch-or-build a tiled plan through the LRU.  The default candidate
    set is resolved before keying, so an explicit ``candidates=`` equal to
    the backend's default hits the same entry; the machine profile's tag
    keys it too, so picks ranked under one calibration are never handed to
    a call running under another."""
    spec = normalize_tile_spec(tile)
    cands = check_candidates(contract, candidates)
    key = tiled_plan_key(pattern_fingerprint(a), pattern_fingerprint(b),
                         contract.name, spec, cands,
                         profile.current_profile().tag,
                         fast.STREAM_MAX_PRODUCTS,
                         tiled_device(contract, device))
    return PLAN_CACHE.get_or_build(
        key, lambda: plan_spgemm_tiled(a, b, backend=contract.name,
                                       tile=tile, candidates=cands,
                                       device=device))


def _mesh_plan_key(a: CSC, b: CSC, shards, tile,
                   stream_limit: int | None = None, device=None) -> tuple:
    """The LRU key of a mesh plan: the shard count, the per-shard guard and
    the grid spec are different placements, and the profile's tag ranks
    the placement, so all of them key it, with the device."""
    from repro_torch.distributed.spgemm_mesh import mesh_plan_key, \
        resolve_shards

    dev = None if device is None else resolve_device(device)
    limit = (fast.STREAM_MAX_PRODUCTS if stream_limit is None
             else int(stream_limit))
    params = (("profile", profile.current_profile().tag),
              ("shard_limit", limit), ("shards", resolve_shards(shards, dev)),
              ("tile", normalize_tile_spec(tile)))
    return mesh_plan_key(pattern_fingerprint(a), pattern_fingerprint(b),
                         params, dev)


def _cached_mesh_plan(a: CSC, b: CSC, shards=None, tile=None,
                      stream_limit: int | None = None, device=None,
                      build_timeout: float | None = None):
    """Fetch-or-build a mesh plan through the LRU."""
    from repro_torch.distributed.spgemm_mesh import plan_spgemm_mesh

    key = _mesh_plan_key(a, b, shards, tile, stream_limit, device)
    n_shards = dict(key[4])["shards"]
    return PLAN_CACHE.get_or_build(
        key, lambda: plan_spgemm_mesh(a, b, shards=n_shards, tile=tile,
                                      shard_limit=stream_limit,
                                      device=device),
        timeout=build_timeout)


def _auto_mesh_plan(a: CSC, b: CSC, shards, tile, candidates, cache,
                    device):
    """``method="auto"`` on the mesh backend: shard where the cost model's
    :func:`~repro_torch.core.cost.should_distribute` says so (the whole
    stream above one device's guard, or the mesh estimate below the single
    device's), else the torch backend's tile grid on one device, whose
    per-tile race still applies (the reference's jax grid)."""
    from repro_torch.distributed.spgemm_mesh import plan_spgemm_mesh, \
        resolve_shards

    n_shards = resolve_shards(
        shards, None if device is None else resolve_device(device))
    if should_distribute(tile_stats(a, b), n_shards):
        if cache:
            return _cached_mesh_plan(a, b, n_shards, tile, None, device)
        return plan_spgemm_mesh(a, b, shards=n_shards, tile=tile,
                                cache=False, device=device)
    if cache:
        return _cached_tiled_plan(a, b, backends.get_backend("torch"), tile,
                                  candidates, device)
    return plan_spgemm_tiled(a, b, backend="torch", tile=tile,
                             candidates=candidates, cache=False,
                             device=device)


def _check_shards(contract, shards) -> None:
    if shards is not None and contract.name != "mesh":
        raise ValueError(
            f"shards= applies only to backend='mesh', not "
            f"{contract.name!r}")


def _check_auto_only(method, t, b_min, b_max, tile, candidates) -> None:
    """Arguments of one mode must not be passed with the other."""
    if method != "auto" and (tile is not None or candidates is not None):
        raise ValueError(
            "tile=/candidates= only apply to method='auto' "
            f"(got method={method!r})")
    if method == "auto" and (t is not None or b_min is not None
                             or b_max is not None):
        raise ValueError(
            "t/b_min/b_max do not apply to method='auto' (per-tile methods "
            "use their own defaults; restrict candidates= instead)")


def _plan_for(a, b, method, backend, t, b_min, b_max, device, cache,
              tile=None, candidates=None, shards=None):
    """The plan of a call that holds none: from the LRU, or with
    ``cache=False`` built afresh; a tiled plan for ``method="auto"`` (on
    the mesh, a mesh plan or a torch grid, as the cost model says)."""
    method, contract = _resolve_method_backend(method, backend)
    _check_shards(contract, shards)
    _check_auto_only(method, t, b_min, b_max, tile, candidates)
    if contract.name == "mesh":
        backends.check_method_knobs(contract, t, b_min, b_max)
        if method == "auto":
            return _auto_mesh_plan(a, b, shards, tile, candidates, cache,
                                   device)
        if cache:
            return _cached_mesh_plan(a, b, shards, None, None, device)
        return plan_spgemm(a, b, method, backend="mesh", shards=shards,
                           device=device)
    if method == "auto":
        if cache:
            return _cached_tiled_plan(a, b, contract, tile, candidates,
                                      device)
        return plan_spgemm_tiled(a, b, backend=contract.name, tile=tile,
                                 candidates=candidates, cache=False,
                                 device=device)
    if cache:
        return cached_plan(a, b, method, backend=contract.name, t=t,
                           b_min=b_min, b_max=b_max, device=device)
    return plan_spgemm(a, b, method, backend=contract.name, t=t,
                       b_min=b_min, b_max=b_max, device=device)


def _check_plan_overrides(plan, method, backend, t, b_min, b_max,
                          device, tile=None, candidates=None,
                          shards=None) -> None:
    """Reject ``plan=`` calls whose explicit arguments conflict with what
    the held plan was built with."""
    own = dict(plan.params)
    conflicts = []
    if method is not None and method != plan.method:
        conflicts.append(f"method={method!r} (plan has {plan.method!r})")
    if backend is not None and backend != plan.backend:
        conflicts.append(f"backend={backend!r} (plan has {plan.backend!r})")
    for name, given in (("t", t), ("b_min", b_min), ("b_max", b_max)):
        if given is not None and (name not in own or own[name] != given):
            conflicts.append(
                f"{name}={given!r} (plan has {own.get(name, '<unset>')})")
    if tile is not None and own.get("tile") != normalize_tile_spec(tile):
        conflicts.append(
            f"tile={tile!r} (plan has {own.get('tile', '<unset>')})")
    if candidates is not None \
            and own.get("candidates") != tuple(candidates):
        conflicts.append(
            f"candidates={tuple(candidates)!r} "
            f"(plan has {own.get('candidates', '<unset>')})")
    if device is not None and (plan.device is None or not _same_device(
            torch.device(device), plan.device)):
        conflicts.append(f"device={device!r} (plan has {plan.device})")
    if shards is not None and shards != own.get("shards"):
        conflicts.append(
            f"shards={shards!r} (plan has {own.get('shards', '<unset>')})")
    if conflicts:
        raise ValueError(
            "arguments conflict with the held plan (a plan carries its own "
            "method/backend/parameters/device): " + "; ".join(conflicts))


def _same_device(given: torch.device, held: torch.device) -> bool:
    """Whether ``given`` names ``held`` (an index on one side only, as in
    ``"cuda"`` and ``"cuda:0"``, names the same card)."""
    return given.type == held.type and (
        given.index is None or held.index is None
        or given.index == held.index)


def spgemm(
    a: CSC,
    b: CSC,
    method: str | None = None,
    *,
    backend: str | None = None,
    t: float | None = None,
    b_min: int | None = None,
    b_max: int | None = None,
    tile=None,
    candidates: tuple | None = None,
    plan=None,
    cache: bool = True,
    validate: str | None = None,
    device=None,
    engine: str | None = None,
    shards: int | None = None,
) -> CSC:
    """Compute C = A @ B with one of the paper's algorithms, or ``"auto"``.

    The default method is ``"h-hash-256/256"`` (the paper's best overall),
    the default backend ``"cuda"``.  ``t``/``b_min``/``b_max`` override the
    named method's parameters.  With ``plan`` the symbolic phase is
    skipped: the plan carries its own method, backend, parameters and
    device, and an explicit argument that conflicts with it raises.  With
    ``cache=False`` the plan is built afresh, outside the LRU.
    ``validate="fingerprint"`` re-hashes the operands' structure against
    the plan (O(nnz)) besides the O(1) shape and nnz check.

    ``engine`` picks one of the backend's engines per execution (so it
    never conflicts with ``plan=``): ``"naive"`` (cuda: the per-group
    kernels; host: the oracles) or ``"fused"`` (one K1 launch) on cuda,
    ``"stream"`` or ``"fused"`` on torch, ``"naive"`` or ``"stream"`` on
    host; ``None`` is the backend's default for the method.  The result is
    a CSC whose values lie on the plan's device.

    ``method="auto"`` plans a tile grid (``core.planner.
    plan_spgemm_tiled``): ``tile=`` sets it (``None``: sized from nnz; an
    int: the column width; a ``(k_width, n_width)`` pair), ``candidates=``
    restricts the per-tile methods (default ``core.cost.AUTO_CANDIDATES``
    of the backend), and ``t``/``b_min``/``b_max`` raise.  On
    ``backend="host"`` the grid's ``"torch"``/``"fused"`` tiles run on
    ``device`` (``None``: the card) and its numpy tiles on the CPU.

    ``backend="mesh"`` shards the multiply over ``shards`` shards (default
    one a visible card; ``device=None`` runs shard d on ``cuda:d``, a named
    device runs every shard there), the plan-memory guard applying per
    shard.  With ``method="auto"`` the cost model decides whether to shard,
    else the torch backend's tile grid runs on ``device``.
    """
    if plan is not None:
        _check_plan_overrides(plan, method, backend, t, b_min, b_max, device,
                              tile, candidates, shards)
        return plan.execute(a, b, validate=validate, engine=engine)
    p = _plan_for(a, b, method, backend, t, b_min, b_max, device, cache,
                  tile, candidates, shards)
    return p.execute(a, b, validate=validate, engine=engine)


def spgemm_batched(
    a: BatchedCSC,
    b: BatchedCSC,
    method: str | None = None,
    *,
    backend: str | None = None,
    t: float | None = None,
    b_min: int | None = None,
    b_max: int | None = None,
    tile=None,
    candidates: tuple | None = None,
    plan=None,
    cache: bool = True,
    validate: str | None = None,
    device=None,
    engine: str | None = None,
    shards: int | None = None,
) -> list:
    """B same-pattern multiplies C_b = A_b @ B_b through one plan execution.

    ``a``/``b`` are :class:`~repro_torch.sparse.format.BatchedCSC` stacks
    (one sparsity pattern each, values ``[B, nnz]``).  The plan is planned
    on element 0 as :func:`spgemm` plans, and all B value sets run through
    one execution (``plan.execute_batched``).  Returns a list of B CSC
    results, bit-identical to calling :func:`spgemm` per element.  The
    other arguments as in :func:`spgemm`.

    With ``plan`` the symbolic phase is skipped (explicit arguments that
    conflict with it raise) and ``a``/``b`` may also be raw ``[B, nnz]``
    value stacks aligned with the planned patterns.  ``method="auto"``
    rides the tiled plan's batched path: each tile's child runs batched
    once, and the merge runs per element.
    """
    if plan is not None:
        _check_plan_overrides(plan, method, backend, t, b_min, b_max, device,
                              tile, candidates, shards)
        return plan.execute_batched(a, b, validate=validate, engine=engine)
    if not isinstance(a, BatchedCSC) or not isinstance(b, BatchedCSC):
        raise TypeError(
            "spgemm_batched operands must be BatchedCSC (use BatchedCSC"
            ".stack / .from_values, or pass plan= with raw value stacks)")
    if a.batch != b.batch:
        raise ValueError(f"batch mismatch: {a.batch} vs {b.batch}")
    if a.batch < 1:
        raise ValueError("empty batch")
    p = _plan_for(a.element(0), b.element(0), method, backend, t, b_min,
                  b_max, device, cache, tile, candidates, shards)
    return p.execute_batched(a, b, validate=validate, engine=engine)
