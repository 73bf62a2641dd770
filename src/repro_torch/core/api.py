"""Public SpGEMM API of the port: ``spgemm(A, B, method=...)`` over cached
plans.

Methods mirror the paper's evaluated algorithms (and the host-only ``esc``
and ``expand``); the default is the paper's best, ``"h-hash-256/256"``.
``spgemm`` builds — or fetches from a bounded, thread-safe LRU keyed on
pattern fingerprints, the method, its resolved parameters, the backend, the
stream guard and the device — a
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

``device=None`` means the card (``"cuda"``) on the device backends, and
raises without one; pass ``device="cpu"`` to run the kernels' plain
versions and the torch stream on the host.  The host backend runs on the
CPU, and asking it for another device raises.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

import torch

from repro_torch.core import backends, fast
from repro_torch.core.cost import check_candidates
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
from repro_torch.sparse.format import CSC, BatchedCSC

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


class PlanCache:
    """Bounded LRU of plans with hit/miss/eviction counters.

    Every read or write of the entries and counters holds the lock.  The
    symbolic build itself runs outside it, so two threads that miss on one
    key at once may both build; the second insert replaces the first.
    """

    def __init__(self, max_size: int = 64):
        self.max_size = int(max_size)
        self._lock = threading.Lock()
        self._plans: "OrderedDict[tuple, SpgemmPlan]" = OrderedDict()
        self._stats = {"hits": 0, "misses": 0, "evictions": 0}

    def get_or_build(self, key, build) -> SpgemmPlan:
        with self._lock:
            plan = self._plans.get(key)
            if plan is not None:
                self._plans.move_to_end(key)
                self._stats["hits"] += 1
                return plan
            self._stats["misses"] += 1
        plan = build()
        with self._lock:
            self._plans[key] = plan
            self._plans.move_to_end(key)
            self._evict_locked()
        return plan

    def _evict_locked(self) -> None:
        while len(self._plans) > self.max_size:
            self._plans.popitem(last=False)
            self._stats["evictions"] += 1

    def info(self) -> dict:
        with self._lock:
            lookups = self._stats["hits"] + self._stats["misses"]
            plans = list(self._plans.values())
            return dict(self._stats, size=len(self._plans),
                        max_size=self.max_size,
                        hit_rate=(self._stats["hits"] / lookups
                                  if lookups else 0.0),
                        stream_bytes=_held(plans, "stream_nbytes"),
                        device_stream_bytes=_held(plans,
                                                  "device_stream_nbytes"),
                        fused_stream_bytes=_held(plans,
                                                 "fused_stream_nbytes"))

    def clear(self) -> None:
        with self._lock:
            self._plans.clear()
            for k in self._stats:
                self._stats[k] = 0

    def resize(self, n: int) -> dict:
        n = int(n)
        if n < 0:
            raise ValueError(f"cache size must be >= 0, got {n}")
        with self._lock:
            self.max_size = n
            self._evict_locked()
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
    holds none.  A tiled plan's streams are its children's, counted once
    however many tiles or cache entries share a child.
    """
    return PLAN_CACHE.info()


def plan_cache_clear() -> None:
    """Drop all cached plans and reset the counters."""
    PLAN_CACHE.clear()


def plan_cache_resize(n: int) -> dict:
    """Set the LRU capacity (evicting least-recently-used overflow);
    ``n == 0`` disables caching.  Returns :func:`plan_cache_info`."""
    return PLAN_CACHE.resize(n)


def _resolve_method_backend(method, backend):
    method = DEFAULT_METHOD if method is None else method
    backend = DEFAULT_BACKEND if backend is None else backend
    if method != "auto" and method not in ALGORITHMS:
        raise ValueError(
            f"unknown method {method!r}; one of {list(ALGORITHMS)} or "
            "'auto'")
    return method, backends.get_backend(backend)


def _plan_key(a: CSC, b: CSC, method: str, contract, params: dict,
              dev) -> tuple:
    """The LRU key: both patterns, the method and its resolved parameters
    (the canonical method and its defaults on a canonical-method backend,
    so every spelling shares one entry), the backend, the stream guard in
    force at build time and the device."""
    if contract.canonical_method:
        method = contract.canonical_method
        params = resolve_params(method)
    return (pattern_fingerprint(a), pattern_fingerprint(b), method,
            contract.name, tuple(sorted(params.items())),
            fast.STREAM_MAX_PRODUCTS, str(dev))


def cached_plan(a: CSC, b: CSC, method: str | None = None, *,
                backend: str | None = None, t: float | None = None,
                b_min: int | None = None, b_max: int | None = None,
                device=None) -> SpgemmPlan:
    """Fetch-or-build a plan through the shared LRU.

    Arguments as in :func:`spgemm`.  Cached plans keep the stream guard in
    force when they were built (``fast.STREAM_MAX_PRODUCTS``, part of the
    key); call :func:`plan_spgemm` with ``stream_limit=`` for another.
    """
    method, contract = _resolve_method_backend(method, backend)
    if method == "auto":
        raise ValueError(
            "cached_plan builds single-method plans; use plan_spgemm_tiled "
            "for method='auto'")
    backends.check_method_knobs(contract, t, b_min, b_max)
    params = resolve_params(method, t=t, b_min=b_min, b_max=b_max)
    dev = plan_device(contract, device)
    return PLAN_CACHE.get_or_build(
        _plan_key(a, b, method, contract, params, dev),
        lambda: plan_spgemm(a, b, method, backend=contract.name, t=t,
                            b_min=b_min, b_max=b_max, device=dev))


def _cached_tiled_plan(a: CSC, b: CSC, contract, tile, candidates,
                       device) -> TiledSpgemmPlan:
    """Fetch-or-build a tiled plan through the LRU.  The default candidate
    set is resolved before keying, so an explicit ``candidates=`` equal to
    the backend's default hits the same entry."""
    spec = normalize_tile_spec(tile)
    cands = check_candidates(contract, candidates)
    key = tiled_plan_key(pattern_fingerprint(a), pattern_fingerprint(b),
                         contract.name, spec, cands, "default",
                         fast.STREAM_MAX_PRODUCTS,
                         tiled_device(contract, device))
    return PLAN_CACHE.get_or_build(
        key, lambda: plan_spgemm_tiled(a, b, backend=contract.name,
                                       tile=tile, candidates=cands,
                                       device=device))


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
              tile=None, candidates=None):
    """The plan of a call that holds none: from the LRU, or with
    ``cache=False`` built afresh; a tiled plan for ``method="auto"``."""
    method, contract = _resolve_method_backend(method, backend)
    _check_auto_only(method, t, b_min, b_max, tile, candidates)
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
                          device, tile=None, candidates=None) -> None:
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
    if device is not None and not _same_device(torch.device(device),
                                               plan.device):
        conflicts.append(f"device={device!r} (plan has {plan.device})")
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
    """
    if plan is not None:
        _check_plan_overrides(plan, method, backend, t, b_min, b_max, device,
                              tile, candidates)
        return plan.execute(a, b, validate=validate, engine=engine)
    p = _plan_for(a, b, method, backend, t, b_min, b_max, device, cache,
                  tile, candidates)
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
                              tile, candidates)
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
                  b_max, device, cache, tile, candidates)
    return p.execute_batched(a, b, validate=validate, engine=engine)
