"""Public SpGEMM API of the port: ``spgemm(A, B, method=...)`` over cached
plans.

Methods mirror the paper's evaluated algorithms that have a kernel family;
the default is the paper's best, ``"h-hash-256/256"``.  ``spgemm`` builds —
or fetches from a bounded, thread-safe LRU keyed on pattern fingerprints
and the device — a :class:`~repro_torch.core.planner.SpgemmPlan` and
executes it against the operand values::

    plan = cached_plan(a, b)                 # symbolic phase, once
    c1 = plan.execute(a_vals_1, b_vals_1)    # numeric phase only

``spgemm_batched(A, B)`` multiplies B same-pattern value sets
(:class:`~repro_torch.sparse.format.BatchedCSC`) through one execution of
the same cached plan.

``device=None`` means the card (``"cuda"``); without one it raises.  Pass
``device="cpu"`` to run the kernels' plain versions on the host.
"""

from __future__ import annotations

import threading
from collections import OrderedDict

from repro_torch.core.planner import (
    SpgemmPlan,
    pattern_fingerprint,
    plan_spgemm,
)
from repro_torch.device import resolve_device
from repro_torch.sparse.format import CSC, BatchedCSC

DEFAULT_METHOD = "h-hash-256/256"
DEFAULT_BACKEND = "cuda"


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
                        # entries other than plans hold no stream
                        stream_bytes=sum(getattr(p, "stream_nbytes", 0)
                                         for p in plans),
                        fused_stream_bytes=sum(
                            getattr(p, "fused_stream_nbytes", 0)
                            for p in plans))

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
    ``fused_stream_bytes`` their K1 views on the device (both built at a
    plan's first fused execution; a guarded plan holds neither).
    """
    return PLAN_CACHE.info()


def plan_cache_clear() -> None:
    """Drop all cached plans and reset the counters."""
    PLAN_CACHE.clear()


def plan_cache_resize(n: int) -> dict:
    """Set the LRU capacity (evicting least-recently-used overflow);
    ``n == 0`` disables caching.  Returns :func:`plan_cache_info`."""
    return PLAN_CACHE.resize(n)


def cached_plan(a: CSC, b: CSC, method: str | None = None, *,
                backend: str | None = None, device=None) -> SpgemmPlan:
    """Fetch-or-build a plan through the shared LRU.

    The key is both operands' pattern fingerprints, the method, the backend
    and the device.  Cached plans keep the default stream guard
    (``fast.STREAM_MAX_PRODUCTS``); call :func:`plan_spgemm` with
    ``stream_limit=`` for another.
    """
    method = DEFAULT_METHOD if method is None else method
    backend = DEFAULT_BACKEND if backend is None else backend
    dev = resolve_device(device)
    key = (pattern_fingerprint(a), pattern_fingerprint(b), method, backend,
           str(dev))
    return PLAN_CACHE.get_or_build(
        key, lambda: plan_spgemm(a, b, method, backend=backend, device=dev))


def spgemm(
    a: CSC,
    b: CSC,
    method: str | None = None,
    *,
    backend: str | None = None,
    device=None,
    engine: str | None = None,
) -> CSC:
    """Compute C = A @ B with one of the paper's algorithms.

    The default method is ``"h-hash-256/256"`` (the paper's best overall).
    ``device=None`` runs on the card and raises where there is none.  The
    plan comes from the shared LRU.  ``engine="fused"`` replaces the
    method's per-group kernels by one K1 launch over the product stream.
    The result is a CSC whose values (f32), rows and col_ptr lie on the
    plan's device.
    """
    plan = cached_plan(a, b, method, backend=backend, device=device)
    return plan.execute(a, b, engine=engine)


def _check_plan_overrides(plan, method, backend, device) -> None:
    """Reject ``plan=`` calls whose explicit arguments conflict with what
    the held plan was built with."""
    conflicts = []
    if method is not None and method != plan.method:
        conflicts.append(f"method={method!r} (plan has {plan.method!r})")
    if backend is not None and backend != plan.backend:
        conflicts.append(f"backend={backend!r} (plan has {plan.backend!r})")
    if device is not None and resolve_device(device) != plan.device:
        conflicts.append(f"device={device!r} (plan has {plan.device})")
    if conflicts:
        raise ValueError(
            "arguments conflict with the held plan (a plan carries its own "
            "method/backend/device): " + "; ".join(conflicts))


def spgemm_batched(
    a: BatchedCSC,
    b: BatchedCSC,
    method: str | None = None,
    *,
    backend: str | None = None,
    device=None,
    engine: str | None = None,
    plan: SpgemmPlan | None = None,
) -> list:
    """B same-pattern multiplies C_b = A_b @ B_b through one plan execution.

    ``a``/``b`` are :class:`~repro_torch.sparse.format.BatchedCSC` stacks
    (one sparsity pattern each, values ``[B, nnz]``).  The plan comes from
    the same LRU as :func:`spgemm`, keyed on element 0, and all B value
    sets run through one set of kernel launches (``plan.execute_batched``).
    Returns a list of B CSC results, bit-identical to calling
    :func:`spgemm` per element.  ``engine`` as in :func:`spgemm`.

    With ``plan`` the symbolic phase is skipped (explicit arguments that
    conflict with it raise) and ``a``/``b`` may also be raw ``[B, nnz]``
    value stacks aligned with the planned patterns.
    """
    if plan is not None:
        _check_plan_overrides(plan, method, backend, device)
        return plan.execute_batched(a, b, engine=engine)
    if not isinstance(a, BatchedCSC) or not isinstance(b, BatchedCSC):
        raise TypeError(
            "spgemm_batched operands must be BatchedCSC (use BatchedCSC"
            ".stack / .from_values, or pass plan= with raw value stacks)")
    if a.batch != b.batch:
        raise ValueError(f"batch mismatch: {a.batch} vs {b.batch}")
    if a.batch < 1:
        raise ValueError("empty batch")
    p = cached_plan(a.element(0), b.element(0), method, backend=backend,
                    device=device)
    return p.execute_batched(a, b, engine=engine)
