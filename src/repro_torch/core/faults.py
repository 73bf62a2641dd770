"""Deterministic fault injection for the plan-build and serving pipeline.

The port of the JAX package's ``repro/core/faults.py``, rule for rule and
seed for seed.  The resilience layer is trustworthy only if its failure
paths are exercised by *real* injected faults rather than mocks: a
``FaultPlan`` installed process-globally (test-scoped, via :func:`inject`)
makes the instrumented sites fail, hang, or delay deterministically --
seeded, by call count (``every=``) or key pattern (``match=``) -- so the
retry/backoff machinery, the builder watchdog, and the serving circuit
breaker all see the same faults on every run.  One seed fires the same
pattern here as in the JAX package (the same per-rule
``random.Random(f"{seed}:{site}:{i}")``).

Instrumented sites (each calls :func:`check` with a site name and a
cheap key):

* ``"plan_spgemm"``    -- the symbolic phase (``core.planner.plan_spgemm``);
  key is ``(backend, method)``, so ``match="torch"`` scopes faults to
  background device builds without touching the foreground host fallback.
* ``"device_lift"``    -- the lazy device-stream lift
  (``core.device_stream.device_stream``); key is the plan's backend.
* ``"warm_compile"``   -- the warms: ``plan_builder.warm_plan`` and the
  serving engine's background decode-step warm.
* ``"builder_worker"`` -- the top of every ``PlanBuilder`` worker task
  (hangs here simulate a wedged worker for the watchdog to recycle).

With no plan installed every ``check`` is one attribute read and a
``None`` test -- the hooks cost nothing in production paths.

Hangs are *bounded*: a ``"hang"`` rule waits on the plan's release event
for ``seconds`` (default 30), so an abandoned (watchdog-recycled) zombie
thread always unwedges eventually; :func:`uninstall` -- and therefore the
:func:`inject` context exit -- releases all hung sites immediately.
"""

from __future__ import annotations

import contextlib
import dataclasses
import random
import threading
import time

SITES = ("plan_spgemm", "device_lift", "warm_compile", "builder_worker")
MODES = ("fail", "hang", "delay")


class InjectedFault(RuntimeError):
    """Raised at an instrumented site by a ``mode="fail"`` rule."""


@dataclasses.dataclass
class FaultRule:
    """One fault at one site.

    Exactly how it fires:

    * ``every=N`` -- fires on every Nth *matched* call (1-based: calls
      N, 2N, ...).  Deterministic by construction.
    * ``rate=p`` -- fires with probability ``p`` per matched call, drawn
      from a per-rule RNG seeded by ``(plan seed, site, rule index)`` --
      the same seed replays the same firing pattern.
    * ``match="s"`` -- only calls whose ``str(key)`` contains ``s`` are
      matched (and counted) at all.
    * ``max_fires=K`` -- stop firing after K hits (e.g. "fail twice,
      then recover").

    ``mode``: ``"fail"`` raises :class:`InjectedFault`; ``"hang"`` blocks
    for up to ``seconds`` (released early by ``FaultPlan.release()`` /
    :func:`uninstall`); ``"delay"`` sleeps ``seconds`` then continues.
    """

    site: str
    mode: str = "fail"
    rate: float = 0.0
    every: int | None = None
    match: str | None = None
    seconds: float = 30.0
    max_fires: int | None = None
    # runtime counters, not configuration
    calls: int = 0
    fires: int = 0

    def __post_init__(self):
        if self.site not in SITES:
            raise ValueError(
                f"unknown fault site {self.site!r}; one of {SITES}")
        if self.mode not in MODES:
            raise ValueError(
                f"unknown fault mode {self.mode!r}; one of {MODES}")
        if self.every is not None and self.every < 1:
            raise ValueError(f"every= must be >= 1, got {self.every}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate= must be in [0, 1], got {self.rate}")


class FaultPlan:
    """A set of :class:`FaultRule`\\ s plus the seed that replays them."""

    def __init__(self, rules, seed: int = 0):
        self.rules = list(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._release = threading.Event()
        self._rngs = [random.Random(f"{self.seed}:{r.site}:{i}")
                      for i, r in enumerate(self.rules)]

    def check(self, site: str, key=None) -> None:
        """Evaluate every matching rule for one call at ``site``."""
        actions = []
        with self._lock:
            for rule, rng in zip(self.rules, self._rngs):
                if rule.site != site:
                    continue
                if rule.match is not None and rule.match not in str(key):
                    continue
                rule.calls += 1
                if rule.max_fires is not None and rule.fires >= rule.max_fires:
                    continue
                if rule.every is not None:
                    fire = rule.calls % rule.every == 0
                else:
                    fire = rng.random() < rule.rate
                if fire:
                    rule.fires += 1
                    actions.append(rule)
        # act outside the lock: hangs/delays must not serialize other sites
        for rule in actions:
            if rule.mode == "fail":
                raise InjectedFault(
                    f"injected failure at {site} (key={key!r})")
            if rule.mode == "hang":
                self._release.wait(timeout=rule.seconds)
            elif rule.mode == "delay":
                time.sleep(rule.seconds)

    def release(self) -> None:
        """Unblock every site currently hung by a ``"hang"`` rule."""
        self._release.set()

    def fired(self, site: str) -> int:
        """Total fires across this plan's rules for ``site``."""
        with self._lock:
            return sum(r.fires for r in self.rules if r.site == site)

    def describe(self) -> dict:
        """JSON-able config and counters, for a run's header, so no
        fault-mode result can pass as a clean baseline."""
        with self._lock:
            return {
                "seed": self.seed,
                "rules": [
                    {"site": r.site, "mode": r.mode, "rate": r.rate,
                     "every": r.every, "match": r.match,
                     "seconds": r.seconds, "max_fires": r.max_fires,
                     "calls": r.calls, "fires": r.fires}
                    for r in self.rules
                ],
            }


_ACTIVE: FaultPlan | None = None
_INSTALL_LOCK = threading.Lock()


def install(plan: FaultPlan) -> FaultPlan:
    """Install ``plan`` process-globally.  One plan at a time -- nesting
    would make "which rule fired" ambiguous, so it raises instead."""
    global _ACTIVE
    with _INSTALL_LOCK:
        if _ACTIVE is not None:
            raise RuntimeError(
                "a FaultPlan is already installed; uninstall() it first")
        _ACTIVE = plan
    return plan


def uninstall() -> None:
    """Remove the active plan (idempotent) and release hung sites."""
    global _ACTIVE
    with _INSTALL_LOCK:
        plan, _ACTIVE = _ACTIVE, None
    if plan is not None:
        plan.release()


def active() -> FaultPlan | None:
    """The installed plan, or ``None`` (a run stamps its fault config
    from this)."""
    return _ACTIVE


def check(site: str, key=None) -> None:
    """The instrumented-site hook: a no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.check(site, key)


@contextlib.contextmanager
def inject(*rules: FaultRule, seed: int = 0):
    """``with faults.inject(FaultRule(...), seed=7) as plan: ...`` --
    install for the block, always uninstall (and release hangs) after."""
    plan = install(FaultPlan(rules, seed=seed))
    try:
        yield plan
    finally:
        uninstall()
