"""Degradation state machine for the serving plan pipeline.

The port of the JAX package's ``repro/serving/resilience.py``.  The
serving engine always has two ways to decode: the sparse device step
(fast, but needs a successful background warm -- plan build, device lift,
one replay on the card) and the host-stream fallback (slower, but needs
nothing).  This module decides *which one the engine should be trying to
use*, as a circuit breaker per (backend, engine):

``HEALTHY``
    warms are succeeding (or none attempted yet); the engine promotes to
    the device step as soon as one lands.
``DEGRADED``
    recent warm failures below the pin threshold; the engine keeps
    serving on the fallback and keeps retrying warms normally.
``FALLBACK_PINNED``
    repeated failures tripped the breaker open: the engine stops burning
    builder capacity on doomed warms and serves the fallback until a
    cooldown elapses.  Then a single **half-open probe** warm runs in the
    background; one clean probe promotes back to ``HEALTHY`` (and the
    engine to the device step), one failed probe re-pins with the cooldown
    multiplied (capped).

Transitions are invisible to callers except in latency as long as both
paths give the same tokens: on the CPU they do, and on the card the two
sums differ in order (the host stream adds left to right, the torch stream
in the card's tree order), so a greedy token near a tie could differ.
"""

from __future__ import annotations

import enum
import threading
import time


class Health(enum.Enum):
    HEALTHY = "healthy"
    DEGRADED = "degraded"
    FALLBACK_PINNED = "fallback-pinned"

    def __str__(self) -> str:     # tick_stats["health"] reads cleanly
        return self.value


class CircuitBreaker:
    """Failure-rate circuit breaker with half-open probes.

    ``degrade_after`` consecutive failures reach :attr:`Health.DEGRADED`;
    ``pin_after`` trip the breaker to :attr:`Health.FALLBACK_PINNED` for
    ``cooldown`` seconds.  While pinned, :meth:`allow_attempt` refuses
    work until the cooldown elapses, then admits exactly one probe
    (half-open): success fully resets, failure re-pins with the cooldown
    multiplied by ``cooldown_factor`` (capped at ``max_cooldown``).

    ``clock`` is injectable (default ``time.monotonic``) so tests drive
    cooldown expiry deterministically.  Thread-safe; every method may be
    called from serving ticks and builder workers concurrently.
    """

    def __init__(self, *, degrade_after: int = 1, pin_after: int = 3,
                 cooldown: float = 1.0, cooldown_factor: float = 2.0,
                 max_cooldown: float = 30.0, clock=time.monotonic):
        if pin_after < degrade_after:
            raise ValueError(
                f"pin_after ({pin_after}) must be >= degrade_after "
                f"({degrade_after})")
        self.degrade_after = degrade_after
        self.pin_after = pin_after
        self.base_cooldown = cooldown
        self.cooldown_factor = cooldown_factor
        self.max_cooldown = max_cooldown
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._successes = 0
        self._trips = 0
        self._probes = 0
        self._half_open = False
        self._opened_at: float | None = None
        self._cooldown = cooldown

    @property
    def health(self) -> Health:
        with self._lock:
            return self._health_locked()

    def _health_locked(self) -> Health:
        if self._opened_at is not None:
            return Health.FALLBACK_PINNED
        if self._failures >= self.degrade_after:
            return Health.DEGRADED
        return Health.HEALTHY

    def allow_attempt(self) -> bool:
        """May the engine start (or keep scheduling) a warm right now?

        True while not pinned.  Pinned: False during the cooldown and
        while a probe is outstanding; True exactly once per elapsed
        cooldown -- that call *is* the half-open probe, and its outcome
        must be reported via :meth:`record_success` /
        :meth:`record_failure` (or :meth:`probe_cancelled` if it never
        ran, e.g. shed by builder backpressure).
        """
        with self._lock:
            if self._opened_at is None:
                return True
            if self._half_open:
                return False
            if self._clock() - self._opened_at < self._cooldown:
                return False
            self._half_open = True
            self._probes += 1
            return True

    def record_failure(self) -> Health:
        with self._lock:
            self._failures += 1
            if self._half_open:
                # failed probe: re-pin, back off harder
                self._half_open = False
                self._opened_at = self._clock()
                self._cooldown = min(self._cooldown * self.cooldown_factor,
                                     self.max_cooldown)
                self._trips += 1
            elif self._opened_at is None \
                    and self._failures >= self.pin_after:
                self._opened_at = self._clock()
                self._trips += 1
            return self._health_locked()

    def record_success(self) -> Health:
        """One clean warm (including a clean half-open probe): full reset."""
        with self._lock:
            self._successes += 1
            self._failures = 0
            self._half_open = False
            self._opened_at = None
            self._cooldown = self.base_cooldown
            return self._health_locked()

    def probe_cancelled(self) -> None:
        """The admitted half-open probe never ran (shed / engine closed):
        re-arm so the next :meth:`allow_attempt` can probe again."""
        with self._lock:
            self._half_open = False

    def info(self) -> dict:
        with self._lock:
            return {"health": str(self._health_locked()),
                    "failures": self._failures,
                    "successes": self._successes,
                    "trips": self._trips,
                    "probes": self._probes,
                    "half_open": self._half_open,
                    "cooldown": self._cooldown}


_REGISTRY: dict = {}
_REGISTRY_LOCK = threading.Lock()


def breaker_for(backend: str, engine, **cfg) -> CircuitBreaker:
    """The process-wide breaker for one (backend, engine) pair.

    Engines that share a backend still degrade independently -- a wedged
    warm on one overlay must not pin its neighbours.  ``cfg`` applies
    only on first creation; the registry is keyed by ``id(engine)`` and
    cleared by :func:`reset_breakers` (tests).
    """
    key = (backend, id(engine))
    with _REGISTRY_LOCK:
        br = _REGISTRY.get(key)
        if br is None:
            br = _REGISTRY[key] = CircuitBreaker(**cfg)
        return br


def reset_breakers() -> None:
    with _REGISTRY_LOCK:
        _REGISTRY.clear()
