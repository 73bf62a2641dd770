"""Serving: the batched engine with continuous batching on the model
stack's caches (``models.init_cache``), its background warm on a plan
builder, and the circuit breaker that governs the warms."""

from repro_torch.serving.engine import Request, ServeEngine
from repro_torch.serving.resilience import (
    CircuitBreaker,
    Health,
    breaker_for,
    reset_breakers,
)

__all__ = ["Request", "ServeEngine", "CircuitBreaker", "Health",
           "breaker_for", "reset_breakers"]
