"""Serving: the batched engine with continuous batching on the model
stack's caches (``models.init_cache``)."""

from repro_torch.serving.engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
