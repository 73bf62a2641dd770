"""Backend/engine registry: one execution contract per backend.

The port registers four backends, the counterparts of the JAX package's
four:

* ``"host"`` (the reference's ``"host"``): the faithful numpy oracles of the
  paper's algorithms (``engine="naive"``, ``core.naive``) and the numpy
  product stream (``engine="stream"``, ``core.fast``).  It runs on the CPU
  because the caller named it; its results equal the reference's host
  backend bit for bit, each column's rows in discovery order.
* ``"cuda"`` (the reference's ``"pallas"``): ``"naive"`` (``None`` resolves
  to it) launches one hand-written kernel per plan
  :class:`~repro_torch.core.planner.KernelGroup` (the per-group SPA, SPARS
  and HASH schedule); ``"fused"`` is one launch of kernel K1 over the plan's
  product stream (``core.fused_stream``).  It has no kernel family for the
  host-only methods ``esc`` and ``expand``.
* ``"torch"`` (the reference's ``"jax"``): the product stream lowered
  through PyTorch's own ops, gather, multiply and an ordered segmented sum
  (``core.device_stream``): differentiable and batched.  Its numeric phase
  does not depend on the method, so every method spelling collapses to one
  canonical plan (``"expand"``); ``"fused"`` swaps the lowering for K1.
* ``"mesh"`` (the reference's ``"mesh"``): the torch stream sharded over
  D shards (``distributed.spgemm_mesh``), each shard replaying its slice
  of the products on its own device, the partial results reduced in shard
  order.  The contract mirrors ``"torch"`` (canonical ``"expand"``,
  differentiable), with the plan-memory guard applied per shard.

The plan's device decides where ``"cuda"`` and ``"torch"`` run: ``"cuda"``
launches the kernels, ``"cpu"`` (tests only, asked for explicitly) runs
their plain versions.  ``core.api`` (argument checks), ``core.planner``
(method admission, canonical collapse) and ``core.executor`` (engine
resolution) consult the :class:`ExecutionContract` registered here instead
of matching backend names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

#: the methods with no kernel family (host-only executors): a capability of
#: the cuda contract
HOST_ONLY_METHODS = ("esc", "expand")


@dataclasses.dataclass(frozen=True)
class ExecutionContract:
    """Capabilities and engine surface of one execution backend.

    ``engines`` are the accepted ``engine=`` spellings (``None`` always
    means "this backend's default for the plan's method"); the flags are
    what callers branch on instead of comparing backend names.
    """

    name: str
    #: engine= spellings valid on this backend's plans (None included)
    engines: Tuple[Optional[str], ...]
    #: what engine=None resolves to; ``stream_default_methods`` lists the
    #: methods whose default is "stream" instead (host: expand, whose naive
    #: executor computes the same contraction, slower)
    default_engine: str
    stream_default_methods: Tuple[str, ...] = ()
    #: methods this backend cannot plan (cuda: the host-only executors)
    excluded_methods: Tuple[str, ...] = ()
    #: plan.stream_apply results carry torch.autograd gradients
    supports_grad: bool = False
    #: the per-method naive oracle executors are reachable (engine="naive")
    bit_exact_oracle: bool = False
    #: the numeric phase runs on the plan's device (card or, asked for, CPU)
    device_resident: bool = False
    #: plans carry a product stream (and obey the plan-memory guard)
    carries_stream: bool = False
    #: unit of the backend's cost-model estimates (``core.cost``):
    #: "seconds" (wall time, comparable across the seconds-domain backends
    #: in a mixed tile grid) or "relative" (kernel work units)
    cost_domain: str = "seconds"
    #: when set, every plannable method collapses to this one (torch: the
    #: numeric phase is the method-independent stream contraction, so
    #: method spellings share one plan and one stream in the LRU)
    canonical_method: Optional[str] = None


_REGISTRY: "dict[str, ExecutionContract]" = {}


def register_backend(contract: ExecutionContract) -> ExecutionContract:
    """Register (or replace) a backend contract; returns it for chaining.

    A contract alone is not a working backend: it also needs an executor
    pair per engine (``core.executor.register_executor``).
    """
    _REGISTRY[contract.name] = contract
    return contract


def get_backend(name: str) -> ExecutionContract:
    """The contract of ``name``; raises the canonical unknown-backend error."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown backend {name!r}; one of {backend_names()}") from None


def backend_names() -> list:
    """Registered backend names, registration order."""
    return list(_REGISTRY)


def engine_spellings() -> tuple:
    """Union of every backend's accepted ``engine=`` spellings."""
    seen: list = []
    for c in _REGISTRY.values():
        for e in c.engines:
            if e not in seen:
                seen.append(e)
    return tuple(seen)


def default_engine(contract: ExecutionContract, method: str) -> str:
    """The engine ``engine=None`` resolves to for ``method`` on ``contract``."""
    if method in contract.stream_default_methods:
        return "stream"
    return contract.default_engine


def check_engine(contract: ExecutionContract, engine: Optional[str]) -> None:
    """Validate an ``engine=`` spelling against one backend's contract.

    Unknown spellings raise naming the full spelling union; known spellings
    the backend does not implement raise a capability error naming the
    backends that do (the product stream is a host and torch engine, and
    the torch backend has no naive oracles).
    """
    if engine in contract.engines:
        return
    spellings = engine_spellings()
    if engine not in spellings:
        raise ValueError(
            f"unknown engine {engine!r}; one of "
            f"{', '.join(repr(e) for e in spellings)}")
    supported = sorted(
        c.name for c in _REGISTRY.values() if engine in c.engines)
    raise ValueError(
        f"engine={engine!r} is not available on the {contract.name!r} "
        f"backend; a {engine!r} execution needs a "
        f"{'-backend or '.join(supported)}-backend plan")


def check_method_knobs(contract: ExecutionContract, t, b_min, b_max) -> None:
    """Reject explicit t/b_min/b_max on a canonical-method backend (torch):
    they tune executors that never run there, and an explicit argument is
    rejected rather than dropped."""
    if contract.canonical_method and (
            t is not None or b_min is not None or b_max is not None):
        raise ValueError(
            f"t/b_min/b_max do not apply to backend={contract.name!r} "
            "(its numeric phase is the method-independent stream "
            "contraction)")


HOST = register_backend(ExecutionContract(
    name="host",
    engines=(None, "naive", "stream"),
    default_engine="naive",
    stream_default_methods=("expand",),
    bit_exact_oracle=True,
    carries_stream=True,
))

CUDA = register_backend(ExecutionContract(
    name="cuda",
    # "naive": the per-group kernel schedule (SPA/SPARS/HASH launches);
    # "fused": one K1 launch over the plan's product stream
    engines=(None, "naive", "fused"),
    default_engine="naive",
    # the host-only executors have no kernel family, and the "torch" auto
    # candidate (the torch stream riding a tile grid) has no kernel lane
    excluded_methods=HOST_ONLY_METHODS + ("torch",),
    device_resident=True,
    carries_stream=True,
    cost_domain="relative",
))

TORCH = register_backend(ExecutionContract(
    name="torch",
    # the stream in PyTorch ops, and its K1 lowering on the same plan
    engines=(None, "stream", "fused"),
    default_engine="stream",
    supports_grad=True,
    device_resident=True,
    carries_stream=True,
    canonical_method="expand",   # the stream computes expand's contraction
))

MESH = register_backend(ExecutionContract(
    name="mesh",
    # one engine: every shard replays its slice of the sharded stream, the
    # partials reduced in a plan-static order; the per-shard replay is the
    # torch stream's, so the contract mirrors torch's
    engines=(None, "stream"),
    default_engine="stream",
    supports_grad=True,
    device_resident=True,
    carries_stream=True,
    canonical_method="expand",
))
