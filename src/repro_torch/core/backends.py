"""Backend/engine registry: one execution contract per backend.

The port registers one backend, ``"cuda"``: the counterpart of the JAX
package's ``"pallas"`` backend.  Its engines are ``"naive"`` (``None``
resolves to it), one hand-written kernel launch per plan
:class:`~repro_torch.core.planner.KernelGroup` (the per-group SPA, SPARS and
HASH schedule), and ``"fused"``, one launch of kernel K1 over the plan's
product stream (``core.fused_stream``).
The plan's device decides where it runs: ``"cuda"`` launches the kernels,
``"cpu"`` (tests only, asked for explicitly) runs their plain versions.

The JAX package's host-only methods (``esc``, ``expand``) have no kernel
family: the planner does not know them, so no backend here can plan them.
``core.planner`` (backend names) and ``core.executor`` (engine resolution)
consult the :class:`ExecutionContract` registered here instead of matching
backend names.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

@dataclasses.dataclass(frozen=True)
class ExecutionContract:
    """Capabilities and engine surface of one execution backend.

    ``engines`` are the accepted ``engine=`` spellings (``None`` always
    means "this backend's default").
    """

    name: str
    #: engine= spellings valid on this backend's plans (None included)
    engines: Tuple[Optional[str], ...]
    #: what engine=None resolves to
    default_engine: str


_REGISTRY: "dict[str, ExecutionContract]" = {}


def register_backend(contract: ExecutionContract) -> ExecutionContract:
    """Register (or replace) a backend contract; returns it for chaining."""
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


def check_engine(contract: ExecutionContract, engine: Optional[str]) -> None:
    """Validate an ``engine=`` spelling against one backend's contract."""
    if engine not in contract.engines:
        raise ValueError(
            f"engine={engine!r} is not available on the {contract.name!r} "
            f"backend; one of {contract.engines}")


CUDA = register_backend(ExecutionContract(
    name="cuda",
    # "naive": the per-group kernel schedule (SPA/SPARS/HASH launches);
    # "fused": one K1 launch over the plan's product stream
    engines=(None, "naive", "fused"),
    default_engine="naive",
))
