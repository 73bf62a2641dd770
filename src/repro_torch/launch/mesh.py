"""Production meshes: the JAX package's ``repro/launch/mesh.py``.

Single pod: (data=16, model=16) = 256 devices.
Multi-pod:  (pod=2, data=16, model=16) = 512 devices; 'pod' is DP.

The port's mesh is a description: axis names, a shape and the devices it
maps to.  It never starts ``torch.distributed``.  The production mesh
holds no devices: the dry run sizes each device's share of a 256- or
512-card deployment from shapes alone, as the reference's 512 forced host
devices let XLA size it.  The host mesh is (1, 1) over one device, the
card unless the caller names another, and on it every share is the whole
tensor.

``with mesh:`` makes a mesh the active one of its thread, as the
reference's ``with mesh:`` does for ``with_sharding_constraint``: the
sharding hints (``distributed/hints.py``) read it through
:func:`current_mesh` and record on the context what the reference's
constraints would ask of the partitioner (:attr:`MeshContext.hints`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import threading
from typing import Optional

from repro_torch.device import resolve_device


@dataclasses.dataclass
class MeshContext:
    """One ``with mesh:`` (or one pipeline stage, ``manual``) on a thread's
    stack of active meshes."""
    mesh: Optional["Mesh"]
    #: ``(site, shape, spec)`` of each hint made under this context
    hints: list
    #: inside a pipeline stage: the stage owns its layout, hints record
    #: nothing (the reference's manual axes under ``shard_map``)
    manual: bool
    outer: Optional["MeshContext"]


class _Active(threading.local):
    top: Optional[MeshContext] = None


_ACTIVE = _Active()


def active_context() -> Optional[MeshContext]:
    """The innermost active context of this thread, or None: one
    thread-local read."""
    return _ACTIVE.top


def current_mesh():
    """The innermost active mesh of this thread, or None."""
    top = _ACTIVE.top
    return None if top is None else top.mesh


def _push(mesh, manual: bool) -> MeshContext:
    ctx = MeshContext(mesh, [], manual, _ACTIVE.top)
    _ACTIVE.top = ctx
    return ctx


@contextlib.contextmanager
def pipeline_stage():
    """A pipeline stage's scope: the active mesh stays current, and hints
    inside it record nothing."""
    ctx = _push(current_mesh(), True)
    try:
        yield ctx
    finally:
        _ACTIVE.top = ctx.outer


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    #: one device a mesh position, row-major, or one device that holds
    #: every position; None for a mesh that is sized and never run (the
    #: production mesh)
    devices: Optional[tuple] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def __enter__(self) -> MeshContext:
        """Make this mesh the active one; the context records the hints
        made under it."""
        return _push(self, False)

    def __exit__(self, *exc) -> None:
        _ACTIVE.top = _ACTIVE.top.outer


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """1-device mesh with the production axis names over ``device`` (the
    card by default; ``"cpu"`` or ``"meta"`` when asked)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
