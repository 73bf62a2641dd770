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
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class Mesh:
    axis_names: tuple
    shape: tuple
    #: one device a mesh position, row-major; None for a mesh that is
    #: sized and never run (the production mesh)
    devices: Optional[tuple] = None

    @property
    def size(self) -> int:
        return math.prod(self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    if multi_pod:
        return Mesh(("pod", "data", "model"), (2, 16, 16))
    return Mesh(("data", "model"), (16, 16))


def make_host_mesh(device=None) -> Mesh:
    """1-device mesh with the production axis names over ``device`` (the
    card by default; ``"cpu"`` or ``"meta"`` when asked)."""
    return Mesh(("data", "model"), (1, 1), (resolve_device(device),))
