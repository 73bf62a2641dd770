"""Distribution layer of the port: the SpGEMM mesh (``backend="mesh"``).

The JAX package's ``repro/distributed`` also holds the model-side sharding
rules, hints, pipeline and compression; the port has none of them yet.
"""

from repro_torch.distributed.spgemm_mesh import (
    ShardedSpgemmPlan, ShardStream, plan_spgemm_mesh,
)

__all__ = ["ShardedSpgemmPlan", "ShardStream", "plan_spgemm_mesh"]
