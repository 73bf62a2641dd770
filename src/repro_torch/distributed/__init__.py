"""Distribution layer of the port: the SpGEMM mesh (``backend="mesh"``)
and the model-side sharding rules (``sharding``: partition specs, the
shardings the launch dry run sizes each device's share with).

The JAX package's ``repro/distributed`` also holds the sharding hints,
the pipeline and the compression; the port has none of them yet.
"""

from repro_torch.distributed.sharding import (
    NamedSharding, PartitionSpec, batch_spec, cache_specs, dp_axes,
    mesh_axis_sizes, param_sharding, sharding_rules,
)
from repro_torch.distributed.spgemm_mesh import (
    ShardedSpgemmPlan, ShardStream, plan_spgemm_mesh,
)

__all__ = ["NamedSharding", "PartitionSpec", "ShardedSpgemmPlan",
           "ShardStream", "batch_spec", "cache_specs", "dp_axes",
           "mesh_axis_sizes", "param_sharding", "plan_spgemm_mesh",
           "sharding_rules"]
