"""Distribution layer of the port: the SpGEMM mesh (``backend="mesh"``),
the model-side sharding rules (``sharding``: partition specs, the
shardings the launch dry run sizes each device's share with), the
sharding hints the models make (``hints``), gradient compression and the
GPipe pipeline, each driven from one process.
"""

from repro_torch.distributed.sharding import (
    NamedSharding, PartitionSpec, batch_spec, cache_specs, dp_axes,
    mesh_axis_sizes, param_sharding, sharding_rules,
)
from repro_torch.distributed.compression import (
    dequantize_tree, ef_compress, psum_compressed, quantize_tree,
)
from repro_torch.distributed.pipeline import pipelined_apply, \
    pipeline_forward
from repro_torch.distributed.spgemm_mesh import (
    ShardedSpgemmPlan, ShardStream, plan_spgemm_mesh,
)

__all__ = ["NamedSharding", "PartitionSpec", "ShardedSpgemmPlan",
           "ShardStream", "batch_spec", "cache_specs", "dequantize_tree",
           "dp_axes", "ef_compress", "mesh_axis_sizes", "param_sharding",
           "pipeline_forward", "pipelined_apply", "plan_spgemm_mesh",
           "psum_compressed", "quantize_tree", "sharding_rules"]
