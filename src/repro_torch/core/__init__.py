"""SpGEMM core of the PyTorch port: host analysis, plans, execution, API.

``spgemm(a, b)`` plans the product once per sparsity pattern (cached) and
runs the plan's per-group SPA / SPARS / HASH kernels on the card;
``engine="fused"`` runs the plan's product stream through one K1 launch
instead.  ``backend="torch"`` runs the stream in PyTorch ops (the
counterpart of the JAX package's ``"jax"`` backend) and ``backend="host"``
the numpy oracles and stream (its ``"host"`` backend).
``plan.stream_apply(...)`` is the differentiable form of either stream
engine, on value vectors or ``[B, nnz]`` stacks.  ``spgemm_batched(a, b)``
/ ``plan.execute_batched`` run B same-pattern value sets through one
execution (the batched kernels K1-b … K4-b on the card).
``spgemm(a, b, method="auto")`` / ``plan_spgemm_tiled`` cut the product into
a 2-D tile grid whose tiles each run the method the cost model
(``core.cost``) picks, merged in a fixed order; the model ranks on the
machine profile (``core.profile``), measured on this machine by
``calibrate_profile`` or else the defaults.  ``backend="mesh"``
(``repro_torch.distributed``) shards the torch stream over D shards, the
plan-memory guard applying per shard.

The plan LRU builds each key once across threads (single-flight), and
``PlanBuilder`` builds and warms plans on background threads under retry,
a watchdog and backpressure; ``core.faults`` injects deterministic
failures, hangs and delays at the pipeline's sites.
"""

from repro_torch.core.analysis import (
    HASH_C,
    BlockSchedule,
    Preprocess,
    blocking_schedule,
    hash_table_size,
    hybrid_split,
    preprocess,
    sort_columns,
)
from repro_torch.core.api import (
    DEFAULT_METHOD,
    PlanBuildTimeout,
    PlanCache,
    cached_plan,
    plan_cache_clear,
    plan_cache_info,
    plan_cache_key,
    plan_cache_peek,
    plan_cache_resize,
    register_eviction_listener,
    spgemm,
    spgemm_batched,
    unregister_eviction_listener,
)
from repro_torch.core.backends import ExecutionContract, backend_names, \
    get_backend
from repro_torch.core.cost import AUTO_CANDIDATES, DEFAULT_CONSTANTS, \
    CostConstants, choose_method, estimate_cost, estimate_mesh_cost, \
    should_distribute
from repro_torch.core.device_stream import DeviceStream, device_stream, \
    execute_torch, execute_torch_batched, stream_fn, stream_fn_batched
from repro_torch.core.faults import FaultPlan, FaultRule, InjectedFault
from repro_torch.core.executor import execute, execute_batched, \
    execute_tiled, execute_tiled_batched, register_executor, resolve_engine
from repro_torch.core.fused_stream import FusedStream, execute_fused_batched, \
    fused_fn, fused_stream
from repro_torch.core.plan_builder import (
    BuildCancelled,
    BuildResult,
    BuildShed,
    BuildTimeoutError,
    PlanBuilder,
    RetryPolicy,
    warm_plan,
)
from repro_torch.core.profile import (
    MachineProfile,
    calibrate_profile,
    current_profile,
    fingerprint_key,
    load_profile,
    machine_fingerprint,
    rank_correlation,
    save_profile,
)
from repro_torch.core.reference import dense_product, spgemm_dense
from repro_torch.core.planner import (
    ALGORITHMS,
    KernelGroup,
    KernelLayout,
    Pattern,
    SpgemmPlan,
    TiledSpgemmPlan,
    TilePlan,
    normalize_tile_spec,
    pattern_fingerprint,
    plan_spgemm,
    plan_spgemm_tiled,
    resolve_params,
)

__all__ = [
    "HASH_C",
    "BlockSchedule",
    "Preprocess",
    "blocking_schedule",
    "hash_table_size",
    "hybrid_split",
    "preprocess",
    "sort_columns",
    "DEFAULT_METHOD",
    "PlanBuildTimeout",
    "PlanCache",
    "cached_plan",
    "plan_cache_clear",
    "plan_cache_info",
    "plan_cache_key",
    "plan_cache_peek",
    "plan_cache_resize",
    "register_eviction_listener",
    "unregister_eviction_listener",
    "spgemm",
    "spgemm_batched",
    "FaultPlan",
    "FaultRule",
    "InjectedFault",
    "BuildCancelled",
    "BuildResult",
    "BuildShed",
    "BuildTimeoutError",
    "PlanBuilder",
    "RetryPolicy",
    "warm_plan",
    "ExecutionContract",
    "backend_names",
    "get_backend",
    "AUTO_CANDIDATES",
    "DEFAULT_CONSTANTS",
    "CostConstants",
    "choose_method",
    "estimate_cost",
    "estimate_mesh_cost",
    "should_distribute",
    "DeviceStream",
    "device_stream",
    "execute_torch",
    "execute_torch_batched",
    "stream_fn",
    "stream_fn_batched",
    "execute",
    "execute_batched",
    "execute_tiled",
    "execute_tiled_batched",
    "register_executor",
    "resolve_engine",
    "FusedStream",
    "execute_fused_batched",
    "fused_fn",
    "fused_stream",
    "MachineProfile",
    "calibrate_profile",
    "current_profile",
    "fingerprint_key",
    "load_profile",
    "machine_fingerprint",
    "rank_correlation",
    "save_profile",
    "dense_product",
    "spgemm_dense",
    "ALGORITHMS",
    "KernelGroup",
    "KernelLayout",
    "Pattern",
    "SpgemmPlan",
    "TiledSpgemmPlan",
    "TilePlan",
    "normalize_tile_spec",
    "pattern_fingerprint",
    "plan_spgemm",
    "plan_spgemm_tiled",
    "resolve_params",
]
