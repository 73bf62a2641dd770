"""SpGEMM core of the PyTorch port: host analysis, plans, execution, API.

``spgemm(a, b)`` plans the product once per sparsity pattern (cached) and
runs the plan's per-group SPA / SPARS / HASH kernels on the card;
``engine="fused"`` runs the plan's product stream through one K1 launch
instead, and ``plan.stream_apply(..., engine="fused")`` is its
differentiable form.
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
    PlanCache,
    cached_plan,
    plan_cache_clear,
    plan_cache_info,
    plan_cache_resize,
    spgemm,
)
from repro_torch.core.backends import ExecutionContract, get_backend
from repro_torch.core.executor import execute, resolve_engine
from repro_torch.core.fused_stream import FusedStream, fused_fn, fused_stream
from repro_torch.core.planner import (
    ALGORITHMS,
    KernelGroup,
    KernelLayout,
    Pattern,
    SpgemmPlan,
    pattern_fingerprint,
    plan_spgemm,
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
    "PlanCache",
    "cached_plan",
    "plan_cache_clear",
    "plan_cache_info",
    "plan_cache_resize",
    "spgemm",
    "ExecutionContract",
    "get_backend",
    "execute",
    "resolve_engine",
    "FusedStream",
    "fused_fn",
    "fused_stream",
    "ALGORITHMS",
    "KernelGroup",
    "KernelLayout",
    "Pattern",
    "SpgemmPlan",
    "pattern_fingerprint",
    "plan_spgemm",
    "resolve_params",
]
