"""Numeric SpGEMM execution of a cached symbolic plan.

``execute(plan, a_values, b_values)`` runs only the value-dependent work of
C = A @ B; every pattern-dependent decision (sorting, blocking, hash sizing,
padded layouts, kernel groups) was made once by
``core.planner.plan_spgemm``.

:func:`resolve_engine` checks the caller's ``engine=`` against the plan's
:class:`~repro_torch.core.backends.ExecutionContract`.  The default engine,
``"naive"`` on the ``"cuda"`` backend, is the counterpart of the JAX
package's ``_execute_pallas``: gather each group's padded values with the
plan's resident index tensors, launch one kernel per group, and compact
each group's output into CSC on the plan's device.  The host waits for the
card once per execution, to read the result's nnz.  ``"fused"`` runs
``core.fused_stream.execute_fused``: one K1 launch, and no host wait, since
the stream fixes the result's nnz at plan time.

:func:`execute_batched` runs B same-pattern value sets through one
execution: every group launches once for all B (the batched kernels K2-b …
K4-b) and one host wait reads all B nnz; under ``"fused"`` one K1-b launch
and no wait.  Launch counts do not depend on B, and each result is
bit-identical to a looped :func:`execute`.
"""

from __future__ import annotations

import torch

from repro_torch.core.backends import check_engine, get_backend
from repro_torch.core.planner import BLOCK_COLS, SpgemmPlan
from repro_torch.sparse.format import CSC, BatchedCSCBuilder, CSCBuilder, \
    as_tensor, padded_values, padded_values_batched


def resolve_engine(plan, engine: str | None) -> str:
    """The engine an execution will run: explicit choice or the default."""
    contract = get_backend(plan.backend)
    check_engine(contract, engine)
    return contract.default_engine if engine is None else engine


def execute(plan: SpgemmPlan, a_values, b_values, *,
            stats: dict | None = None, engine: str | None = None) -> CSC:
    """C = A @ B for new numeric values on the plan's sparsity patterns.

    ``a_values``/``b_values``: CSC matrices or raw nnz-length value vectors
    (torch tensors or numpy arrays), on any device: they are moved to the
    plan's device once.  Shapes and nnz are checked against the planned
    patterns (O(1)).  ``stats``, if given, is filled with the engine, the
    launch count and the engine's own figures (tile shapes; or the stream's
    products and whether the plan keeps it).
    """
    if resolve_engine(plan, engine) == "fused":
        from repro_torch.core.fused_stream import execute_fused

        return execute_fused(plan, a_values, b_values, stats=stats)
    return _execute_groups(plan, a_values, b_values, stats=stats)


def execute_batched(plan: SpgemmPlan, a_values, b_values, *,
                    stats: dict | None = None,
                    engine: str | None = None) -> list:
    """B same-pattern multiplies through one execution of the plan.

    ``a_values``/``b_values``: :class:`~repro_torch.sparse.format.BatchedCSC`
    operands or raw ``[B, nnz]`` value stacks (row b = value set b, aligned
    with the planned pattern), on any device.  Returns a list of B CSC
    results, bit-identical to ``[execute(plan, a_b, b_b) ...]``.  ``stats``
    as in :func:`execute`, plus ``batch``.
    """
    if resolve_engine(plan, engine) == "fused":
        from repro_torch.core.fused_stream import execute_fused_batched

        return execute_fused_batched(plan, a_values, b_values, stats=stats)
    return _execute_groups_batched(plan, a_values, b_values, stats=stats)


def _check_batch(av, bv) -> int:
    if av.shape[0] != bv.shape[0]:
        raise ValueError(
            f"batch mismatch: A has {av.shape[0]} value sets, "
            f"B has {bv.shape[0]}")
    batch = int(av.shape[0])
    if batch == 0:
        raise ValueError("empty batch")
    return batch


def _values(x, device) -> torch.Tensor:
    """The operand's value vector as f32 on ``device`` (cast before the
    gather: the cast is elementwise, so it equals the reference's cast of
    the gathered values)."""
    v = x.values if isinstance(x, CSC) else x
    return as_tensor(v).to(device=device, dtype=torch.float32)


def _execute_groups(plan: SpgemmPlan, a_values, b_values, *,
                    stats: dict | None = None) -> CSC:
    plan.a.check_compatible(a_values)
    plan.b.check_compatible(b_values)
    dev = plan.device
    return _run_groups(plan, _values(a_values, dev)[: plan.a.nnz],
                       _values(b_values, dev)[: plan.b.nnz],
                       CSCBuilder(plan.shape, plan.layout.c_slots),
                       batched=False, stats=stats)


def _execute_groups_batched(plan: SpgemmPlan, a_values, b_values, *,
                            stats: dict | None = None) -> list:
    av = plan.a.batched_values(a_values)
    bv = plan.b.batched_values(b_values)
    batch = _check_batch(av, bv)
    dev = plan.device
    out = _run_groups(plan, av.to(device=dev, dtype=torch.float32),
                      bv.to(device=dev, dtype=torch.float32),
                      BatchedCSCBuilder(batch, plan.shape,
                                        plan.layout.c_slots),
                      batched=True, stats=stats)
    if stats is not None:
        stats["batch"] = batch
    return out


def _run_groups(plan: SpgemmPlan, av, bv, builder, *, batched: bool,
                stats: dict | None):
    """Gather, launch and compact every group of the plan: one kernel
    launch per group, for one value set (``av``/``bv`` f32 ``[nnz]``) or
    for B (``[B, nnz]``, the batched kernels)."""
    from repro_torch.kernels import ops as kops  # kernels import core

    lay = plan.layout
    m = plan.shape[0]
    pad = padded_values_batched if batched else padded_values
    run = {"spa": kops.run_spa_batched if batched else kops.run_spa,
           "spars": kops.run_spars_batched if batched else kops.run_spars,
           "hash": kops.run_hash_batched if batched else kops.run_hash}
    a_arrs = (lay.a_rows, pad(av, lay.a_gather, lay.a_mask), lay.a_nnz)
    for g in lay.groups:
        out = run[g.kind](g, a_arrs, pad(bv, g.b_vgather, g.b_vmask), m=m,
                          block_cols=BLOCK_COLS)
        if g.kind == "hash":
            builder.add_hash_tables(g.cols_t, *out)
        else:
            builder.add_dense_tile(g.cols_t, out)
    c = builder.build()
    if stats is not None:
        stats["engine"] = "naive"
        stats["tile_shapes"] = list(builder.tile_shapes)
        stats["peak_tile_elems"] = builder.peak_tile_elems
        stats["n_launches"] = len(lay.groups)   # independent of the batch
        stats["result_shape"] = plan.shape
    return c
