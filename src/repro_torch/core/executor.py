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
"""

from __future__ import annotations

import torch

from repro_torch.core.backends import check_engine, get_backend
from repro_torch.core.planner import BLOCK_COLS, SpgemmPlan
from repro_torch.sparse.format import CSC, CSCBuilder, as_tensor, \
    padded_values


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


def _values(x, device) -> torch.Tensor:
    """The operand's value vector as f32 on ``device`` (cast before the
    gather: the cast is elementwise, so it equals the reference's cast of
    the gathered values)."""
    v = x.values if isinstance(x, CSC) else x
    return as_tensor(v).to(device=device, dtype=torch.float32)


def _execute_groups(plan: SpgemmPlan, a_values, b_values, *,
                    stats: dict | None = None) -> CSC:
    from repro_torch.kernels import ops as kops  # kernels import core

    plan.a.check_compatible(a_values)
    plan.b.check_compatible(b_values)
    lay = plan.layout
    m, n = plan.shape
    dev = plan.device
    av = padded_values(_values(a_values, dev)[: plan.a.nnz], lay.a_gather,
                       lay.a_mask)
    b_raw = _values(b_values, dev)[: plan.b.nnz]
    a_arrs = (lay.a_rows, av, lay.a_nnz)

    builder = CSCBuilder((m, n), lay.c_slots)
    for g in lay.groups:
        g_vals = padded_values(b_raw, g.b_vgather, g.b_vmask)
        if g.kind == "spa":
            builder.add_dense_tile(g.cols_t, kops.run_spa(
                g, a_arrs, g_vals, m=m, block_cols=BLOCK_COLS))
        elif g.kind == "spars":
            builder.add_dense_tile(g.cols_t, kops.run_spars(
                g, a_arrs, g_vals, m=m, block_cols=BLOCK_COLS))
        elif g.kind == "hash":
            keys, vals = kops.run_hash(g, a_arrs, g_vals, m=m,
                                       block_cols=BLOCK_COLS)
            builder.add_hash_tables(g.cols_t, keys, vals)
        else:
            raise AssertionError(g.kind)
    c = builder.build()
    if stats is not None:
        stats["engine"] = "naive"
        stats["tile_shapes"] = list(builder.tile_shapes)
        stats["peak_tile_elems"] = builder.peak_tile_elems
        stats["n_launches"] = len(lay.groups)
        stats["result_shape"] = (m, n)
    return c
