"""Group-level wrappers around the kernels.

``run_spa``/``run_spars``/``run_hash`` each launch one kernel for a single
plan :class:`~repro_torch.core.planner.KernelGroup` — the per-family column
grouping, padding, trip counts and hash sizes all come from the plan.  One
launch per distinct hash table size H realizes the paper's dynamic table
shrinking.  The executor compacts each group's output into CSC on the
device, so no ``[m, n]`` dense intermediate exists.  The ``*_batched``
forms launch once per group for B same-pattern value sets (``a_arrs``' and
``b_vals``' values carry a leading batch axis).

``spgemm_cuda`` is the counterpart of the JAX package's ``spgemm_pallas``:
plan once (or take a held plan), execute once, for direct use (tests,
notebooks); ``method="auto"`` plans a tile grid of kernel families.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hash_spgemm import hash_spgemm, hash_spgemm_batched
from repro_torch.kernels.spa import spa_spgemm, spa_spgemm_batched
from repro_torch.kernels.spars import spars_spgemm, spars_spgemm_batched
from repro_torch.sparse.format import CSC


def run_spa(group, a_arrs, b_vals, *, m: int,
            block_cols: int) -> torch.Tensor:
    """Dense [m, n_real] tile for one SPA plan group."""
    a_rows, a_vals, a_nnz = a_arrs
    out = spa_spgemm(a_rows, a_vals, a_nnz, group.b_rows, b_vals,
                     group.b_nnz, m=m, block_cols=block_cols)
    return out[:, : group.n_real]


def run_spars(group, a_arrs, b_vals, *, m: int,
              block_cols: int) -> torch.Tensor:
    """Dense [m, n_real] tile for one SPARS plan group (plan-provided steps)."""
    a_rows, a_vals, a_nnz = a_arrs
    out, _flags = spars_spgemm(a_rows, a_vals, a_nnz, group.b_rows, b_vals,
                               group.b_nnz, group.steps, m=m,
                               block_cols=block_cols)
    return out[:, : group.n_real]


def run_hash(group, a_arrs, b_vals, *, m: int, block_cols: int):
    """Hash tables (keys, vals) [H, n_real] for one HASH plan group."""
    a_rows, a_vals, a_nnz = a_arrs
    keys, vals = hash_spgemm(a_rows, a_vals, a_nnz, group.b_rows, b_vals,
                             group.b_nnz, group.steps, m=m, h=int(group.h),
                             block_cols=block_cols)
    return keys[:, : group.n_real], vals[:, : group.n_real]


def run_spa_batched(group, a_arrs, b_vals, *, m: int,
                    block_cols: int) -> torch.Tensor:
    """Dense [B, m, n_real] tiles for one SPA plan group, one launch."""
    a_rows, a_vals, a_nnz = a_arrs
    out = spa_spgemm_batched(a_rows, a_vals, a_nnz, group.b_rows, b_vals,
                             group.b_nnz, m=m, block_cols=block_cols)
    return out[:, :, : group.n_real]


def run_spars_batched(group, a_arrs, b_vals, *, m: int,
                      block_cols: int) -> torch.Tensor:
    """Dense [B, m, n_real] tiles for one SPARS plan group, one launch."""
    a_rows, a_vals, a_nnz = a_arrs
    out, _flags = spars_spgemm_batched(a_rows, a_vals, a_nnz, group.b_rows,
                                       b_vals, group.b_nnz, group.steps,
                                       m=m, block_cols=block_cols)
    return out[:, :, : group.n_real]


def run_hash_batched(group, a_arrs, b_vals, *, m: int, block_cols: int):
    """Hash tables (keys, vals) [B, H, n_real] for one HASH plan group, one
    launch."""
    a_rows, a_vals, a_nnz = a_arrs
    keys, vals = hash_spgemm_batched(a_rows, a_vals, a_nnz, group.b_rows,
                                     b_vals, group.b_nnz, group.steps, m=m,
                                     h=int(group.h), block_cols=block_cols)
    return keys[:, :, : group.n_real], vals[:, :, : group.n_real]


def spgemm_cuda(a: CSC, b: CSC, method: str = "spa", *, t: float = 40.0,
                b_min: int | None = None, b_max: int | None = None,
                block_cols: int = 128, tile_cols: int | None = None,
                tile=None, plan=None, device=None) -> CSC:
    """C = A @ B through the per-group kernels (plan once, execute once).

    The lock-step kernels use fixed-width column blocks (``block_cols``), so
    ``b_min``/``b_max`` (or the bounds in the method's name) select the
    *family* and not the blocking; hybrids split at ``t`` (the paper's 40);
    ``tile_cols`` (a multiple of ``block_cols``) bounds the C columns of one
    launch.  ``method="auto"`` builds a tiled plan whose per-tile kernel
    families the cost model picks (``tile=`` sets the grid).  A held
    ``plan`` (from ``core.plan_spgemm`` or ``core.plan_spgemm_tiled``)
    skips the symbolic phase.  The host-only methods have no kernel family
    and raise.
    """
    from repro_torch.core.backends import get_backend
    from repro_torch.core.planner import check_method, plan_spgemm, \
        plan_spgemm_tiled

    if method != "auto":
        check_method(method, get_backend("cuda"))
    if tile is not None and (plan is not None or method != "auto"):
        raise ValueError(
            "tile= only applies to method='auto' without a held plan")
    if plan is None:
        if method == "auto":
            if (t != 40.0 or b_min is not None or b_max is not None
                    or block_cols != 128 or tile_cols is not None):
                raise ValueError(
                    "t/b_min/b_max/block_cols/tile_cols do not apply to "
                    "method='auto' (per-tile methods use their own "
                    "defaults)")
            plan = plan_spgemm_tiled(a, b, backend="cuda", tile=tile,
                                     device=device)
        else:
            plan = plan_spgemm(a, b, method, backend="cuda", t=t,
                               b_min=b_min, b_max=b_max,
                               block_cols=block_cols, tile_cols=tile_cols,
                               device=device)
    return plan.execute(a, b)
