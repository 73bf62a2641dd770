"""Group-level wrappers around the kernels.

``run_spa``/``run_spars``/``run_hash`` each launch one kernel for a single
plan :class:`~repro_torch.core.planner.KernelGroup` — the per-family column
grouping, padding, trip counts and hash sizes all come from the plan.  One
launch per distinct hash table size H realizes the paper's dynamic table
shrinking.  The executor compacts each group's output into CSC on the
device, so no ``[m, n]`` dense intermediate exists.

``spgemm_cuda`` is the counterpart of the JAX package's ``spgemm_pallas``:
plan once, execute once, for direct use (tests, notebooks).
"""

from __future__ import annotations

import torch

from repro_torch.kernels.hash_spgemm import hash_spgemm
from repro_torch.kernels.spa import spa_spgemm
from repro_torch.kernels.spars import spars_spgemm
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


def spgemm_cuda(a: CSC, b: CSC, method: str = "spa", *, device=None) -> CSC:
    """C = A @ B through the per-group kernels (plan once, execute once).

    The lock-step kernels use fixed-width column blocks, so the b_min/b_max
    of the named method select the *family*; hybrids split at the paper's
    t = 40.
    """
    from repro_torch.core.planner import plan_spgemm

    return plan_spgemm(a, b, method, device=device).execute(a, b)
