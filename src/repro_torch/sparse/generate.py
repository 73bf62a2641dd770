"""Synthetic sparse-matrix generators (host numpy, deterministic by seed).

Each generator draws the same numbers as its counterpart in the JAX package,
so one seed gives one matrix in both.  ``random_uniform_csc`` is the paper's
synthetic-matrix setup (Section 5.2): n×n, exactly Z non-zeros per column,
rows uniform without replacement; ``z=0`` gives the empty matrix.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.format import CSC, csc_from_dense, csc_from_numpy


def _rng(seed):
    return np.random.default_rng(seed)


def random_uniform_csc(
    n: int, z: int, *, seed: int = 0, dtype=np.float64, n_rows: int | None = None
) -> CSC:
    """n_rows × n matrix with exactly ``z`` non-zeros per column, uniform rows."""
    rng = _rng(seed)
    n_rows = n if n_rows is None else n_rows
    if z < 0 or z > n_rows:
        raise ValueError(f"z={z} outside [0, n_rows={n_rows}]")
    rows = np.empty((n, z), np.int32)
    for j in range(n):
        rows[j] = rng.choice(n_rows, size=z, replace=False)
        rows[j].sort()
    vals = rng.uniform(0.5, 1.5, size=(n, z)).astype(dtype)  # bounded away from 0
    col_ptr = np.arange(n + 1, dtype=np.int32) * z
    return csc_from_numpy(vals.reshape(-1), rows.reshape(-1), col_ptr,
                          (n_rows, n))


def random_density_csc(
    n_rows: int, n_cols: int, density: float, *, seed: int = 0, dtype=np.float64
) -> CSC:
    """Bernoulli(density) occupancy."""
    rng = _rng(seed)
    mask = rng.uniform(size=(n_rows, n_cols)) < density
    dense = np.where(mask, rng.uniform(0.5, 1.5, size=(n_rows, n_cols)), 0.0)
    return csc_from_dense(dense.astype(dtype))


def random_banded_csc(
    n: int, bandwidth: int, *, fill: float = 1.0, seed: int = 0, dtype=np.float64
) -> CSC:
    """Banded matrix (PDE-like pattern, e.g. olm1000/tub1000 family)."""
    rng = _rng(seed)
    rows_l, vals_l, col_ptr = [], [], [0]
    for j in range(n):
        lo = max(0, j - bandwidth)
        hi = min(n, j + bandwidth + 1)
        cand = np.arange(lo, hi)
        if fill < 1.0:
            keep = rng.uniform(size=len(cand)) < fill
            keep[cand == j] = True  # keep the diagonal
            cand = cand[keep]
        rows_l.append(cand.astype(np.int32))
        vals_l.append(rng.uniform(0.5, 1.5, size=len(cand)).astype(dtype))
        col_ptr.append(col_ptr[-1] + len(cand))
    return csc_from_numpy(np.concatenate(vals_l), np.concatenate(rows_l),
                          col_ptr, (n, n))


def random_powerlaw_csc(
    n: int,
    avg_nnz: float,
    alpha: float = 2.0,
    *,
    max_nnz: int | None = None,
    seed: int = 0,
    dtype=np.float64,
) -> CSC:
    """Power-law column degrees (graph-like pattern, e.g. Kohonen)."""
    rng = _rng(seed)
    max_nnz = max_nnz or n
    raw = rng.pareto(alpha, size=n) + 1.0
    deg = np.clip(np.round(raw * avg_nnz / raw.mean()).astype(np.int64), 1, max_nnz)
    rows_l, vals_l, col_ptr = [], [], [0]
    for j in range(n):
        z = int(min(deg[j], n))
        r = rng.choice(n, size=z, replace=False)
        r.sort()
        rows_l.append(r.astype(np.int32))
        vals_l.append(rng.uniform(0.5, 1.5, size=z).astype(dtype))
        col_ptr.append(col_ptr[-1] + z)
    return csc_from_numpy(np.concatenate(vals_l), np.concatenate(rows_l),
                          col_ptr, (n, n))
