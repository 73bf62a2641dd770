"""Matrix statistics used by the paper's pre-processing and evaluation tables
(host numpy on the pattern; values never enter)."""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sparse.format import CSC, _np


def column_nnz(m: CSC) -> np.ndarray:
    """nnz per column, length n_cols."""
    return np.diff(_np(m.col_ptr)).astype(np.int64)


def _per_b_column(b: CSC, contrib: np.ndarray) -> np.ndarray:
    out = np.zeros(b.n_cols, np.int64)
    seg = np.repeat(np.arange(b.n_cols), np.diff(_np(b.col_ptr)))
    np.add.at(out, seg, contrib)
    return out


def ops_per_column(a: CSC, b: CSC) -> np.ndarray:
    """Op_j = sum over nonzero B[k,j] of nnz(A[:,k])  (paper, Section 3.1).

    The number of scalar multiplications needed for column j of C = A @ B.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    rows_b = _np(b.row_indices)[: b.nnz]
    return _per_b_column(b, column_nnz(a)[rows_b])


def steps_per_column(a: CSC, b: CSC) -> np.ndarray:
    """Lock-step trip-count bound per C column: sum of max(nnz(A[:,k]), 1).

    A lock-step lane consumes one step per stored B[k,j] even when A's
    column k is *empty*, so the kernel trip count must bound this, not
    ``ops_per_column``.
    """
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    rows_b = _np(b.row_indices)[: b.nnz]
    return _per_b_column(b, np.maximum(column_nnz(a), 1)[rows_b])


@dataclasses.dataclass(frozen=True)
class TileStats:
    """Cheap per-tile statistics feeding the auto cost model (``core.cost``).

    One instance summarizes one tile-pair product ``A[:, k] @ B[k, n]``:
    the per-output-column work profile (``ops``/``steps``) plus operand
    occupancy.  Everything is pattern-only and O(nnz) to compute.
    """

    m: int                 # output rows  (= tile A rows)
    k: int                 # contraction width (= tile A cols = tile B rows)
    n: int                 # output cols  (= tile B cols)
    nnz_a: int
    nnz_b: int
    ops: np.ndarray        # [n] Op_j per output column (scalar multiplies)
    steps: np.ndarray      # [n] lock-step trip-count bound per column

    @property
    def flops(self) -> int:
        return int(self.ops.sum())


def tile_stats(a: CSC, b: CSC) -> TileStats:
    """Per-tile Op_j / density profile of the product A @ B."""
    if a.n_cols != b.n_rows:
        raise ValueError(f"shape mismatch {a.shape} @ {b.shape}")
    return TileStats(
        m=a.n_rows, k=a.n_cols, n=b.n_cols,
        nnz_a=a.nnz, nnz_b=b.nnz,
        ops=ops_per_column(a, b),
        steps=steps_per_column(a, b),
    )


@dataclasses.dataclass(frozen=True)
class MatrixStats:
    """The statistics columns of the paper's Table 1."""

    n_rows: int
    n_cols: int
    nnz: int
    nnz_min: int
    nnz_max: int
    nnz_avg: float
    nnz_var: float
    mult_min: int
    mult_max: int
    mult_avg: float
    mult_var: float


def matrix_stats(m: CSC, other: CSC | None = None) -> MatrixStats:
    """Stats for C = M @ M (paper uses A = B) or C = other @ m if given."""
    a = other if other is not None else m
    z = column_nnz(m)
    ops = ops_per_column(a, m)
    return MatrixStats(
        n_rows=m.n_rows,
        n_cols=m.n_cols,
        nnz=m.nnz,
        nnz_min=int(z.min()),
        nnz_max=int(z.max()),
        nnz_avg=float(z.mean()),
        nnz_var=float(z.var()),
        mult_min=int(ops.min()),
        mult_max=int(ops.max()),
        mult_avg=float(ops.mean()),
        mult_var=float(ops.var()),
    )
