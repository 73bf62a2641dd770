"""Intermediate-product expansion (the Gustavson product order).

Every algorithm of the paper enumerates the same multiset of scalar
products ``A[i,k] * B[k,j]``.  This module lists them once, vectorized, in
host numpy: by position (:func:`expand_positions`, which the product stream
of ``core.fast`` builds on) and by value (:func:`expand_products`, which the
host ``expand`` method and ESC consume).  The counterpart of the JAX
package's ``core/expand.py``, copied so that the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.sparse.format import CSC, COO, _np, as_tensor, csc_from_coo


def product_count(a_col_ptr, b_col_ptr, b_row_indices) -> int:
    """Number of scalar products of C = A @ B (pattern-only, O(nnz_b))."""
    a_cp = np.asarray(a_col_ptr).astype(np.int64)
    b_cp = np.asarray(b_col_ptr)
    b_rows = np.asarray(b_row_indices)[: int(b_cp[-1])]
    return int((a_cp[b_rows + 1] - a_cp[b_rows]).sum())


def expand_positions(a_col_ptr, b_col_ptr, b_row_indices):
    """Pattern-only Gustavson expansion: ``(a_pos, b_pos, cols)``, int64.

    One entry per scalar product of C = A @ B, in Gustavson stream order:
    for each column j of B (in order), for each stored B[k,j] (in storage
    order), for each stored A[i,k] (in storage order).  ``a_pos``/``b_pos``
    index the operands' value arrays; ``cols`` is the product's C column.
    This is the single source of the product order, and hence of the
    summation order of every C slot.
    """
    a_cp = np.asarray(a_col_ptr).astype(np.int64)
    b_cp = np.asarray(b_col_ptr).astype(np.int64)
    b_rows = np.asarray(b_row_indices)[: int(b_cp[-1])]
    n = len(b_cp) - 1

    # per stored B element: the A-column slice it multiplies
    seg_starts = a_cp[b_rows]
    seg_lens = a_cp[b_rows + 1] - seg_starts
    total = int(seg_lens.sum())
    if total == 0:
        z = np.zeros(0, np.int64)
        return z, z.copy(), z.copy()
    # for element e with slice [s_e, s_e + l_e), emit s_e .. s_e + l_e - 1:
    # the global index minus the element's start in the stream, plus s_e
    stream_starts = np.concatenate(([0], np.cumsum(seg_lens)[:-1]))
    a_pos = np.arange(total, dtype=np.int64) + np.repeat(
        seg_starts - stream_starts, seg_lens)
    b_pos = np.repeat(np.arange(len(b_rows), dtype=np.int64), seg_lens)
    cols = np.repeat(
        np.repeat(np.arange(n, dtype=np.int64), np.diff(b_cp)), seg_lens)
    return a_pos, b_pos, cols


def expand_products(a: CSC, b: CSC) -> COO:
    """All intermediate products as COO triples, in Gustavson column order:
    for each column j of B, each stored B[k,j], each stored A[i,k], the
    triple (i, j, A_ik * B_kj), multiplied in host numpy in the operands'
    common dtype."""
    a_rows = _np(a.row_indices)
    a_vals = _np(a.values)
    b_vals = _np(b.values)[: b.nnz]
    shape = (a.shape[0], b.shape[1])
    a_pos, b_pos, cols = expand_positions(
        _np(a.col_ptr), _np(b.col_ptr), _np(b.row_indices))
    if len(a_pos) == 0:
        return COO(np.zeros(0, np.int32), np.zeros(0, np.int32),
                   as_tensor(np.zeros(0, a_vals.dtype)), shape)
    rows = a_rows[a_pos].astype(np.int32)
    vals = a_vals[a_pos] * b_vals[b_pos]
    return COO(rows, cols.astype(np.int32), as_tensor(vals), shape)


def product_col_ptr(a: CSC, b: CSC) -> np.ndarray:
    """Offsets of each C column's products in the expanded stream (length
    n_B + 1; ``product_col_ptr[j+1] - product_col_ptr[j] == Op_j``)."""
    from repro_torch.sparse.stats import ops_per_column

    ops = ops_per_column(a, b)
    cp = np.zeros(len(ops) + 1, np.int64)
    np.cumsum(ops, out=cp[1:])
    return cp


def spgemm_expand(a: CSC, b: CSC) -> CSC:
    """C = A @ B by expansion and merge (the host ``expand`` method): the
    products of each (i, j) added in stream order, rows ascending."""
    return csc_from_coo(expand_products(a, b), sum_duplicates=True)
