"""Pattern-only intermediate-product expansion (the Gustavson product order).

Every algorithm of the paper enumerates the same multiset of scalar
products ``A[i,k] * B[k,j]``.  This module lists them once, vectorized, in
host numpy; the product stream (``core.fast``) builds on it.  The
counterpart of the JAX package's ``core/expand.py`` (``product_count`` and
``expand_positions``), copied so that the port imports nothing of it.
"""

from __future__ import annotations

import numpy as np


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
