"""Faithful value-level executions of the paper's algorithms (host numpy).

These follow the pseudocode structurally — SPA's per-column accumulation
(Algorithm 1/2), SPARS's lock-step lane cursors over blocks (Algorithm 3),
HASH's per-lane linear-probed tables, ESC's expand/sort/compress — and are
the oracles of the ``"host"`` backend's ``"naive"`` engine.  They are the
JAX package's ``core/naive.py``, copied so that the port imports nothing of
it, and keep its results bit for bit: the same numpy operations in the same
order, and each column's rows in discovery order (SPA's touched list, HASH's
insert order), not sorted.  Results are port CSCs whose values are CPU
tensors wrapping the numpy arrays.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.analysis import HASH_C, Preprocess, preprocess
from repro_torch.sparse.format import CSC, _np, csc_from_numpy


# ---------------------------------------------------------------------------
# assembly helper
# ---------------------------------------------------------------------------


def _assemble(cols_rows, cols_vals, shape, dtype) -> CSC:
    """Build CSC from per-column (rows, vals) lists in original column order."""
    n = shape[1]
    col_ptr = np.zeros(n + 1, np.int32)
    np.cumsum([len(r) for r in cols_rows], out=col_ptr[1:])
    rows = (
        np.concatenate(cols_rows)
        if col_ptr[-1]
        else np.zeros(0, np.int32)
    )
    vals = np.concatenate(cols_vals) if col_ptr[-1] else np.zeros(0, dtype)
    return csc_from_numpy(vals, rows.astype(np.int32), col_ptr, shape)


# ---------------------------------------------------------------------------
# SPA (Algorithms 1–2)
# ---------------------------------------------------------------------------


def spa_numpy(a: CSC, b: CSC, columns: np.ndarray | None = None) -> CSC:
    """Vectorized-SPA semantics: one C column at a time; per B non-zero, a
    vector op of length nnz(A[:,k]) accumulates into the dense SPA arrays.

    ``columns``: process only these B columns (hybrids); output still spans
    all of C's columns (others empty).
    """
    a_cp = _np(a.col_ptr)
    a_rows = _np(a.row_indices)
    a_vals = _np(a.values)
    b_cp = _np(b.col_ptr)
    b_rows = _np(b.row_indices)
    b_vals = _np(b.values)
    m = a.n_rows
    n = b.n_cols
    dtype = np.result_type(a_vals.dtype, b_vals.dtype)

    spa_values = np.zeros(m, dtype)
    spa_flags = np.zeros(m, bool)

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros(0, dtype)] * n
    todo = range(n) if columns is None else [int(c) for c in columns]
    for j in todo:
        touched = []  # SPA_indices, in discovery order
        for p in range(b_cp[j], b_cp[j + 1]):
            k = b_rows[p]
            bv = b_vals[p]
            sl = slice(a_cp[k], a_cp[k + 1])
            ar = a_rows[sl]
            spa_values[ar] += a_vals[sl] * bv  # rows unique within an A column
            new = ar[~spa_flags[ar]]
            spa_flags[new] = True
            if len(new):
                touched.append(new)
        idx = (
            np.concatenate(touched) if touched else np.zeros(0, np.int32)
        )
        out_rows[j] = idx.astype(np.int32)
        out_vals[j] = spa_values[idx].astype(dtype)
        # reset only the touched entries (standard SPA trick)
        spa_values[idx] = 0
        spa_flags[idx] = False
    return _assemble(out_rows, out_vals, (m, n), dtype)


# ---------------------------------------------------------------------------
# SPARS (Algorithm 3)
# ---------------------------------------------------------------------------


def spars_numpy(
    a: CSC, b: CSC, pre: Preprocess | None = None,
    *, b_min: int = 256, b_max: int = 256,
) -> CSC:
    """Lock-step block execution with lane cursors, faithful to Algorithm 3."""
    if pre is None:
        pre = preprocess(a, b, t=np.inf, b_min=b_min, b_max=b_max)
    a_cp = _np(a.col_ptr).astype(np.int64)
    a_rows = _np(a.row_indices)
    a_vals = _np(a.values)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)
    b_vals = _np(b.values)
    m = a.n_rows
    n = b.n_cols
    dtype = np.result_type(a_vals.dtype, b_vals.dtype)

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros(0, dtype)] * n

    for start, size in pre.blocks:
        cols = pre.perm[start : start + size]  # original column ids (lanes)
        L = len(cols)
        vidx_b = b_cp[cols].copy()       # vIndices_B
        vend_b = b_cp[cols + 1]          # vEnd_B
        vcnt_a = np.zeros(L, np.int64)   # vCounter_A
        spa_values = np.zeros((m, L), dtype)
        spa_flags = np.zeros((m, L), bool)
        touched = [[] for _ in range(L)]
        active = vidx_b < vend_b
        while active.any():
            lanes = np.nonzero(active)[0]
            bk = b_rows[vidx_b[lanes]]
            bv = b_vals[vidx_b[lanes]]
            apos = a_cp[bk] + vcnt_a[lanes]
            # a lane whose B entry references an *empty* A column produces no
            # product; it just consumes that B entry this step (ok == False)
            ok = apos < a_cp[bk + 1]
            l_ok, r_ok = lanes[ok], a_rows[apos[ok]]
            spa_values[r_ok, l_ok] += a_vals[apos[ok]] * bv[ok]
            newm = ~spa_flags[r_ok, l_ok]
            spa_flags[r_ok[newm], l_ok[newm]] = True
            for ln, r in zip(l_ok[newm], r_ok[newm]):
                touched[ln].append(r)
            last = apos + 1 >= a_cp[bk + 1]
            vcnt_a[lanes] = np.where(last, 0, vcnt_a[lanes] + 1)
            vidx_b[lanes] += last
            active = vidx_b < vend_b
        for ln, col in enumerate(cols):
            idx = np.asarray(touched[ln], np.int32)
            out_rows[col] = idx
            out_vals[col] = spa_values[idx, ln].astype(dtype)
    return _assemble(out_rows, out_vals, (m, n), dtype)


# ---------------------------------------------------------------------------
# HASH (Section 3.2)
# ---------------------------------------------------------------------------


def hash_numpy(
    a: CSC, b: CSC, pre: Preprocess | None = None,
    *, b_min: int = 256, b_max: int = 256,
) -> CSC:
    """Lock-step blocks with per-lane linear-probed hash tables.

    Table size H is per block (dynamic shrink, Section 3.2). Collisions are
    resolved by real probing, so this validates the hash path end to end.
    """
    if pre is None:
        pre = preprocess(a, b, t=np.inf, b_min=b_min, b_max=b_max)
    a_cp = _np(a.col_ptr).astype(np.int64)
    a_rows = _np(a.row_indices)
    a_vals = _np(a.values)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)
    b_vals = _np(b.values)
    m = a.n_rows
    n = b.n_cols
    dtype = np.result_type(a_vals.dtype, b_vals.dtype)

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros(0, dtype)] * n

    for bi, (start, size) in enumerate(pre.blocks):
        cols = pre.perm[start : start + size]
        L = len(cols)
        H = int(pre.hash_sizes[bi])
        keys = np.full((H, L), -1, np.int64)
        vals = np.zeros((H, L), dtype)
        vidx_b = b_cp[cols].copy()
        vend_b = b_cp[cols + 1]
        vcnt_a = np.zeros(L, np.int64)
        insert_order = [[] for _ in range(L)]
        active = vidx_b < vend_b
        while active.any():
            all_lanes = np.nonzero(active)[0]
            bk = b_rows[vidx_b[all_lanes]]
            bv_all = b_vals[vidx_b[all_lanes]]
            apos_all = a_cp[bk] + vcnt_a[all_lanes]
            # lanes whose B entry references an empty A column produce no
            # product; they only consume that B entry this step (ok == False)
            ok = apos_all < a_cp[bk + 1]
            lanes, apos, bv = all_lanes[ok], apos_all[ok], bv_all[ok]
            ar = a_rows[apos].astype(np.int64)
            av = a_vals[apos]
            # vectorized linear probing across lanes (lanes independent)
            pos = (ar * HASH_C) % H
            pending = np.ones(len(lanes), bool)
            while pending.any():
                pl = np.nonzero(pending)[0]
                kk = keys[pos[pl], lanes[pl]]
                hit = kk == ar[pl]
                empty = kk == -1
                place = hit | empty
                tgt = pl[place]
                keys[pos[tgt], lanes[tgt]] = ar[tgt]
                vals[pos[tgt], lanes[tgt]] += av[tgt] * bv[tgt]
                for t_i, was_empty in zip(tgt, empty[place]):
                    if was_empty:
                        insert_order[lanes[t_i]].append(int(ar[t_i]))
                pending[tgt] = False
                nxt = pl[~place]
                pos[nxt] = (pos[nxt] + 1) % H
            last = apos_all + 1 >= a_cp[bk + 1]
            vcnt_a[all_lanes] = np.where(last, 0, vcnt_a[all_lanes] + 1)
            vidx_b[all_lanes] += last
            active = vidx_b < vend_b
        for ln, col in enumerate(cols):
            idx = np.asarray(insert_order[ln], np.int64)
            if len(idx) == 0:
                out_rows[col] = np.zeros(0, np.int32)
                out_vals[col] = np.zeros(0, dtype)
                continue
            # read back through the table (probe again)
            v = np.empty(len(idx), dtype)
            for q, key in enumerate(idx):
                p = (key * HASH_C) % H
                while keys[p, ln] != key:
                    p = (p + 1) % H
                v[q] = vals[p, ln]
            out_rows[col] = idx.astype(np.int32)
            out_vals[col] = v
    return _assemble(out_rows, out_vals, (m, n), dtype)


# ---------------------------------------------------------------------------
# ESC (Section 4)
# ---------------------------------------------------------------------------


def esc_numpy(
    a: CSC, b: CSC, *, group_threshold: int = 10_000, radix_bits: int = 5
) -> CSC:
    """Expand-Sort-Compress with an explicit LSD radix sort (row key first,
    then column key), grouping columns until >= group_threshold products."""
    from repro_torch.core.expand import expand_products, product_col_ptr

    coo = expand_products(a, b)
    pcp = product_col_ptr(a, b)
    m, n = coo.shape
    coo_vals = _np(coo.values)
    dtype = coo_vals.dtype

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros(0, dtype)] * n

    j = 0
    while j < n:
        j2 = j + 1
        while j2 < n and pcp[j2 + 1] - pcp[j] < group_threshold:
            j2 += 1
        lo, hi = pcp[j], pcp[j2]
        id_row = coo.rows[lo:hi].astype(np.int64)
        id_col = coo.cols[lo:hi].astype(np.int64)
        esc_val = coo_vals[lo:hi]
        # --- Sort: LSD radix, row digits then col digits -------------------
        order = np.arange(len(id_row))
        for key, kmax in ((id_row, m), (id_col, n)):
            bits = max(int(np.ceil(np.log2(max(kmax, 2)))), 1)
            r = radix_bits if radix_bits * ((bits + 5) // 6) else radix_bits
            # paper: r=5 unless r=6 lowers the round count
            r5, r6 = -(-bits // 5), -(-bits // 6)
            r = 6 if r6 < r5 else 5
            kk = key[order]
            for d in range(0, bits, r):
                digit = (kk >> d) & ((1 << r) - 1)
                o2 = np.argsort(digit, kind="stable")
                order = order[o2]
                kk = kk[o2]
        id_row, id_col, esc_val = id_row[order], id_col[order], esc_val[order]
        # --- Compress: segment-sum equal (row, col) pairs -------------------
        if len(id_row):
            key = id_col * m + id_row
            boundary = np.empty(len(key), bool)
            boundary[0] = True
            boundary[1:] = key[1:] != key[:-1]
            seg = np.cumsum(boundary) - 1
            sums = np.zeros(seg[-1] + 1, dtype)
            np.add.at(sums, seg, esc_val)
            u_rows = id_row[boundary]
            u_cols = id_col[boundary]
            for c in np.unique(u_cols):
                sel = u_cols == c
                out_rows[int(c)] = u_rows[sel].astype(np.int32)
                out_vals[int(c)] = sums[sel]
        j = j2
    return _assemble(out_rows, out_vals, (m, n), dtype)


# ---------------------------------------------------------------------------
# Hybrids (Section 3.3)
# ---------------------------------------------------------------------------


def hybrid_numpy(
    a: CSC, b: CSC, *, t: float, b_min: int, b_max: int,
    accumulator: str = "spa", pre: Preprocess | None = None,
) -> CSC:
    """H-SPA(t) / H-HASH(t): SPA on sorted columns while Op_j >= t, then the
    blocked algorithm (SPARS or HASH) on the sparse tail.

    ``pre``: pass a matching plan's pre-processing to skip re-analysis.
    """
    if pre is None:
        pre = preprocess(a, b, t=t, b_min=b_min, b_max=b_max)
    head_cols = pre.perm[: pre.split]
    c_head = spa_numpy(a, b, columns=head_cols)
    if accumulator == "spa":
        c_tail = spars_numpy(a, b, pre)
    elif accumulator == "hash":
        c_tail = hash_numpy(a, b, pre)
    else:
        raise ValueError(accumulator)
    # merge: head columns from c_head, tail columns from c_tail
    n = b.n_cols
    dtype = _np(c_head.values).dtype
    rows_l = [np.zeros(0, np.int32)] * n
    vals_l = [np.zeros(0, dtype)] * n
    head_set = set(int(x) for x in head_cols)
    for j in range(n):
        src = c_head if j in head_set else c_tail
        r, v = src.column(j)
        rows_l[j] = r.astype(np.int32)
        vals_l[j] = v
    return _assemble(rows_l, vals_l, (a.n_rows, n), dtype)


# ---------------------------------------------------------------------------
# BEYOND-PAPER: lock-step with lane refill ("work-stealing" SPARS)
# ---------------------------------------------------------------------------


def spars_ws_numpy(
    a: CSC, b: CSC, pre: Preprocess | None = None,
    *, b_min: int = 256, b_max: int = 256,
) -> CSC:
    """SPARS with lane refill: when a lane exhausts its column it flushes the
    column and immediately claims the next unprocessed one, instead of idling
    masked until the block's longest column finishes (the semi-transparent
    area of the paper's Figure 2). Extra cost per refill: one store-out +
    accumulator reset + cursor reload — all machinery SPARS already has.
    Value-identical to SPARS (tested against the dense oracle)."""
    if pre is None:
        pre = preprocess(a, b, t=np.inf, b_min=b_min, b_max=b_max)
    a_cp = _np(a.col_ptr).astype(np.int64)
    a_rows = _np(a.row_indices)
    a_vals = _np(a.values)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)
    b_vals = _np(b.values)
    m = a.n_rows
    n = b.n_cols
    dtype = np.result_type(a_vals.dtype, b_vals.dtype)

    out_rows = [np.zeros(0, np.int32)] * n
    out_vals = [np.zeros(0, dtype)] * n

    for start, size in pre.blocks:
        cols = pre.perm[start : start + size]
        L = len(cols)
        queue = list(range(L))          # column indices waiting for a lane
        lane_col = np.full(L, -1, np.int64)
        vidx_b = np.zeros(L, np.int64)
        vend_b = np.zeros(L, np.int64)
        vcnt_a = np.zeros(L, np.int64)
        spa_values = np.zeros((m, L), dtype)
        spa_flags = np.zeros((m, L), bool)
        touched = [[] for _ in range(L)]

        def flush(ln):
            ci = lane_col[ln]
            if ci < 0:
                return
            col = cols[ci]
            idx = np.asarray(touched[ln], np.int32)
            out_rows[col] = idx
            out_vals[col] = spa_values[idx, ln].astype(dtype)
            spa_values[idx, ln] = 0
            spa_flags[idx, ln] = False
            touched[ln] = []

        def refill(ln):
            flush(ln)
            if queue:
                ci = queue.pop(0)
                lane_col[ln] = ci
                vidx_b[ln] = b_cp[cols[ci]]
                vend_b[ln] = b_cp[cols[ci] + 1]
                vcnt_a[ln] = 0
            else:
                lane_col[ln] = -1

        for ln in range(L):
            refill(ln)
        # drain columns that start empty
        for ln in range(L):
            while lane_col[ln] >= 0 and vidx_b[ln] >= vend_b[ln]:
                refill(ln)
        active = (lane_col >= 0) & (vidx_b < vend_b)
        while active.any():
            lanes = np.nonzero(active)[0]
            bk = b_rows[vidx_b[lanes]]
            bv = b_vals[vidx_b[lanes]]
            apos = a_cp[bk] + vcnt_a[lanes]
            # empty A column referenced: no product, consume the B entry
            ok = apos < a_cp[bk + 1]
            l_ok, r_ok = lanes[ok], a_rows[apos[ok]]
            spa_values[r_ok, l_ok] += a_vals[apos[ok]] * bv[ok]
            newm = ~spa_flags[r_ok, l_ok]
            spa_flags[r_ok[newm], l_ok[newm]] = True
            for ln, r in zip(l_ok[newm], r_ok[newm]):
                touched[ln].append(r)
            last = apos + 1 >= a_cp[bk + 1]
            vcnt_a[lanes] = np.where(last, 0, vcnt_a[lanes] + 1)
            vidx_b[lanes] += last
            for ln in lanes:
                while lane_col[ln] >= 0 and vidx_b[ln] >= vend_b[ln]:
                    refill(ln)
            active = (lane_col >= 0) & (vidx_b < vend_b)
        for ln in range(L):
            flush(ln)
    return _assemble(out_rows, out_vals, (m, n), dtype)
