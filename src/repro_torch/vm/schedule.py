"""Exact instruction schedules of the paper's algorithms (structure-only).

Every schedule function walks the pseudocode and emits the instructions it
would execute — per-instruction vector length, active-lane count, and the
address range its gathers/scatters touch — without computing any values.
Combined with ``vm.machine`` this reproduces the paper's timing behaviour;
combined with ``core.naive`` (value-level, tested against the dense oracle)
it constitutes the full reproduction.  Host numpy only, in the JAX package's
arithmetic and order, so that trace counts and prices equal its
``repro.vm`` bit for bit.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.analysis import HASH_C, Preprocess, VL_MAX
from repro_torch.core.expand import product_col_ptr
from repro_torch.sparse.format import CSC, _np
from repro_torch.sparse.stats import column_nnz
from repro_torch.vm.trace import Trace

BYTES_V = 8  # double-precision values
BYTES_I = 4  # 32-bit indices
BYTES_F = 1  # flag bytes


# ---------------------------------------------------------------------------
# shared structure helpers
# ---------------------------------------------------------------------------


def _chunk(t: Trace, kind: str, vls: np.ndarray, *, ws: float = 0,
           per: float = 1, vlmax: int = VL_MAX):
    """Emit ``per`` instructions for each natural vector length in ``vls``,
    split into VLMAX-sized chunks (the paper's strip-mining, Section 2.2)."""
    vls = np.asarray(vls, np.int64)
    vls = vls[vls > 0]
    if len(vls) == 0:
        return
    n_full = int((vls // vlmax).sum())
    if n_full:
        t.add(kind, vlmax, count=n_full * per, ws=ws)
    rem = vls % vlmax
    t.add_many(kind, rem, ws=ws, per=per)


def expanded_rows(a: CSC, b: CSC) -> tuple[np.ndarray, np.ndarray]:
    """(rows of every intermediate product in Gustavson order, col_ptr)."""
    a_cp = _np(a.col_ptr).astype(np.int64)
    a_rows = _np(a.row_indices)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)[: b.nnz]
    seg_starts = a_cp[b_rows]
    seg_lens = (a_cp[b_rows + 1] - seg_starts).astype(np.int64)
    total = int(seg_lens.sum())
    if total == 0:
        return np.zeros(0, np.int32), product_col_ptr(a, b)
    stream_starts = np.concatenate(([0], np.cumsum(seg_lens)[:-1]))
    apos = np.arange(total, dtype=np.int64) + np.repeat(
        seg_starts - stream_starts, seg_lens
    )
    return a_rows[apos], product_col_ptr(a, b)


def c_column_nnz(a: CSC, b: CSC) -> np.ndarray:
    """nnz of each C column (distinct rows among its products)."""
    rows, pcp = expanded_rows(a, b)
    n = b.n_cols
    out = np.zeros(n, np.int64)
    for j in range(n):
        seg = rows[pcp[j] : pcp[j + 1]]
        if len(seg):
            out[j] = len(np.unique(seg))
    return out


# ---------------------------------------------------------------------------
# SPA  (Algorithm 2)
# ---------------------------------------------------------------------------


def trace_spa(
    a: CSC, b: CSC, columns: np.ndarray | None = None, *,
    c_nnz: np.ndarray | None = None, trace: Trace | None = None,
    vlmax: int = VL_MAX,
) -> Trace:
    t = trace if trace is not None else Trace()
    m = a.n_rows
    za = column_nnz(a)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)[: b.nnz]
    if columns is None:
        cols = np.arange(b.n_cols)
        elem_rows = b_rows
    else:
        cols = np.asarray(columns, np.int64)
        if len(cols) == 0:
            return t
        segs = [b_rows[b_cp[j] : b_cp[j + 1]] for j in cols]
        elem_rows = np.concatenate(segs) if segs else np.zeros(0, np.int64)
    vls = za[elem_rows]  # natural VL per B element = nnz(A[:,k])

    # main loop, per B non-zero (strip-mined to vlmax):
    _chunk(t, "vload", vls, per=2)                        # A values + rows
    _chunk(t, "vload_idx", vls, ws=m * BYTES_V)           # SPA_values gather
    _chunk(t, "vload_idx", vls, ws=m * BYTES_F)           # SPA_flags gather
    _chunk(t, "vfma", vls)
    _chunk(t, "vstore_idx", vls, ws=m * BYTES_V)          # SPA_values scatter
    _chunk(t, "valu", vls, per=2)                         # flag cmp + compress
    _chunk(t, "vstore_idx", vls, ws=m * BYTES_F)          # flags set
    _chunk(t, "vstore", vls)                              # append new indices
    t.add("scalar", 1, count=4 * len(vls))                # loop bookkeeping

    # output phase, per processed column:
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz
    cn_sel = cn[cols]
    _chunk(t, "vload_idx", cn_sel, ws=m * BYTES_V)        # gather values
    _chunk(t, "vload", cn_sel)                            # read SPA_indices
    _chunk(t, "vstore", cn_sel, per=2)                    # C values + rows
    _chunk(t, "vstore_idx", cn_sel, ws=m * BYTES_V)       # reset values
    _chunk(t, "vstore_idx", cn_sel, ws=m * BYTES_F)       # reset flags
    t.add("scalar", 1, count=10 * len(cols))
    return t


# ---------------------------------------------------------------------------
# SPARS  (Algorithm 3)
# ---------------------------------------------------------------------------

# instruction mix executed once per lock-step iteration (all at VL = block):
# (kind, multiplicity, working-set key)
_SPARS_STEP_MIX = (
    ("vload_idx", 1, "b_span"),    # vB gather through vIndices_B
    ("vload_idx", 2, "a_colptr"),  # A col_ptr base + end gathers
    ("vload_idx", 1, "a_vals"),    # vA values
    ("vload_idx", 1, "a_rows"),    # vA row indices
    ("vload_idx", 1, "acc_vals"),  # SPA_values gather
    ("vload_idx", 1, "acc_flags"),
    ("vfma", 1, None),
    ("vstore_idx", 1, "acc_vals"),
    ("valu", 2, None),             # flag compare, vMask update
    ("vstore_idx", 1, "acc_flags"),
    ("vstore_idx", 1, "acc_idx"),  # SPA_indices append
    ("valu", 3, None),             # cursor compare/add/select
)


def _blocked_steps(
    t: Trace, a: CSC, b: CSC, pre: Preprocess, mix, ws_fn, *, vlmax: int
):
    """Emit the lock-step main loop for SPARS/HASH; returns per-block info."""
    info = []
    for bi, (start, size) in enumerate(pre.blocks):
        cols = pre.perm[start : start + size]
        L = int(size)
        ops_blk = pre.ops_sorted[start : start + size]
        # max, not [0]: blocks are sorted for the paper's algorithms but the
        # prior-work baseline (hash-sota) runs unsorted natural order
        steps = int(ops_blk.max()) if L else 0
        if steps == 0:
            t.add("scalar", 1, count=8)
            info.append((bi, cols, L, 0))
            continue
        # active lanes at step s = #lanes with Op > s
        o_sorted = np.sort(ops_blk)
        active = L - np.searchsorted(o_sorted, np.arange(1, steps + 1), "left")
        mean_active = float(active.mean())
        ws = ws_fn(bi, cols, L)
        for kind, mult, wkey in mix:
            t.add(kind, L, count=steps * mult, ws=ws.get(wkey, 0),
                  active=mean_active)
        t.add("scalar", 1, count=20)
        info.append((bi, cols, L, steps))
    return info


def _blocked_output(t: Trace, cn_cols: np.ndarray, L: int, acc_ws: float,
                    *, vlmax: int):
    """Per-block column store-out + accumulator reset (SPARS flavour)."""
    _chunk(t, "vload_idx", cn_cols, ws=acc_ws, vlmax=vlmax)
    _chunk(t, "vload", cn_cols, vlmax=vlmax)
    _chunk(t, "vstore", cn_cols, per=2, vlmax=vlmax)
    _chunk(t, "vstore_idx", cn_cols, ws=acc_ws, per=2, vlmax=vlmax)
    t.add("scalar", 1, count=6 * len(cn_cols))


def trace_spars(
    a: CSC, b: CSC, pre: Preprocess, *, c_nnz: np.ndarray | None = None,
    trace: Trace | None = None, vlmax: int = VL_MAX,
) -> Trace:
    t = trace if trace is not None else Trace()
    m = a.n_rows
    nnz_a = a.nnz
    b_cp = _np(b.col_ptr).astype(np.int64)
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz

    def ws_fn(bi, cols, L):
        span = (b_cp[cols + 1].max() - b_cp[cols].min()) * BYTES_V if L else 0
        return {
            "b_span": float(span),
            "a_colptr": a.n_cols * BYTES_I,
            "a_vals": nnz_a * BYTES_V,
            "a_rows": nnz_a * BYTES_I,
            "acc_vals": m * L * BYTES_V,
            "acc_flags": m * L * BYTES_F,
            "acc_idx": m * L * BYTES_I,
        }

    info = _blocked_steps(t, a, b, pre, _SPARS_STEP_MIX, ws_fn, vlmax=vlmax)
    for bi, cols, L, steps in info:
        if L:
            _blocked_output(t, cn[cols], L, m * L * BYTES_V, vlmax=vlmax)
    return t


# ---------------------------------------------------------------------------
# HASH  (Section 3.2)
# ---------------------------------------------------------------------------


def _column_displacements(rows_seq: np.ndarray, H: int) -> np.ndarray:
    """Linear-probing displacement of each product's key, order-independent.

    Occupied-slot multiset of linear probing is insertion-order independent,
    so we assign positions in hash order (parking process) and read each
    product's cost as its key's displacement.
    """
    if len(rows_seq) == 0:
        return np.zeros(0, np.int64)
    keys, inv = np.unique(rows_seq, return_inverse=True)
    h = (keys.astype(np.int64) * HASH_C) % H
    order = np.argsort(h, kind="stable")
    hs = h[order]
    # parking: pos_i = max(h_i, pos_{i-1}+1); with q_i = pos_i - i this is
    # q = cummax(h - i), pos = q + i
    idx = np.arange(len(hs))
    pos = np.maximum.accumulate(hs - idx) + idx
    disp = pos - hs  # non-circular approximation (exact when no wraparound)
    disp_by_key = np.empty(len(keys), np.int64)
    disp_by_key[order] = disp
    return disp_by_key[inv]


_HASH_STEP_MIX = (
    ("vload_idx", 1, "b_span"),
    ("vload_idx", 2, "a_colptr"),
    ("vload_idx", 1, "a_vals"),
    ("vload_idx", 1, "a_rows"),
    ("valu", 2, None),             # hash: multiply + mask/mod
    ("vload_idx", 1, "tab_keys"),  # probe read
    ("vload_idx", 1, "tab_vals"),
    ("vfma", 1, None),
    ("vstore_idx", 1, "tab_vals"),
    ("vstore_idx", 1, "tab_keys"),
    ("valu", 2, None),             # key compare, vMask update
    ("valu", 3, None),             # cursors
)


def trace_hash(
    a: CSC, b: CSC, pre: Preprocess, *, c_nnz: np.ndarray | None = None,
    trace: Trace | None = None, vlmax: int = VL_MAX,
    prod_rows: np.ndarray | None = None, prod_cp: np.ndarray | None = None,
) -> Trace:
    t = trace if trace is not None else Trace()
    nnz_a = a.nnz
    b_cp = _np(b.col_ptr).astype(np.int64)
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz
    if prod_rows is None:
        prod_rows, prod_cp = expanded_rows(a, b)

    hash_sizes = pre.hash_sizes

    def ws_fn(bi, cols, L):
        H = int(hash_sizes[bi])
        span = (b_cp[cols + 1].max() - b_cp[cols].min()) * BYTES_V if L else 0
        return {
            "b_span": float(span),
            "a_colptr": a.n_cols * BYTES_I,
            "a_vals": nnz_a * BYTES_V,
            "a_rows": nnz_a * BYTES_I,
            "tab_keys": H * L * BYTES_I,
            "tab_vals": H * L * BYTES_V,
        }

    info = _blocked_steps(t, a, b, pre, _HASH_STEP_MIX, ws_fn, vlmax=vlmax)

    # probe stalls: per step, one collision among the VL lanes stalls them all
    # (Section 3.2) -> extra probe iterations = max displacement across the
    # lanes active at that step.
    for bi, cols, L, steps in info:
        if steps == 0:
            continue
        H = int(hash_sizes[bi])
        disp_mat = np.zeros((steps, L), np.int64)
        for ln, col in enumerate(cols):
            seg = prod_rows[prod_cp[col] : prod_cp[col + 1]]
            if len(seg):
                disp_mat[: len(seg), ln] = _column_displacements(seg, H)
        stalls = disp_mat.max(axis=1)  # per-step extra probe iterations
        n_stall = int(stalls.sum())
        if n_stall:
            t.add("vload_idx", L, count=n_stall, ws=H * L * BYTES_I)
            t.add("valu", L, count=2 * n_stall)

        # output: scan the H x L table, compress, store per column; reset
        scan_chunks = max(1, -(-H * L // vlmax))
        t.add("vload", vlmax, count=2 * scan_chunks)   # keys + values
        t.add("valu", vlmax, count=scan_chunks)        # occupancy compress
        _chunk(t, "vstore", cn[cols], per=2, vlmax=vlmax)
        t.add("vstore", vlmax, count=2 * scan_chunks)  # table reset
        t.add("scalar", 1, count=6 * len(cols))
    return t


# ---------------------------------------------------------------------------
# ESC  (Section 4)
# ---------------------------------------------------------------------------


def trace_esc(
    a: CSC, b: CSC, *, group_threshold: int = 10_000,
    trace: Trace | None = None, vlmax: int = VL_MAX,
) -> Trace:
    t = trace if trace is not None else Trace()
    m, n = a.n_rows, b.n_cols
    za = column_nnz(a)
    b_cp = _np(b.col_ptr).astype(np.int64)
    b_rows = _np(b.row_indices)[: b.nnz]
    pcp = product_col_ptr(a, b)

    def radix_rounds(kmax):
        bits = max(int(np.ceil(np.log2(max(kmax, 2)))), 1)
        r5, r6 = -(-bits // 5), -(-bits // 6)
        return (6, r6) if r6 < r5 else (5, r5)

    j = 0
    while j < n:
        j2 = j + 1
        while j2 < n and pcp[j2 + 1] - pcp[j] < group_threshold:
            j2 += 1
        k = int(pcp[j2] - pcp[j])
        # Expand: per B element in group, one vector op of VL=nnz(A col)
        seg = b_rows[b_cp[j] : b_cp[j2]]
        vls = za[seg]
        _chunk(t, "vload", vls, per=2, vlmax=vlmax)      # A col values+rows
        _chunk(t, "vfma", vls, vlmax=vlmax)
        _chunk(t, "vstore", vls, per=3, vlmax=vlmax)     # val/row/col triples
        _chunk(t, "valu", vls, vlmax=vlmax)              # id generation
        t.add("scalar", 1, count=3 * len(vls))
        if k == 0:
            j = j2
            continue
        # Sort: LSD radix over row key then col key
        chunks = -(-k // vlmax)
        for kmax in (m, n):
            r, rounds = radix_rounds(kmax)
            bucket_ws = vlmax * (1 << r) * BYTES_I
            for _ in range(rounds):
                # histogram
                t.add("valu", vlmax, count=chunks)                 # digit
                t.add("vload_idx", vlmax, count=chunks, ws=bucket_ws)
                t.add("valu", vlmax, count=chunks)
                t.add("vstore_idx", vlmax, count=chunks, ws=bucket_ws)
                # bucket scan
                t.add("valu", vlmax, count=3 * (1 << r))
                # rank + permute (3 payload arrays)
                t.add("vload_idx", vlmax, count=chunks, ws=bucket_ws)
                t.add("valu", vlmax, count=chunks)
                t.add("vstore_idx", vlmax, count=chunks, ws=bucket_ws)
                t.add("vload", vlmax, count=3 * chunks)
                t.add("vstore_idx", vlmax, count=3 * chunks,
                      ws=k * (BYTES_V + 2 * BYTES_I))
        # Compress: strided per virtual processor
        stride_ws = k * (BYTES_V + 2 * BYTES_I)
        t.add("vload_idx", vlmax, count=3 * chunks, ws=stride_ws)
        t.add("valu", vlmax, count=2 * chunks)
        t.add("vstore_idx", vlmax, count=2 * chunks, ws=stride_ws)
        t.add("scalar", 1, count=vlmax)  # sequential VL-length boundary loop
        t.add("scalar", 1, count=20)
        j = j2
    return t


# ---------------------------------------------------------------------------
# Hybrids  (Section 3.3)
# ---------------------------------------------------------------------------


def trace_hybrid(
    a: CSC, b: CSC, pre: Preprocess, accumulator: str = "hash", *,
    c_nnz: np.ndarray | None = None, vlmax: int = VL_MAX,
) -> Trace:
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz
    t = Trace()
    head = pre.perm[: pre.split]
    trace_spa(a, b, columns=head, c_nnz=cn, trace=t, vlmax=vlmax)
    if accumulator == "spa":
        trace_spars(a, b, pre, c_nnz=cn, trace=t, vlmax=vlmax)
    elif accumulator == "hash":
        trace_hash(a, b, pre, c_nnz=cn, trace=t, vlmax=vlmax)
    else:
        raise ValueError(accumulator)
    return t


def trace_preprocess(a: CSC, b: CSC, *, vlmax: int = VL_MAX) -> Trace:
    """Sorting pre-process cost (reported separately, as the paper does)."""
    t = Trace()
    nnz_b = b.nnz
    n = b.n_cols
    chunks = -(-max(nnz_b, 1) // vlmax)
    t.add("vload_idx", vlmax, count=chunks, ws=a.n_cols * BYTES_I)  # Z_A gather
    t.add("valu", vlmax, count=2 * chunks)                          # seg-sum
    # sort: model as radix over Op values (few rounds) on n elements
    sort_chunks = -(-n // vlmax)
    t.add("valu", vlmax, count=10 * sort_chunks)
    t.add("vload_idx", vlmax, count=6 * sort_chunks, ws=n * BYTES_I)
    t.add("vstore_idx", vlmax, count=6 * sort_chunks, ws=n * BYTES_I)
    t.add("scalar", 1, count=2 * n)
    return t


# ---------------------------------------------------------------------------
# beyond the paper: lane refill (work stealing)
# ---------------------------------------------------------------------------


def _ws_makespan(ops_blk: np.ndarray, L: int) -> tuple[int, float, int]:
    """(steps, mean active lanes, refills) under lane refill.

    Columns (sorted by decreasing load) are claimed by the earliest-free
    lane; the block retires when the last lane drains. Classic list
    scheduling: makespan <= P/L + max_op.
    """
    import heapq

    if len(ops_blk) == 0:
        return 0, 0.0, 0
    lanes = [0] * min(L, len(ops_blk))
    heapq.heapify(lanes)
    for op in ops_blk:
        t0 = heapq.heappop(lanes)
        heapq.heappush(lanes, t0 + int(op))
    steps = max(lanes)
    total = int(ops_blk.sum())
    mean_active = total / max(steps, 1)
    return steps, mean_active, len(ops_blk)


def trace_spars_ws(
    a: CSC, b: CSC, pre: Preprocess, *, c_nnz: np.ndarray | None = None,
    trace: Trace | None = None, vlmax: int = VL_MAX,
) -> Trace:
    """SPARS with lane refill (work-stealing): masked-idle steps removed,
    plus per-refill cursor-reload cost. Value-level twin:
    core.naive.spars_ws_numpy (oracle-tested)."""
    t = trace if trace is not None else Trace()
    m = a.n_rows
    nnz_a = a.nnz
    b_cp = _np(b.col_ptr).astype(np.int64)
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz

    for start, size in pre.blocks:
        cols = pre.perm[start : start + size]
        L = int(size)
        ops_blk = pre.ops_sorted[start : start + size]
        steps, mean_active, refills = _ws_makespan(ops_blk, L)
        if steps == 0:
            t.add("scalar", 1, count=8)
            continue
        span = (b_cp[cols + 1].max() - b_cp[cols].min()) * BYTES_V
        ws = {
            "b_span": float(span), "a_colptr": a.n_cols * BYTES_I,
            "a_vals": nnz_a * BYTES_V, "a_rows": nnz_a * BYTES_I,
            "acc_vals": m * L * BYTES_V, "acc_flags": m * L * BYTES_F,
            "acc_idx": m * L * BYTES_I,
        }
        for kind, mult, wkey in _SPARS_STEP_MIX:
            t.add(kind, L, count=steps * mult, ws=ws.get(wkey, 0),
                  active=mean_active)
        # refill overhead: cursor reload + queue pop per column claim
        t.add("valu", L, count=2 * max(steps // max(L, 1), 1))
        t.add("scalar", 1, count=3 * refills + 20)
        _blocked_output(t, cn[cols], L, m * L * BYTES_V, vlmax=vlmax)
    return t


def trace_hash_ws(
    a: CSC, b: CSC, pre: Preprocess, *, c_nnz: np.ndarray | None = None,
    trace: Trace | None = None, vlmax: int = VL_MAX,
    prod_rows: np.ndarray | None = None, prod_cp: np.ndarray | None = None,
) -> Trace:
    """HASH with lane refill."""
    t = trace if trace is not None else Trace()
    nnz_a = a.nnz
    b_cp = _np(b.col_ptr).astype(np.int64)
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz
    if prod_rows is None:
        prod_rows, prod_cp = expanded_rows(a, b)

    for bi, (start, size) in enumerate(pre.blocks):
        cols = pre.perm[start : start + size]
        L = int(size)
        ops_blk = pre.ops_sorted[start : start + size]
        steps, mean_active, refills = _ws_makespan(ops_blk, L)
        if steps == 0:
            t.add("scalar", 1, count=8)
            continue
        H = int(pre.hash_sizes[bi])
        span = (b_cp[cols + 1].max() - b_cp[cols].min()) * BYTES_V
        ws = {
            "b_span": float(span), "a_colptr": a.n_cols * BYTES_I,
            "a_vals": nnz_a * BYTES_V, "a_rows": nnz_a * BYTES_I,
            "tab_keys": H * L * BYTES_I, "tab_vals": H * L * BYTES_V,
        }
        for kind, mult, wkey in _HASH_STEP_MIX:
            t.add(kind, L, count=steps * mult, ws=ws.get(wkey, 0),
                  active=mean_active)
        # probe stalls: per-column displacements as in trace_hash; under
        # refill the per-step max is over a denser lane set — model with the
        # same per-product displacement stream averaged into steps
        stall_total = 0
        for col in cols:
            seg = prod_rows[prod_cp[col] : prod_cp[col + 1]]
            if len(seg):
                stall_total += int(
                    _column_displacements(seg, H).sum())
        n_stall = int(stall_total / max(L, 1))
        if n_stall:
            t.add("vload_idx", L, count=n_stall, ws=H * L * BYTES_I)
            t.add("valu", L, count=2 * n_stall)
        t.add("valu", L, count=2 * max(steps // max(L, 1), 1))
        t.add("scalar", 1, count=3 * refills + 20)
        scan_chunks = max(1, -(-H * L // vlmax))
        t.add("vload", vlmax, count=2 * scan_chunks)
        t.add("valu", vlmax, count=scan_chunks)
        _chunk(t, "vstore", cn[cols], per=2, vlmax=vlmax)
        t.add("vstore", vlmax, count=2 * scan_chunks)
        t.add("scalar", 1, count=6 * len(cols))
    return t


def trace_hybrid_ws(
    a: CSC, b: CSC, pre: Preprocess, accumulator: str = "hash", *,
    c_nnz: np.ndarray | None = None, vlmax: int = VL_MAX,
) -> Trace:
    cn = c_column_nnz(a, b) if c_nnz is None else c_nnz
    t = Trace()
    head = pre.perm[: pre.split]
    trace_spa(a, b, columns=head, c_nnz=cn, trace=t, vlmax=vlmax)
    if accumulator == "spa":
        trace_spars_ws(a, b, pre, c_nnz=cn, trace=t, vlmax=vlmax)
    else:
        trace_hash_ws(a, b, pre, c_nnz=cn, trace=t, vlmax=vlmax)
    return t
