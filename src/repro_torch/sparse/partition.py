"""2-D tile partition, merge and stitch of a tiled SpGEMM (the port's copy
of the JAX package's ``repro/sparse/partition.py``).

The tiled multiply decomposes ``C = A @ B`` into a grid of outer-block
products: A is sliced into column blocks ``A[:, k0:k1]``, B into matching
row blocks crossed with column blocks ``B[k0:k1, j0:j1]``, so

    C[:, j0:j1] = sum_k  A[:, k0:k1] @ B[k0:k1, j0:j1]

Each tile product is an ordinary, smaller SpGEMM run by its own cached
plan.  This module holds the pattern-level plumbing around it: slicing CSC
operands along either axis (with the value-gather metadata a plan needs to
re-slice new values), summing the per-k partial products, and stitching
column blocks back into one CSC.

Slicing and :func:`merge_csc_partials` / :func:`csc_hstack` are host numpy,
as in the JAX package: the host backend's grids merge with them.  The
device grids merge where their tiles ran, with torch ops
(:func:`merge_and_stitch_device`), in the same order: each element adds its
partials from ``+0.0``, k ascending, and a column block with a single
partial passes through untouched.  So a grid with one row block is
bit-identical per column to the untiled method, and the card's merge equals
the host's bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.sparse.format import CSC, _np, as_tensor

# auto grid sizing (spgemm(method="auto", tile=None)): target nnz per B
# column block / per A column block.  The n-axis target is small enough that
# a mixed-density matrix splits into blocks the cost model can specialize;
# the k-axis target is much larger because row splits cost a merge pass and
# re-associate floating-point sums.
DEFAULT_TILE_NNZ = 16_384
DEFAULT_KSPLIT_NNZ = 262_144


# ---------------------------------------------------------------------------
# grid boundaries
# ---------------------------------------------------------------------------


def width_col_bounds(n_cols: int, width: int) -> np.ndarray:
    """Even-width column-block boundaries: [0, w, 2w, ..., n_cols].

    A width >= n_cols (or a degenerate 0-column axis) yields a single block.
    """
    if width < 1:
        raise ValueError(f"tile width must be >= 1, got {width}")
    if n_cols <= 0:
        return np.asarray([0], np.int64)
    return np.concatenate(
        (np.arange(0, n_cols, width, dtype=np.int64), [n_cols]))


def nnz_balanced_col_bounds(m: CSC, n_blocks: int) -> np.ndarray:
    """Column-block boundaries that roughly equalize nnz per block.

    Cuts sit at the nnz quantiles of ``col_ptr``; duplicate cuts collapse,
    so the result may have fewer than ``n_blocks`` blocks (always at least
    one for a non-empty axis).
    """
    n = m.n_cols
    if n <= 0:
        return np.asarray([0], np.int64)
    n_blocks = max(1, min(int(n_blocks), n))
    cp = _np(m.col_ptr).astype(np.int64)
    targets = np.linspace(0, cp[-1], n_blocks + 1)[1:-1]
    cuts = np.clip(np.searchsorted(cp, targets, side="left"), 1, n - 1) \
        if n > 1 else np.zeros(0, np.int64)
    return np.unique(np.concatenate(([0], cuts, [n]))).astype(np.int64)


def auto_tile_grid(a: CSC, b: CSC, *, n_target: int | None = None,
                   k_target: int | None = None) -> tuple:
    """(k_blocks, n_blocks) sized from operand nnz.

    Small operands get a 1x1 grid (tiling then degenerates to the untiled
    path, bit for bit); the n axis splits once B carries more than
    ``n_target`` stored values, the k axis only for much larger A.
    Targets left as ``None`` are the machine profile's tuned
    ``tile_n_target``/``tile_k_target`` (``core.profile``), else the module
    defaults.
    """
    if n_target is None or k_target is None:
        from repro_torch.core import profile

        tuning = profile.current_profile().tuning
        if n_target is None:
            n_target = int(tuning.get("tile_n_target", DEFAULT_TILE_NNZ))
        if k_target is None:
            k_target = int(tuning.get("tile_k_target", DEFAULT_KSPLIT_NNZ))
    n_target, k_target = int(n_target), int(k_target)
    k_blocks = max(1, -(-a.nnz // k_target)) if a.n_cols else 1
    n_blocks = max(1, -(-b.nnz // n_target)) if b.n_cols else 1
    return min(k_blocks, max(a.n_cols, 1)), min(n_blocks, max(b.n_cols, 1))


# ---------------------------------------------------------------------------
# slicing (pattern + value-gather metadata)
# ---------------------------------------------------------------------------


def csc_col_slice(m: CSC, j0: int, j1: int):
    """Columns [j0, j1) as a CSC, plus the (lo, hi) value range it occupies.

    The slice's values are the contiguous range ``[lo, hi)`` of the parent's
    value storage, so a cached tile plan binds fresh values with one slice.
    """
    if not (0 <= j0 <= j1 <= m.n_cols):
        raise ValueError(f"column slice [{j0}, {j1}) out of range "
                         f"for {m.n_cols} columns")
    cp = _np(m.col_ptr).astype(np.int64)
    lo, hi = int(cp[j0]), int(cp[j1])
    out = CSC(
        as_tensor(_np(m.values)[lo:hi]),
        _np(m.row_indices)[lo:hi],
        (cp[j0:j1 + 1] - lo).astype(np.int32),
        (m.n_rows, j1 - j0),
    )
    return out, (lo, hi)


def csc_row_slice(m: CSC, i0: int, i1: int):
    """Rows [i0, i1) as a CSC of shape (i1-i0, n_cols), plus the gather.

    The second return value is the index array of the kept entries in the
    parent's value storage: pattern-only, so it re-slices any value set
    with the parent's sparsity pattern (``new_vals[idx]``).
    """
    if not (0 <= i0 <= i1 <= m.n_rows):
        raise ValueError(f"row slice [{i0}, {i1}) out of range "
                         f"for {m.n_rows} rows")
    cp = _np(m.col_ptr).astype(np.int64)
    nnz = int(cp[-1])
    rows = _np(m.row_indices)[:nnz]
    keep = (rows >= i0) & (rows < i1)
    idx = np.nonzero(keep)[0]
    col_of = np.repeat(np.arange(m.n_cols, dtype=np.int64), np.diff(cp))
    counts = np.bincount(col_of[idx], minlength=m.n_cols)
    col_ptr = np.zeros(m.n_cols + 1, np.int32)
    np.cumsum(counts, out=col_ptr[1:])
    out = CSC(
        as_tensor(_np(m.values)[:nnz][idx]),
        (rows[idx] - i0).astype(np.int32),
        col_ptr,
        (i1 - i0, m.n_cols),
    )
    return out, idx


# ---------------------------------------------------------------------------
# stitch / merge on the host (numpy, as in the JAX package)
# ---------------------------------------------------------------------------


def csc_empty(shape, dtype=np.float64) -> CSC:
    """All-zero CSC of the given shape (host numpy structure)."""
    return CSC(as_tensor(np.zeros(0, dtype)), np.zeros(0, np.int32),
               np.zeros(shape[1] + 1, np.int32), tuple(shape))


def csc_hstack(parts, n_rows: int) -> CSC:
    """Concatenate column blocks left-to-right into one CSC.

    Inverse of slicing with :func:`csc_col_slice` along a boundary list:
    stitching the slices back reproduces the parent bit for bit.
    """
    parts = list(parts)
    if not parts:
        raise ValueError("need at least one column block")
    if any(p.n_rows != n_rows for p in parts):
        raise ValueError("column blocks disagree on the row dimension")
    dtype = np.result_type(*[_np(p.values).dtype for p in parts])
    vals, rows, cps = [], [], [np.zeros(1, np.int64)]
    offset = 0
    for p in parts:
        nnz = p.nnz
        vals.append(_np(p.values)[:nnz])
        rows.append(_np(p.row_indices)[:nnz])
        cps.append(_np(p.col_ptr).astype(np.int64)[1:] + offset)
        offset += nnz
    n_cols = sum(p.n_cols for p in parts)
    return CSC(
        as_tensor(np.concatenate(vals).astype(dtype, copy=False) if offset
                  else np.zeros(0, dtype)),
        np.concatenate(rows).astype(np.int32) if offset
        else np.zeros(0, np.int32),
        np.concatenate(cps).astype(np.int32),
        (n_rows, n_cols),
    )


def merge_csc_partials(parts, shape, dtype=None) -> CSC:
    """Sum same-shape partial products C = sum_k parts[k] into one CSC.

    Each part is one row block's contribution ``A[:, k] @ B[k, :]``.  Output
    columns are canonical (rows strictly ascending); each element adds its
    per-part contributions from ``+0.0`` in the given (k-ascending) order.
    Entries that cancel to exactly 0.0 across parts stay explicit, so the
    output pattern does not depend on the values.

    A single part is returned unchanged (bit-identical passthrough), which
    is what makes single-row-block grids reproduce untiled results exactly.
    """
    parts = [p for p in parts]
    if not parts:
        return csc_empty(shape, dtype or np.float64)
    if any(tuple(p.shape) != tuple(shape) for p in parts):
        raise ValueError(
            f"partial shapes {[p.shape for p in parts]} != merged {shape}")
    if len(parts) == 1:
        return parts[0]
    m, n = shape
    dtype = dtype or np.result_type(*[_np(p.values).dtype for p in parts])
    all_rows, all_cols, all_vals, all_k = [], [], [], []
    for k, p in enumerate(parts):
        nnz = p.nnz
        if nnz == 0:
            continue
        cp = _np(p.col_ptr).astype(np.int64)
        all_rows.append(_np(p.row_indices)[:nnz].astype(np.int64))
        all_cols.append(np.repeat(np.arange(n, dtype=np.int64), np.diff(cp)))
        all_vals.append(_np(p.values)[:nnz])
        all_k.append(np.full(nnz, k, np.int64))
    if not all_rows:
        return csc_empty(shape, dtype)
    rows = np.concatenate(all_rows)
    cols = np.concatenate(all_cols)
    vals = np.concatenate(all_vals).astype(dtype, copy=False)
    ktag = np.concatenate(all_k)
    # sort by (col, row, k): equal (col, row) runs are contiguous with parts
    # in k order, so the unbuffered add accumulates each element k-ascending
    order = np.lexsort((ktag, rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    key = cols * m + rows
    boundary = np.empty(len(key), bool)
    boundary[0] = True
    boundary[1:] = key[1:] != key[:-1]
    seg = np.cumsum(boundary) - 1
    sums = np.zeros(int(seg[-1]) + 1, dtype)
    np.add.at(sums, seg, vals)
    u_rows = rows[boundary].astype(np.int32)
    u_cols = cols[boundary]
    col_ptr = np.zeros(n + 1, np.int32)
    np.add.at(col_ptr[1:], u_cols, 1)
    np.cumsum(col_ptr, out=col_ptr)
    return CSC(as_tensor(sums), u_rows, col_ptr, (m, n))


# ---------------------------------------------------------------------------
# merge + stitch on the device (torch ops, the host merge's order)
# ---------------------------------------------------------------------------


def _tensor(x, dtype, dev) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


def merge_and_stitch_device(per_block, n_bounds, m: int, dev,
                            stats: dict | None = None) -> CSC:
    """C from the partial products of a device tile grid, on ``dev``.

    ``per_block[ni]`` lists the partials of column block ``ni`` (columns
    ``n_bounds[ni] .. n_bounds[ni+1]``), k ascending; each partial is a CSC
    on ``dev`` whose values hold exactly its nnz entries (what the port's
    device executors return).  A block with one partial passes through
    untouched; a block with none is empty; the blocks with several are
    summed together, as :func:`merge_csc_partials` sums each:

    - one int64 key ``(col * m + row) * K + k`` per entry (``col`` global,
      ``k`` the partial's place in its block's list, ``K`` the longest
      list), unique, so one sort fixes the order;
    - the entries of each output element form a run; a ``[n_out, K]`` array
      holds each run's partials in their k slot and ``+0.0`` where a run
      lacks one, and a loop over the K slots adds them into a ``+0.0``
      accumulator.  The accumulator is never ``-0.0``, so the ``+0.0``
      slots change no bit: each element equals the host's ``np.add.at``.

    No atomics and no segmented sum of a library: the result is bit-stable
    run to run.  The merged elements' count is read back once, for all
    merged blocks together (``stats["merge_syncs"]`` is 1, or 0 when no
    block has several partials); the stitch concatenates on ``dev``.
    Results are f32, the device paths' value type.
    """
    n_blocks = len(n_bounds) - 1
    if n_blocks == 0:
        if stats is not None:
            stats["merge_syncs"] = 0
        return CSC(torch.zeros(0, dtype=torch.float32, device=dev),
                   torch.zeros(0, dtype=torch.int32, device=dev),
                   torch.zeros(1, dtype=torch.int32, device=dev), (m, 0))
    merged = [ni for ni in range(n_blocks) if len(per_block[ni]) > 1]
    pieces, syncs = _merge_blocks(per_block, merged, n_bounds, m, dev)
    if stats is not None:
        stats["merge_syncs"] = syncs
    if n_blocks == 1 and len(per_block[0]) == 1:
        return per_block[0][0]
    vals, rows, cps = [], [], [torch.zeros(1, dtype=torch.int64, device=dev)]
    offset = 0
    for ni in range(n_blocks):
        width = int(n_bounds[ni + 1] - n_bounds[ni])
        parts = per_block[ni]
        if len(parts) == 1:
            p = parts[0]
            nnz = int(p.values.shape[0])
            piece = (p.values, _tensor(p.row_indices, torch.int32, dev),
                     _tensor(p.col_ptr, torch.int64, dev), nnz)
        elif not parts:
            piece = _empty_piece(width, dev)
        else:
            piece = pieces[ni]
        v, r, cp, nnz = piece
        vals.append(v.to(torch.float32))
        rows.append(r[:nnz])
        cps.append(cp[1:] + offset)
        offset += nnz
    return CSC(torch.cat(vals), torch.cat(rows),
               torch.cat(cps).to(torch.int32), (m, int(n_bounds[-1])))


def _merge_blocks(per_block, merged, n_bounds, m, dev) -> tuple:
    """The summed partials of the blocks ``merged`` (each with at least two
    partials): ``({ni: (values, rows, local col_ptr [w + 1], nnz)}, host
    syncs)``.  Every step is a sort, a scan, a search or a gather or scatter
    to distinct places: no atomics."""
    if not merged:
        return {}, 0
    k_slots = max(len(per_block[ni]) for ni in merged)
    keys, vals, entries = [], [], []
    for ni in merged:
        j0 = int(n_bounds[ni])
        width = int(n_bounds[ni + 1]) - j0
        entries.append(sum(int(p.values.shape[0]) for p in per_block[ni]))
        for k, p in enumerate(per_block[ni]):
            nnz = int(p.values.shape[0])
            if nnz == 0:
                continue
            cp = _tensor(p.col_ptr, torch.int64, dev)
            col = torch.repeat_interleave(
                torch.arange(j0, j0 + width, device=dev), cp.diff(),
                output_size=nnz)
            row = _tensor(p.row_indices, torch.int64, dev)[:nnz]
            keys.append((col * m + row) * k_slots + k)
            vals.append(p.values.to(torch.float32))
    if not keys:
        return {ni: _empty_piece(int(n_bounds[ni + 1] - n_bounds[ni]), dev)
                for ni in merged}, 0
    key, order = torch.sort(torch.cat(keys))
    val = torch.cat(vals)[order]
    elem = key // k_slots            # (col, row) of each entry
    slot = key % k_slots             # its partial's place in the block's list
    boundary = torch.ones_like(elem, dtype=torch.bool)
    boundary[1:] = elem[1:] != elem[:-1]
    # runs begun before each merged block's first entry, and in all: the
    # blocks are column ranges in ascending order, so their entries follow
    # one another in the sorted order, as many as the host counted
    runs = torch.zeros(len(key) + 1, dtype=torch.int64, device=dev)
    torch.cumsum(boundary, 0, out=runs[1:])
    starts = np.concatenate(([0], np.cumsum(entries))).tolist()
    runs_at = torch.stack([runs[i] for i in starts])
    counts = runs_at.diff().tolist()    # the merge's one host sync
    n_out = int(sum(counts))
    seg = runs[1:] - 1                  # the run of each entry
    padded = torch.zeros((n_out, k_slots), dtype=torch.float32, device=dev)
    padded[seg, slot] = val             # (run, slot) pairs are unique
    acc = torch.zeros(n_out, dtype=torch.float32, device=dev)
    for k in range(k_slots):
        acc = acc + padded[:, k]
    u = elem[torch.searchsorted(seg, torch.arange(n_out, device=dev))]
    u_col, u_row = u // m, (u % m).to(torch.int32)
    out, start = {}, 0
    for ni, nnz in zip(merged, counts):
        j0, j1 = int(n_bounds[ni]), int(n_bounds[ni + 1])
        if nnz:
            sl = slice(start, start + nnz)
            cp = torch.searchsorted(
                u_col[sl], torch.arange(j0, j1 + 1, device=dev))
            out[ni] = (acc[sl], u_row[sl], cp, nnz)
        else:
            out[ni] = _empty_piece(j1 - j0, dev)
        start += nnz
    return out, 1


def _empty_piece(width: int, dev) -> tuple:
    return (torch.zeros(0, dtype=torch.float32, device=dev),
            torch.zeros(0, dtype=torch.int32, device=dev),
            torch.zeros(width + 1, dtype=torch.int64, device=dev), 0)
