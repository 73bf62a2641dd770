"""Sparse matrix containers (CSC, as in the paper) for the PyTorch port.

Design notes
------------
* ``CSC`` keeps its *structure* (``row_indices``, ``col_ptr``) where planning
  can read it cheaply — numpy arrays for operands built on the host — and its
  ``values`` as a torch tensor.  Results assembled on the card by
  :class:`CSCBuilder` hold all three as tensors on that device; ``_np`` reads
  either kind back as numpy for planning and tests.
* Planning is numpy on the host, exactly as in the JAX package: the padded
  column layout (:func:`csc_pad_gather`) is pattern-only, and
  :func:`padded_values` turns any value vector with that pattern into the
  padded view with one torch gather on the values' device.
* :class:`CSCBuilder` compacts the kernels' per-group outputs (dense
  accumulator tiles, per-lane hash tables) on the device with torch ops; no
  tile is copied to the host, and one execution reads one number back (the
  result's nnz).
* :class:`BatchedCSC` holds B value sets of one pattern (values ``[B,
  nnz]``); :func:`padded_values_batched` pads all of them with one gather,
  and :class:`BatchedCSCBuilder` compacts batched tiles into B results, each
  with its own structure, reading all B nnz in one host sync.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple, Union

import numpy as np
import torch

Structure = Union[np.ndarray, torch.Tensor]


def _np(x) -> np.ndarray:
    """Host numpy view of a structure array (numpy or torch, any device)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_tensor(values) -> torch.Tensor:
    """Values as a torch tensor (numpy arrays are wrapped, not copied)."""
    if isinstance(values, torch.Tensor):
        return values
    return torch.from_numpy(np.ascontiguousarray(values))


@dataclasses.dataclass(frozen=True)
class CSC:
    """Compressed Sparse Column matrix.

    values[p]       value of the p-th stored element (torch tensor)
    row_indices[p]  its row
    col_ptr[j]      offset of the first stored element of column j; col_ptr[n] = nnz
    shape           (n_rows, n_cols)
    """

    values: torch.Tensor
    row_indices: Structure
    col_ptr: Structure
    shape: Tuple[int, int]

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.col_ptr[-1])

    @property
    def capacity(self) -> int:
        return int(self.values.shape[0])

    @property
    def device(self) -> torch.device:
        return self.values.device

    def to(self, device) -> "CSC":
        """This matrix with its values (and any tensor structure) on ``device``."""
        return CSC(self.values.to(device), _move(self.row_indices, device),
                   _move(self.col_ptr, device), self.shape)

    def column(self, j: int):
        """Host numpy (rows, vals) of column j."""
        cp = _np(self.col_ptr)
        lo, hi = int(cp[j]), int(cp[j + 1])
        return _np(self.row_indices)[lo:hi], _np(self.values)[lo:hi]


def _move(x, device):
    """A structure array on ``device`` (host numpy stays where it is)."""
    return x.to(device) if isinstance(x, torch.Tensor) else x


@dataclasses.dataclass(frozen=True)
class BatchedCSC:
    """B same-pattern CSC matrices: one structure, stacked values.

    values[b, p]    value of the p-th stored element in batch element b
                    (torch tensor ``[B, capacity]``)
    row_indices[p]  its row (shared by every batch element)
    col_ptr[j]      shared column offsets; col_ptr[n] = nnz
    shape           (n_rows, n_cols) of each element

    The operand of the batched path: the plan is built once for the shared
    pattern and all B value sets run through one set of kernel launches.
    A plain frozen dataclass, as :class:`CSC` is.
    """

    values: torch.Tensor
    row_indices: Structure
    col_ptr: Structure
    shape: Tuple[int, int]

    @property
    def batch(self) -> int:
        return int(self.values.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_cols(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        return int(self.col_ptr[-1])

    @property
    def device(self) -> torch.device:
        return self.values.device

    @classmethod
    def stack(cls, mats) -> "BatchedCSC":
        """Stack same-pattern CSC matrices (structure verified, O(nnz))."""
        mats = list(mats)
        if not mats:
            raise ValueError("need at least one matrix to stack")
        head = mats[0]
        nnz = head.nnz
        cp = _np(head.col_ptr)
        ri = _np(head.row_indices)[:nnz]
        for m in mats[1:]:
            if (tuple(m.shape) != tuple(head.shape)
                    or not np.array_equal(_np(m.col_ptr), cp)
                    or not np.array_equal(_np(m.row_indices)[: m.nnz], ri)):
                raise ValueError(
                    "cannot stack: sparsity patterns differ (BatchedCSC "
                    "requires one shared pattern)")
        vals = torch.stack([as_tensor(m.values)[:nnz] for m in mats])
        return cls(vals, ri.astype(np.int32), cp.astype(np.int32),
                   tuple(head.shape))

    @classmethod
    def from_values(cls, pattern: CSC, values) -> "BatchedCSC":
        """Bind a ``[B, nnz]`` value stack to an existing pattern."""
        v = as_tensor(values)
        if v.dim() != 2 or v.shape[0] < 1 or v.shape[1] < pattern.nnz:
            raise ValueError(
                f"values must be [B >= 1, >= {pattern.nnz}], got "
                f"{tuple(v.shape)}")
        return cls(v, pattern.row_indices, pattern.col_ptr,
                   tuple(pattern.shape))

    def element(self, b: int) -> CSC:
        """The b-th matrix as a plain CSC (structure arrays shared)."""
        return CSC(self.values[b], self.row_indices, self.col_ptr,
                   self.shape)

    def __getitem__(self, b: int) -> CSC:
        return self.element(b)

    def unstack(self) -> list:
        return [self.element(b) for b in range(self.batch)]

    def to(self, device) -> "BatchedCSC":
        """This stack with its values (and any tensor structure) on
        ``device``."""
        return BatchedCSC(self.values.to(device),
                          _move(self.row_indices, device),
                          _move(self.col_ptr, device), self.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed Sparse Row matrix (the transpose-dual of CSC): host numpy
    structure, torch values, as :class:`CSC`."""

    values: torch.Tensor
    col_indices: Structure
    row_ptr: Structure
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.row_ptr[-1])


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate format (row, col, value triplets): host numpy rows and
    columns, torch values."""

    rows: Structure
    cols: Structure
    values: torch.Tensor
    shape: Tuple[int, int]

    @property
    def nnz(self) -> int:
        return int(self.values.shape[0])


def csc_from_numpy(values, row_indices, col_ptr, shape) -> CSC:
    """CSC from host arrays: numpy structure, torch values (no copy)."""
    return CSC(as_tensor(values), np.asarray(row_indices, np.int32),
               np.asarray(col_ptr, np.int32), tuple(int(s) for s in shape))


def csc_from_dense(dense, tol: float = 0.0) -> CSC:
    """CSC of the entries with |v| > tol, rows ascending in each column."""
    d = _np(dense)
    n_rows, n_cols = d.shape
    mask = np.abs(d) > tol
    col_ptr = np.zeros(n_cols + 1, np.int32)
    np.cumsum(mask.sum(axis=0), out=col_ptr[1:])
    cols, rows = np.nonzero(mask.T)          # column-major: rows ascending
    return csc_from_numpy(d[rows, cols], rows.astype(np.int32), col_ptr,
                          (n_rows, n_cols))


def csc_to_dense(m: CSC) -> torch.Tensor:
    """Dense [n_rows, n_cols] tensor on the values' device; duplicate row
    entries within a column accumulate (general CSC semantics)."""
    nnz = m.nnz
    dev = m.values.device
    rows = torch.as_tensor(_np(m.row_indices)[:nnz].astype(np.int64),
                           device=dev)
    cols = torch.as_tensor(
        np.repeat(np.arange(m.n_cols), np.diff(_np(m.col_ptr))),
        dtype=torch.int64, device=dev)
    out = torch.zeros(m.shape, dtype=m.values.dtype, device=dev)
    return out.index_put_((rows, cols), m.values[:nnz], accumulate=True)


def csc_from_coo(coo: COO, sum_duplicates: bool = True) -> CSC:
    """CSC of a COO, rows ascending in each column; with
    ``sum_duplicates`` the entries of one (row, col) are added in their
    COO order (``np.add.at``, host numpy, as in the JAX package)."""
    rows = _np(coo.rows).astype(np.int64)
    cols = _np(coo.cols).astype(np.int64)
    vals = _np(coo.values)
    n_rows, n_cols = coo.shape
    order = np.lexsort((rows, cols))
    rows, cols, vals = rows[order], cols[order], vals[order]
    if sum_duplicates and len(rows):
        key = cols * n_rows + rows
        uniq, inv = np.unique(key, return_inverse=True)
        acc = np.zeros(len(uniq), vals.dtype)
        np.add.at(acc, inv, vals)
        cols = uniq // n_rows
        rows = uniq % n_rows
        vals = acc
    col_ptr = np.zeros(n_cols + 1, np.int32)
    np.add.at(col_ptr[1:], cols, 1)
    np.cumsum(col_ptr, out=col_ptr)
    return csc_from_numpy(vals, rows.astype(np.int32), col_ptr,
                          (n_rows, n_cols))


def csc_to_csr(m: CSC) -> CSR:
    """The same matrix in CSR, columns ascending in each row."""
    vals = _np(m.values)[: m.nnz]
    rows = _np(m.row_indices)[: m.nnz]
    cp = _np(m.col_ptr)
    cols = np.repeat(np.arange(m.n_cols, dtype=np.int32), np.diff(cp))
    order = np.lexsort((cols, rows))
    row_ptr = np.zeros(m.n_rows + 1, np.int32)
    np.add.at(row_ptr[1:], rows, 1)
    np.cumsum(row_ptr, out=row_ptr)
    return CSR(as_tensor(vals[order]), cols[order], row_ptr,
               tuple(m.shape))


def csr_to_csc(m: CSR) -> CSC:
    """The same matrix in CSC, rows ascending in each column."""
    vals = _np(m.values)[: m.nnz]
    cols = _np(m.col_indices)[: m.nnz]
    rp = _np(m.row_ptr)
    rows = np.repeat(np.arange(m.shape[0], dtype=np.int32), np.diff(rp))
    order = np.lexsort((rows, cols))
    col_ptr = np.zeros(m.shape[1] + 1, np.int32)
    np.add.at(col_ptr[1:], cols, 1)
    np.cumsum(col_ptr, out=col_ptr)
    return csc_from_numpy(vals[order], rows[order], col_ptr, m.shape)


def transpose_csc(m: CSC) -> CSC:
    """C^T in CSC: C in CSR read as CSC."""
    r = csc_to_csr(m)
    return CSC(r.values, r.col_indices, r.row_ptr, (m.shape[1], m.shape[0]))


def segment_reduce(values, seg_starts, axis: int = -1) -> np.ndarray:
    """Per-segment sums of host numpy ``values`` along ``axis``: segment
    ``i`` spans ``[seg_starts[i], seg_starts[i+1])``, the last to the end.

    ``np.add.reduceat``, as in the JAX package's host stream engine (its
    2-D ``axis=1`` form equals the 1-D one row by row), with the empty
    segment list handled (reduceat rejects it).
    """
    v = np.asarray(values)
    if len(seg_starts) == 0:
        shape = list(v.shape)
        shape[axis] = 0
        return np.zeros(shape, v.dtype)
    return np.add.reduceat(v, seg_starts, axis=axis)


def csc_pad_gather(m: CSC, pad_to: int | None = None):
    """Pattern-only padded-column layout (the symbolic half of padding).

    Returns ``(rows [n_cols, Z] int32, gather [n_cols, Z] int64,
    mask [n_cols, Z] bool, nnz [n_cols] int32)`` as numpy arrays.
    ``gather``/``mask`` turn any values vector with this sparsity pattern
    into its padded rectangular view via :func:`padded_values`.  Padding
    slots hold row 0 (and value 0 once gathered).
    """
    cp = _np(m.col_ptr)
    nnz_col = np.diff(cp).astype(np.int32)
    width = int(nnz_col.max()) if len(nnz_col) and nnz_col.max() > 0 else 1
    if pad_to is not None:
        if pad_to < width:
            raise ValueError(f"pad_to={pad_to} < max column nnz {width}")
        width = pad_to
    z = np.arange(width)
    mask = z[None, :] < nnz_col[:, None]
    gather = np.where(mask, cp[:-1, None].astype(np.int64) + z[None, :], 0)
    rr = _np(m.row_indices)
    if rr.size:
        rows = np.where(mask, rr[gather], 0).astype(np.int32)
    else:
        rows = np.zeros(gather.shape, np.int32)
    return rows, gather, mask, nnz_col


def padded_values(values: torch.Tensor, gather: torch.Tensor,
                  mask: torch.Tensor) -> torch.Tensor:
    """Numeric half of padding: values -> padded [n_cols, Z] (zeros in pads).

    One gather on the device ``gather``/``mask`` live on; ``values`` must be
    there too.
    """
    if values.numel() == 0:
        return torch.zeros(gather.shape, dtype=values.dtype,
                           device=gather.device)
    return torch.where(mask, values[gather], 0)


def padded_values_batched(values: torch.Tensor, gather: torch.Tensor,
                          mask: torch.Tensor) -> torch.Tensor:
    """Batched :func:`padded_values`: ``[B, nnz] -> [B, n_cols, Z]`` in one
    gather; row b equals ``padded_values(values[b], gather, mask)``."""
    if values.dim() != 2:
        raise ValueError(
            f"expected [B, nnz] values, got shape {tuple(values.shape)}")
    if values.shape[1] == 0:
        return torch.zeros((values.shape[0],) + tuple(gather.shape),
                           dtype=values.dtype, device=gather.device)
    return torch.where(mask, values[:, gather], 0)


def csc_to_padded_columns(m: CSC, pad_to: int | None = None):
    """Ragged->rectangular view for lock-step kernels, as tensors on the
    values' device: (rows [n_cols, Z] int32, vals [n_cols, Z], nnz [n_cols]
    int32).  Padding slots have row 0 and value 0."""
    rows, gather, mask, nnz_col = csc_pad_gather(m, pad_to)
    dev = m.values.device
    vals = padded_values(m.values, torch.as_tensor(gather, device=dev),
                         torch.as_tensor(mask, device=dev))
    return (torch.as_tensor(rows, device=dev), vals,
            torch.as_tensor(nnz_col, device=dev))


@dataclasses.dataclass(frozen=True)
class ColumnSlots:
    """Staging slots for a result's columns: column j's entries go to
    ``start[j] .. start[j+1]``.  ``start`` lives on the device, ``total``
    (= ``start[-1]``) on the host, so writing into the slots needs no sync.
    ``spare`` slots past the end take the discarded cells of one tile, each
    its own: cells stored to one address would queue behind each other.
    """

    start: torch.Tensor   # [n + 1] int64 (device)
    total: int
    spare: int            # cells of the largest tile

    @classmethod
    def of(cls, capacity, spare: int, device) -> "ColumnSlots":
        """Slots for at most ``capacity[j]`` entries in column j, for tiles
        of at most ``spare`` cells."""
        start = np.zeros(len(capacity) + 1, np.int64)
        np.cumsum(capacity, out=start[1:])
        return cls(torch.as_tensor(start, device=device), int(start[-1]),
                   int(spare))


class BatchedCSCBuilder:
    """Column-sliced assembly of B CSC results from batched kernel outputs,
    on the device.

    The executor produces results group by group — dense ``[B, m, L]``
    accumulator tiles (SPA/SPARS) or ``[B, H, L]`` hash tables (HASH), one
    launch for all B value sets.  Each group is compacted where it lies,
    with torch ops and no host sync: every element's kept entries, ordered
    by row, are written into its own copy of the columns' slots and its own
    counts recorded, so elements may keep different entries (a product that
    cancels in one value set drops from that element only).
    :meth:`build` reads all B totals in one host sync and gathers each
    element's slots into its CSC on the same device.  ``tile_shapes``
    records every tile seen.

    Each element owns ``slots.total`` entry slots and ``slots.spare`` spare
    ones for the discarded cells of one unbatched tile, so the staging holds
    B times the plan's slots and the plan's ``c_slots`` stay sized for one
    value set.
    """

    dtype = torch.float32   # the kernels' value type

    def __init__(self, batch: int, shape, slots: ColumnSlots):
        if batch < 1:
            raise ValueError(f"batch must be >= 1, got {batch}")
        self.batch = int(batch)
        self.shape = tuple(int(s) for s in shape)
        self.device = slots.start.device
        self.slots = slots
        self.tile_shapes: list = []  # (kind, shape) per compacted tile
        size = (self.batch, slots.total + slots.spare)
        self._rows = torch.empty(size, dtype=torch.int32, device=self.device)
        self._vals = torch.empty(size, dtype=self.dtype, device=self.device)
        self._counts = torch.zeros((self.batch, self.shape[1]),
                                   dtype=torch.int64, device=self.device)

    @property
    def peak_tile_elems(self) -> int:
        """Largest intermediate tile compacted so far, in elements."""
        return max((int(np.prod(s)) for _, s in self.tile_shapes), default=0)

    def _scatter(self, cols, keep, rows, vals) -> None:
        """Write ``rows``/``vals`` [B, L, R] where ``keep``; in element b,
        column ``cols[i]`` takes lane i's kept entries in ascending R order.

        Lanes come before cells so that the rank is a scan along the last
        axis: PyTorch scans an outer axis with one thread per lane, walking
        all R cells in sequence.
        """
        cells = keep.shape[1] * keep.shape[2]
        if cells > self.slots.spare:
            raise ValueError(f"a tile of {cells} cells exceeds the "
                             f"{self.slots.spare} spare slots")
        dev = keep.device
        rank = torch.cumsum(keep, dim=2) - 1
        spare = torch.arange(cells, device=dev).view(keep.shape[1:])
        elem = torch.arange(self.batch, device=dev)[:, None, None] \
            * self._rows.shape[1]
        dest = elem + torch.where(
            keep, self.slots.start[cols][:, None] + rank,
            self.slots.total + spare)
        self._rows.view(-1)[dest.reshape(-1)] = \
            rows.to(torch.int32).expand(keep.shape).reshape(-1)
        self._vals.view(-1)[dest.reshape(-1)] = vals.to(self.dtype).reshape(-1)
        self._counts[:, cols] = keep.sum(dim=2)

    def _check_tile(self, tile, cols, what) -> None:
        if tile.dim() != 3 or tile.shape[0] != self.batch \
                or tile.shape[2] != len(cols):
            raise ValueError(
                f"{what} of shape {tuple(tile.shape)} is not [B={self.batch}"
                f", *, {len(cols)}] for {len(cols)} cols")

    def add_dense_tile(self, cols: torch.Tensor, tiles: torch.Tensor) -> None:
        """Compact a dense [B, m, L] accumulator tile; tiles[b, :, i] is
        element b's C column cols[i].  Keeps |v| > 0, rows ascending in
        each column."""
        self._check_tile(tiles, cols, "tile")
        self.tile_shapes.append(("dense", tuple(tiles.shape)))
        lanes = tiles.transpose(1, 2)
        rows = torch.arange(tiles.shape[1], device=tiles.device)
        self._scatter(cols, lanes.abs() > 0, rows, lanes)

    def add_hash_tables(self, cols: torch.Tensor, keys: torch.Tensor,
                        vals: torch.Tensor) -> None:
        """Compact per-lane hash tables keys/vals [B, H, L]; lane i of
        element b holds its C column cols[i].  Keeps slots with key >= 0
        and |v| > 0, sorted by row within each lane."""
        self._check_tile(keys, cols, "tables")
        self.tile_shapes.append(("hash", tuple(keys.shape)))
        m = self.shape[0]
        keys, vals = keys.transpose(1, 2), vals.transpose(1, 2)
        occupied = (keys >= 0) & (vals.abs() > 0)
        # free slots sort after every row; a stable sort keeps equal keys
        # in slot order
        rows, order = torch.sort(torch.where(occupied, keys.long(), m),
                                 dim=2, stable=True)
        self._scatter(cols, rows < m, rows, vals.gather(2, order))

    def build(self) -> list:
        """The B assembled CSC results, in batch order."""
        m, n = self.shape
        dev = self.device
        col_ptr = torch.zeros((self.batch, n + 1), dtype=torch.int64,
                              device=dev)
        torch.cumsum(self._counts, 1, out=col_ptr[:, 1:])
        nnz = col_ptr[:, -1].tolist()   # the one host sync of an execution
        out = []
        for b, nnz_b in enumerate(nnz):
            # entry p of column j sits at slot start[j] + (p - col_ptr[j])
            col = torch.repeat_interleave(torch.arange(n, device=dev),
                                          self._counts[b], output_size=nnz_b)
            src = (self.slots.start[col] + torch.arange(nnz_b, device=dev)
                   - col_ptr[b, col])
            out.append(CSC(self._vals[b, src], self._rows[b, src],
                           col_ptr[b].to(torch.int32), (m, n)))
        return out


class CSCBuilder(BatchedCSCBuilder):
    """Column-sliced CSC assembly from per-group kernel outputs, on the
    device: the one-value-set case of :class:`BatchedCSCBuilder`, taking
    dense ``[m, L]`` tiles and ``[H, L]`` hash tables and building one CSC
    with one host sync (the result's nnz)."""

    def __init__(self, shape, slots: ColumnSlots):
        super().__init__(1, shape, slots)

    def add_dense_tile(self, cols: torch.Tensor, tile: torch.Tensor) -> None:
        """Compact a dense [m, L] accumulator tile; tile[:, i] is C column
        cols[i].  Keeps |v| > 0, rows ascending in each column."""
        super().add_dense_tile(cols, tile[None])
        self.tile_shapes[-1] = ("dense", tuple(tile.shape))

    def add_hash_tables(self, cols: torch.Tensor, keys: torch.Tensor,
                        vals: torch.Tensor) -> None:
        """Compact per-lane hash tables keys/vals [H, L]; lane i holds C
        column cols[i].  Keeps slots with key >= 0 and |v| > 0, sorted by
        row within each lane."""
        super().add_hash_tables(cols, keys[None], vals[None])
        self.tile_shapes[-1] = ("hash", tuple(keys.shape))

    def build(self) -> CSC:
        return super().build()[0]


def validate_csc(m: CSC, *, sorted_rows: bool = False) -> None:
    """Structural invariants; raises ValueError on a violation."""
    cp = _np(m.col_ptr)
    rows = _np(m.row_indices)

    def check(ok, what):
        if not ok:
            raise ValueError(f"invalid CSC: {what}")

    check(cp.shape == (m.n_cols + 1,), "col_ptr length")
    check(cp[0] == 0, "col_ptr[0] must be 0")
    check((np.diff(cp) >= 0).all(), "col_ptr must be non-decreasing")
    nnz = int(cp[-1])
    check(nnz <= m.capacity, "nnz exceeds capacity")
    check(rows.shape[0] >= nnz, "row_indices capacity")
    if nnz:
        check(rows[:nnz].min() >= 0 and rows[:nnz].max() < m.n_rows,
              "row bounds")
    if sorted_rows:
        for j in range(m.n_cols):
            seg = rows[cp[j]: cp[j + 1]]
            check((np.diff(seg) > 0).all(), f"rows not strictly sorted in col {j}")


def csc_equal(a: CSC, b: CSC, rtol: float = 1e-6, atol: float = 1e-8) -> bool:
    """Semantic equality (order-insensitive within columns, via densification)."""
    if tuple(a.shape) != tuple(b.shape):
        return False
    da = csc_to_dense(a).cpu().to(torch.float64)
    db = csc_to_dense(b).cpu().to(torch.float64)
    return bool(torch.allclose(da, db, rtol=rtol, atol=atol))


def csc_bit_identical(a: CSC, b: CSC) -> bool:
    """Exact structural and value equality, storage order included: the
    level at which plan reuse, batched == looped and the host backend's
    parity with the JAX package are held."""
    return (
        tuple(a.shape) == tuple(b.shape)
        and np.array_equal(_np(a.col_ptr), _np(b.col_ptr))
        and np.array_equal(_np(a.row_indices)[: a.nnz],
                           _np(b.row_indices)[: b.nnz])
        and np.array_equal(_np(a.values)[: a.nnz], _np(b.values)[: b.nnz])
    )
