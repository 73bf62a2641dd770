"""The product stream: C = A @ B as a fixed gather-multiply-segment-sum.

Once a plan has fixed C's structure, the numeric phase is a contraction
that depends on the pattern alone: which products exist, which C slot each
lands in and in what order each slot sums them.  :func:`build_product_stream`
computes that contraction once, in host numpy, as a flat
:class:`ProductStream`, and three engines replay it::

    c_vals[s] = sum over q in segment s of a_vals[a_pos[q]] * b_vals[b_pos[q]]

- the host stream engine here (:func:`execute_stream`, the ``"host"``
  backend's ``engine="stream"``), in numpy, exactly as the JAX package's
  ``core/fast.py`` does: its results equal that package's host stream bit
  for bit;
- the torch stream (``core.device_stream``, the ``"torch"`` backend), in
  PyTorch ops on the plan's device;
- the fused engine (``core.fused_stream``, ``engine="fused"``), one launch
  of kernel K1.

Memory guard: a stream costs O(products) plan-resident memory, so a plan
keeps none above its ``stream_limit`` products (default
``STREAM_MAX_PRODUCTS``); each engine then rebuilds the stream for that one
execution and keeps nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.core.expand import expand_positions, product_count
from repro_torch.sparse.format import CSC, _np, as_tensor, segment_reduce

# plan-resident stream guard, in products: the JAX package's default, sized
# there for host RAM and not yet measured against the card's memory;
# plan_spgemm(stream_limit=) sets it per plan
STREAM_MAX_PRODUCTS = 8_000_000

# batched host execution: streams up to this many products run the value
# axis through 2-D gather/reduce passes; longer ones loop the 1-D pass row
# by row (the JAX package's constants, which its numpy engine was measured
# under; np.add.reduceat along axis 1 equals the 1-D pass row by row)
STREAM_BATCH_VECTOR_MAX = 1024
# ...and 2-D passes are row-blocked to bound the [block, P] working set
STREAM_BATCH_BLOCK_ELEMS = 1 << 20


@dataclasses.dataclass(frozen=True)
class ProductStream:
    """Pattern-only flat layout of every scalar product of ``C = A @ B``.

    ``a_pos``/``b_pos`` index the operands' value arrays, one entry per
    scalar product, with the C-slot sort already applied: the products of
    C's p-th stored slot occupy ``[seg_starts[p], seg_starts[p+1])``, slots
    in canonical CSC order (column-major, rows ascending).  Within a
    segment, products keep Gustavson stream order (``core.expand``).
    """

    a_pos: np.ndarray       # [P] int64: A value position of each product
    b_pos: np.ndarray       # [P] int64: B value position of each product
    seg_starts: np.ndarray  # [nnz_c] int64: first product of each C slot
    c_rows: np.ndarray      # [nnz_c] int32: C's row indices
    c_col_ptr: np.ndarray   # [n+1] int32: C's column offsets
    shape: Tuple[int, int]

    @property
    def n_products(self) -> int:
        return int(self.a_pos.shape[0])

    @property
    def nnz(self) -> int:
        return int(self.c_col_ptr[-1])

    @property
    def nbytes(self) -> int:
        """Plan-resident size of the stream's index arrays."""
        return (self.a_pos.nbytes + self.b_pos.nbytes
                + self.seg_starts.nbytes + self.c_rows.nbytes
                + self.c_col_ptr.nbytes)


def build_product_stream(a, b, max_products: int | None = None
                         ) -> Optional[ProductStream]:
    """The product stream of ``C = A @ B``, from structure alone.

    ``a``/``b``: anything with ``col_ptr``/``row_indices``/``shape`` (a
    planner ``Pattern`` or a CSC); values are never read.  Returns ``None``
    when the stream would exceed ``max_products`` (the plan-memory guard);
    ``None`` builds unconditionally.  The arrays are frozen (non-writeable):
    the plan shares them with everything built from the stream.
    """
    a_cp = _np(a.col_ptr)
    a_rows = _np(a.row_indices)[: int(a_cp[-1])]
    b_cp = _np(b.col_ptr)
    b_rows = _np(b.row_indices)
    m, n = int(a.shape[0]), int(b.shape[1])

    if max_products is not None and product_count(
            a_cp, b_cp, b_rows) > max_products:
        return None
    a_pos, b_pos, cols = expand_positions(a_cp, b_cp, b_rows)
    total = len(a_pos)
    if total == 0:
        z = np.zeros(0, np.int64)
        return _frozen_stream(z, z.copy(), z.copy(), np.zeros(0, np.int32),
                              np.zeros(n + 1, np.int32), (m, n))
    rows = a_rows[a_pos].astype(np.int64)

    # sort products to C slots (stable: stream order survives in each slot)
    order = np.lexsort((rows, cols))
    rows, cols = rows[order], cols[order]
    key = cols * m + rows                  # ascending after the lexsort
    boundary = np.empty(total, bool)
    boundary[0] = True
    np.not_equal(key[1:], key[:-1], out=boundary[1:])
    starts = np.nonzero(boundary)[0].astype(np.int64)
    c_rows = rows[boundary].astype(np.int32)
    col_ptr = np.zeros(n + 1, np.int32)
    np.cumsum(np.bincount(cols[boundary], minlength=n), out=col_ptr[1:])
    return _frozen_stream(a_pos[order], b_pos[order], starts, c_rows,
                          col_ptr, (m, n))


def _frozen_stream(a_pos, b_pos, seg_starts, c_rows, c_col_ptr,
                   shape) -> ProductStream:
    for arr in (a_pos, b_pos, seg_starts, c_rows, c_col_ptr):
        arr.flags.writeable = False
    return ProductStream(a_pos, b_pos, seg_starts, c_rows, c_col_ptr, shape)


def plan_stream(plan) -> tuple:
    """(stream, kept): the plan's stream, or past its guard one built for
    this call alone."""
    s = plan.stream
    if s is not None:
        return s, True
    return build_product_stream(plan.a, plan.b), False


def execute_stream(plan, a_values: np.ndarray, b_values: np.ndarray,
                   stats: dict | None = None) -> CSC:
    """Numeric phase of a host plan through the product stream, in numpy.

    ``a_values``/``b_values``: host value arrays aligned with the planned
    patterns (already checked by the executor).  The result does not depend
    on ``plan.method``: every method agrees on the one contraction.  Its
    structure is the stream's (rows ascending), its values a CPU tensor in
    the operands' common dtype.
    """
    s, cached = plan_stream(plan)
    dtype = np.result_type(a_values.dtype, b_values.dtype)
    if s.n_products == 0:
        vals = np.zeros(0, dtype)
    else:
        prod = a_values[s.a_pos]
        prod = prod * b_values[s.b_pos]
        vals = segment_reduce(prod, s.seg_starts)
    if stats is not None:
        stats["engine"] = "stream"
        stats["stream_products"] = s.n_products
        stats["stream_cached"] = cached
        stats["result_shape"] = s.shape
    return CSC(as_tensor(vals.astype(dtype, copy=False)), s.c_rows,
               s.c_col_ptr, s.shape)


def execute_stream_batched(plan, a_values: np.ndarray, b_values: np.ndarray,
                           stats: dict | None = None) -> list:
    """Batched host stream: ``[B, nnz]`` stacks over the value axis.

    Streams of at most ``STREAM_BATCH_VECTOR_MAX`` products run the value
    axis through 2-D passes in row blocks; longer ones loop the 1-D pass
    row by row.  Either way row b equals :func:`execute_stream` of value
    set b bit for bit.
    """
    s, cached = plan_stream(plan)
    batch = a_values.shape[0]
    dtype = np.result_type(a_values.dtype, b_values.dtype)
    path = ("vectorized" if s.n_products <= STREAM_BATCH_VECTOR_MAX
            else "rowloop")
    if s.n_products == 0:
        vals = np.zeros((batch, 0), dtype)
    elif s.n_products <= STREAM_BATCH_VECTOR_MAX:
        blk = max(1, STREAM_BATCH_BLOCK_ELEMS // s.n_products)
        vals = np.empty((batch, s.nnz), dtype)
        for b0 in range(0, batch, blk):
            prod = a_values[b0:b0 + blk, s.a_pos]
            prod = prod * b_values[b0:b0 + blk, s.b_pos]
            vals[b0:b0 + blk] = segment_reduce(prod, s.seg_starts, axis=1)
    else:
        vals = np.empty((batch, s.nnz), dtype)
        for bi in range(batch):
            prod = a_values[bi, s.a_pos]
            prod = prod * b_values[bi, s.b_pos]
            vals[bi] = segment_reduce(prod, s.seg_starts)
    if stats is not None:
        stats["engine"] = "stream"
        stats["path"] = path
        stats["stream_products"] = s.n_products
        stats["stream_cached"] = cached
        stats["result_shape"] = s.shape
    vals = as_tensor(vals.astype(dtype, copy=False))
    return [CSC(vals[b], s.c_rows, s.c_col_ptr, s.shape)
            for b in range(batch)]
