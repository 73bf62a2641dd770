"""Fused product-stream engine: the whole numeric phase in one K1 launch.

``engine="fused"`` replays a plan's product stream (``core.fast``) with one
launch of kernel K1 (``kernels/fused_stream.py``)::

    c_vals[s] = sum over q in segment s of a_vals[a_pos[q]] * b_vals[b_pos[q]]

The host side of the JAX package's ``core/pallas_stream.py``.  Its views are
not a copy of the TPU layout: the Pallas kernel tiles the product axis into
128-product grid steps and carries partial sums across steps through an
output window, which holds only because TPU grid steps run in order.  K1
gives each output slot one owner, a thread or (for a slot of more than
``LONG_SLOT`` products) a warp, so a view here is just the two gather index
vectors, the segment offsets, the list of long slots and, for the gradient
views, the scatter ``out_map``: no padding, block ids, local ids or masks.

**Views.**  The forward view replays the stream in C-slot order.  The
gradient views replay it sorted (stably) by the differentiated operand's
value position; positions with no products are absent, so the kernel
reduces into compact ranks and ``out_map`` (the sorted distinct positions)
scatters them into the operand-shaped cotangent, whose other entries are
exactly 0.  All index tensors are lifted to the plan's device once, with
C's structure, and shared by every result: an execution on operands that
already lie on the card copies nothing from the host and waits for nothing.

**Batch.**  :func:`execute_fused_batched` replays the forward view once
for B same-pattern value sets (``[B, nnz]`` stacks) in one K1-b launch;
the B results share C's structure tensors.  :func:`fused_fn` takes such
stacks too, the counterpart of the JAX package's ``vmap`` of its custom
vjp: K1-b replays the forward view and, backward, both gradient views,
each with the view's own long-slot list, and the compact sums are placed
row by row; every value set's values and gradients equal an unbatched
call's bit for bit.

**Guard.**  A plan whose stream exceeds its ``stream_limit`` keeps no stream.
:func:`execute_fused` and :func:`execute_fused_batched` then build the
stream and its forward view for that one call, run K1 on the plan's device
all the same, and keep nothing (``stats["stream_cached"]`` is False).
:func:`fused_fn` and ``plan.stream_apply`` raise instead, as in the JAX
package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.device_stream import (
    _check_batch,
    _guard_error,
    _operand,
    _scatter,
    bilinear_custom_vjp,
    check_int32_stream,
    grad_replay,
    stream_seg_ids,
)
from repro_torch.core.fast import ProductStream, build_product_stream
from repro_torch.kernels.fused_stream import long_slots_of
from repro_torch.sparse.format import CSC


@dataclasses.dataclass(frozen=True)
class FusedView:
    """Device-resident index tensors of one K1 replay.

    Segment s covers products ``[seg_ptr[s], seg_ptr[s+1])``; product q
    multiplies ``x[idx_x[q]]`` by ``y[idx_y[q]]``.  ``long_slots`` lists the
    segments longer than ``LONG_SLOT`` products, which K1 gives a warp each.
    Gradient views scatter their ``n_out`` sums through ``out_map``; the
    forward view has none.
    """

    idx_x: torch.Tensor              # [P] int32 into the x operand
    idx_y: torch.Tensor              # [P] int32 into the y operand
    seg_ptr: torch.Tensor            # [n_out + 1] int32 segment offsets
    long_slots: torch.Tensor         # [n_long] int32 ids of the long slots
    out_map: Optional[torch.Tensor]  # [n_out] int64 scatter (grad views)
    n_out: int
    n_products: int

    @property
    def nbytes(self) -> int:
        """Device bytes held by this view's index tensors."""
        return sum(t.nbytes for t in (self.idx_x, self.idx_y, self.seg_ptr,
                                      self.long_slots, self.out_map)
                   if t is not None)


@dataclasses.dataclass(frozen=True)
class FusedStream:
    """A plan's three K1 views (forward and the two gradient replays) and
    C's structure, on the plan's device."""

    forward: FusedView
    grad_a: FusedView
    grad_b: FusedView
    c_rows: torch.Tensor      # [nnz_c] int32
    c_col_ptr: torch.Tensor   # [n + 1] int32
    shape: Tuple[int, int]

    @property
    def n_products(self) -> int:
        return self.forward.n_products

    @property
    def nbytes(self) -> int:
        return (self.forward.nbytes + self.grad_a.nbytes + self.grad_b.nbytes
                + self.c_rows.nbytes + self.c_col_ptr.nbytes)


def _lift(arr, dtype, dev) -> torch.Tensor:
    # a copy: the stream's arrays are frozen, and a CPU tensor would share
    # their memory
    return torch.as_tensor(np.array(arr, dtype), device=dev)


def _view(idx_x, idx_y, seg_ptr, dev, out_map=None) -> FusedView:
    seg_ptr = np.asarray(seg_ptr, np.int32)
    return FusedView(
        idx_x=_lift(idx_x, np.int32, dev), idx_y=_lift(idx_y, np.int32, dev),
        seg_ptr=_lift(seg_ptr, np.int32, dev),
        long_slots=long_slots_of(torch.from_numpy(seg_ptr)).to(dev),
        out_map=None if out_map is None else _lift(out_map, np.int64, dev),
        n_out=len(seg_ptr) - 1, n_products=len(idx_x))


def _forward_view(s: ProductStream, dev) -> FusedView:
    """The forward replay of ``s``: products in C-slot order, one segment
    per stored C slot."""
    return _view(s.a_pos, s.b_pos, np.append(s.seg_starts, s.n_products),
                 dev)


def _grad_view(pos, other_pos, seg_ids, dev) -> FusedView:
    """The replay for d(operand at ``pos``): sort by ``pos``, compact ranks.

    The replay gathers the output cotangent through ``seg_ids`` (x side)
    and the other operand's values through ``other_pos`` (y side); segment
    r holds the products of the r-th distinct position, ``out_map[r]``
    (``core.device_stream.grad_replay``).
    """
    idx_x, idx_y, seg_ptr, out_map = grad_replay(pos, other_pos, seg_ids)
    return _view(idx_x, idx_y, seg_ptr, dev, out_map=out_map)


def _structure(s: ProductStream, dev):
    return (_lift(s.c_rows, np.int32, dev), _lift(s.c_col_ptr, np.int32, dev))


def fused_stream(plan) -> Optional[FusedStream]:
    """The plan's K1 views, built at first use and kept on the plan.

    ``None`` when the plan-memory guard tripped (the plan keeps no stream).
    """
    s = plan.stream
    if s is None:
        return None
    memo = plan._stream_memo
    if "fused" not in memo:
        check_int32_stream(plan, s)
        dev = plan.device
        seg_ids = stream_seg_ids(s)
        c_rows, c_col_ptr = _structure(s, dev)
        memo["fused"] = FusedStream(
            forward=_forward_view(s, dev),
            grad_a=_grad_view(s.a_pos, s.b_pos, seg_ids, dev),
            grad_b=_grad_view(s.b_pos, s.a_pos, seg_ids, dev),
            c_rows=c_rows, c_col_ptr=c_col_ptr, shape=s.shape)
    return memo["fused"]


def _fused_call(view: FusedView, x, y) -> torch.Tensor:
    """One K1 launch over ``view``: the ``[n_out]`` segment sums."""
    from repro_torch.kernels import fused_stream as k1

    return k1(view.idx_x, view.idx_y, view.seg_ptr, x, y,
              long_slots=view.long_slots)


def _fused_call_batched(view: FusedView, x, y) -> torch.Tensor:
    """K1-b over ``view`` for the ``[B, n]`` stacks ``x``, ``y``: the
    ``[B, n_out]`` segment sums, one launch per ``MAX_BATCH`` value sets."""
    from repro_torch.kernels import fused_stream_batched
    from repro_torch.kernels._checks import batch_chunks

    parts = [fused_stream_batched(view.idx_x, view.idx_y, view.seg_ptr,
                                  xp, yp, long_slots=view.long_slots)
             for xp, yp in batch_chunks(x, y)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _k1(view: FusedView, x, y) -> torch.Tensor:
    """K1 for value vectors, K1-b for ``[B, n]`` stacks."""
    return (_fused_call_batched if x.dim() == 2 else _fused_call)(view, x, y)


def _fused_contract(fs: FusedStream, dev):
    """The differentiable fused contraction: forward and two grad replays,
    for vectors (K1) and ``[B, nnz]`` stacks (K1-b) alike."""

    def forward(a_values, b_values):
        return _k1(fs.forward, a_values, b_values)

    def grad_a(g, a_values, b_values):
        return _scatter(fs.grad_a, _k1(fs.grad_a, g, b_values),
                        a_values.shape[-1])

    def grad_b(g, a_values, b_values):
        return _scatter(fs.grad_b, _k1(fs.grad_b, g, a_values),
                        b_values.shape[-1])

    contract = bilinear_custom_vjp(forward, grad_a, grad_b)

    def fn(a_values, b_values):
        # the cast to f32 on the plan's device is differentiable: operands
        # of another dtype or device get their gradients back in their own
        return contract(_operand(a_values, dev), _operand(b_values, dev))

    return fn


def fused_fn(plan):
    """The plan's differentiable fused function ``f(a_values, b_values) ->
    c_values`` (the values of C on the stream's structure, f32 on the plan's
    device), for value vectors or ``[B, nnz]`` stacks.  Kept on the plan; a
    guarded plan raises the guard error."""
    fs = fused_stream(plan)
    if fs is None:
        raise _guard_error(plan)
    memo = plan._stream_memo
    if "fused_fn" not in memo:
        memo["fused_fn"] = _fused_contract(fs, plan.device)
    return memo["fused_fn"]


def _forward_of(plan):
    """(forward view, c_rows, c_col_ptr, cached) of ``plan``: the kept
    views, or past the guard a stream and view built for this one call."""
    fs = fused_stream(plan)
    if fs is not None:
        return fs.forward, fs.c_rows, fs.c_col_ptr, True
    s = build_product_stream(plan.a, plan.b)
    check_int32_stream(plan, s)
    return (_forward_view(s, plan.device), *_structure(s, plan.device),
            False)


def _fused_stats(stats, plan, view, cached) -> None:
    if stats is not None:
        stats.update(engine="fused", backend=plan.backend,
                     device=str(plan.device),
                     n_launches=int(view.n_out > 0 and view.n_products > 0),
                     stream_products=view.n_products, stream_cached=cached,
                     result_shape=plan.shape)


def execute_fused(plan, a_values, b_values, *,
                  stats: dict | None = None,
                  validate: str | None = None) -> CSC:
    """Numeric phase through K1 (the executor's ``"fused"`` engine).

    One launch; the result's values lie on the plan's device, on the
    stream's canonical structure (rows ascending in each column, one slot
    per pair (i, j) with at least one product, kept even where the products
    cancel).  Not differentiable: use ``plan.stream_apply(..., engine=
    "fused")`` for that.
    """
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    dev = plan.device
    view, c_rows, c_col_ptr, cached = _forward_of(plan)
    with torch.no_grad():
        vals = _fused_call(view, _operand(a_values, dev),
                           _operand(b_values, dev))
    _fused_stats(stats, plan, view, cached)
    return CSC(vals, c_rows, c_col_ptr, plan.shape)


def execute_fused_batched(plan, a_values, b_values, *,
                          stats: dict | None = None,
                          validate: str | None = None) -> list:
    """Batched numeric phase through K1-b: B value sets, one launch (past
    ``MAX_BATCH`` value sets, one launch for each ``MAX_BATCH``).

    ``a_values``/``b_values`` are :class:`~repro_torch.sparse.format.
    BatchedCSC` operands or raw ``[B, nnz]`` stacks.  Returns B CSCs whose
    values are the rows of one ``[B, nnz_c]`` tensor and which share one
    ``row_indices``/``col_ptr`` pair; result b is bit-identical to
    :func:`execute_fused` on value set b.  Past the guard the stream is
    built once for the whole call.
    """
    from repro_torch.kernels import fused_stream_batched
    from repro_torch.kernels._checks import batch_chunks

    av = plan.a.batched_values(a_values, validate)
    bv = plan.b.batched_values(b_values, validate)
    batch = _check_batch(av, bv)
    dev = plan.device
    view, c_rows, c_col_ptr, cached = _forward_of(plan)
    parts = batch_chunks(_stack(av, dev), _stack(bv, dev))
    with torch.no_grad():
        vals = [fused_stream_batched(view.idx_x, view.idx_y, view.seg_ptr,
                                     x, y, long_slots=view.long_slots)
                for x, y in parts]
    _fused_stats(stats, plan, view, cached)
    if stats is not None:
        stats["batch"] = batch
        stats["n_launches"] *= len(parts)
    return [CSC(v, c_rows, c_col_ptr, plan.shape) for part in vals
            for v in part]


def _stack(v, dev) -> torch.Tensor:
    return v.to(device=dev, dtype=torch.float32).contiguous()
