"""The device stream: the product stream as PyTorch ops (``backend="torch"``).

The counterpart of the JAX package's ``core/jax_stream.py``.  A plan's
product stream (``core.fast``) reduces the numeric phase to a fixed
contraction; this module lifts its index arrays to the plan's device once
(kept on the plan) and replays it there in PyTorch's own ops::

    prod   = a_values[a_pos] * b_values[b_pos]            # index_select
    c_vals = segment_reduce(prod, "sum", lengths=...)     # C slot by slot

No hand-written kernel runs here (the reference's stream is XLA, not
Pallas); ``engine="fused"`` on the same plan swaps this lowering for kernel
K1 (``core.fused_stream``).  An execution on operands already on the card
makes no host sync: every shape is fixed at plan time.

**Order.**  The sum is ``torch.segment_reduce`` over a 1-D tensor, never
``index_add_``/``scatter_add_``, whose f32 atomics on the card change order
from run to run.  On the CPU it adds each segment left to right from 0, the
order of the reference's ``segment_sum`` and of K1.  On the card PyTorch
hands a 1-D segmented sum to CUB, one thread block a segment, in a tree
order fixed by the segment's length and, from a full tile of vector loads
(4096 products) on, by the alignment of its first product
(``chip_smoke.py``'s ``segment_reduce_order_on_card`` probe): bit-stable
from run to run, and on integer values equal to every other order, but not
K1's order on real values.

**Batch.**  A ``[B, nnz]`` stack runs as one segmented sum over ``B`` rows
of segments, the lengths tiled B times.  Each row of products starts at a
multiple of :data:`ALIGN` (a padding segment closes each row, and its sums
are dropped), so each C slot of each value set is summed exactly as the
unbatched call sums it: batched equals looped bit for bit, forward and
gradients.

**Differentiability.**  The contraction ``c[s] = sum_{q in s} a[a_pos[q]] *
b[b_pos[q]]`` is bilinear, so its backward is two more replays of the same
products, with no new symbolic work::

    dL/da[p] = sum_{q : a_pos[q] = p} g[seg(q)] * b[b_pos[q]]
    dL/db[p] = sum_{q : b_pos[q] = p} g[seg(q)] * a[a_pos[q]]

The reference scatters through the unsorted positions; here each gradient
replay is built at plan time in the order K1's gradient views use (the
products stably sorted by the operand's position, one segment per distinct
position), summed by the same segmented sum, and placed by ``index_copy_``
through the distinct positions, which writes each index once.
:func:`bilinear_custom_vjp` wraps a forward replay and the two gradient
replays into a ``torch.autograd.Function`` (the fused engine's too).

**Guard.**  A plan whose stream exceeds its ``stream_limit`` keeps none.
An execution then builds the stream and its forward replay on the plan's
device for that one call and keeps nothing (``stats["stream_cached"]`` is
False): the reference falls back to its host engine there, the port stays
on the plan's device.  :func:`stream_fn` and ``plan.stream_apply`` raise
instead, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.core.fast import ProductStream, build_product_stream
from repro_torch.sparse.format import CSC, as_tensor

# int32 device indices: the plan-memory guard keeps streams far below 2**31
# products, but a_pos/b_pos index the operands' value arrays, whose nnz the
# guard does not bound, so the check covers both
_I32_MAX = np.iinfo(np.int32).max

#: each value set's row of products starts at a multiple of this many
#: products (128 bytes of f32), so a batched segmented sum sees every
#: segment at the alignment the unbatched one sees it at
ALIGN = 32


def check_int32_stream(plan, s) -> None:
    """Reject a stream whose indices overflow int32 device tensors: its
    products, its C slots, or the operands' value positions."""
    if max(s.n_products, s.nnz, plan.a.nnz, plan.b.nnz) > _I32_MAX:
        raise ValueError(
            f"stream of {s.n_products} products over operands of nnz "
            f"{plan.a.nnz}/{plan.b.nnz} exceeds int32 device indexing; "
            "lower plan_spgemm's stream_limit=")


def stream_seg_ids(s) -> np.ndarray:
    """Per-product C-slot id of a stream (int32, non-decreasing).

    Segment p spans ``[seg_starts[p], seg_starts[p+1])`` of the sorted
    stream, so the ids are ``0..nnz_c-1`` repeated by segment length; every
    stored C slot has at least one product.
    """
    lens = np.diff(np.append(s.seg_starts, s.n_products))
    return np.repeat(np.arange(s.nnz, dtype=np.int32), lens)


def grad_replay(pos, other_pos, seg_ids) -> tuple:
    """``(idx_x, idx_y, seg_ptr, out_map)`` of the replay for d(operand at
    ``pos``), host numpy: the products sorted stably by ``pos``, segment r
    holding those of the r-th distinct position ``out_map[r]``; the replay
    gathers the output cotangent through ``seg_ids`` (x) and the other
    operand's values through ``other_pos`` (y).  Shared with K1's gradient
    views."""
    order = np.argsort(pos, kind="stable")
    seq = np.asarray(pos)[order]
    uniq, first = np.unique(seq, return_index=True)
    return (np.asarray(seg_ids)[order], np.asarray(other_pos)[order],
            np.append(first, len(seq)), uniq)


def _guard_error(plan) -> ValueError:
    return ValueError(
        f"plan's product stream exceeds its plan-memory guard "
        f"(stream_limit={plan.stream_limit}), so there is no device-resident "
        "stream to differentiate through: only execute() rebuilds it "
        "transiently.  Raise plan_spgemm's stream_limit= when planning")


def _check_batch(av, bv) -> int:
    if av.shape[0] != bv.shape[0]:
        raise ValueError(
            f"batch mismatch: A has {av.shape[0]} value sets, "
            f"B has {bv.shape[0]}")
    batch = int(av.shape[0])
    if batch == 0:
        raise ValueError("empty batch")
    return batch


def _values(x, device) -> torch.Tensor:
    """The operand's values (a vector, or a ``[B, nnz]`` stack) as f32 on
    ``device``; cast before any gather: the cast is elementwise, so it
    equals the reference's cast of the gathered values, and it is
    differentiable, so operands of another dtype or device get their
    gradients back in their own."""
    v = x.values if isinstance(x, CSC) else x
    return as_tensor(v).to(device=device, dtype=torch.float32)


def _operand(x, dev) -> torch.Tensor:
    return _values(x, dev).contiguous()


# ---------------------------------------------------------------------------
# the device-resident replays
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class StreamView:
    """Device index tensors of one replay of the stream.

    Product q multiplies ``x[idx_x[q]]`` by ``y[idx_y[q]]``; segment s sums
    ``lengths[s]`` consecutive products.  The products are padded to a
    multiple of :data:`ALIGN` with index 0, and the last entry of
    ``lengths`` is the padding's segment, whose sum is dropped.  Gradient
    replays place their ``n_out`` sums through ``out_map``.
    """

    idx_x: torch.Tensor              # [P padded] int32 into x
    idx_y: torch.Tensor              # [P padded] int32 into y
    lengths: torch.Tensor            # [n_out + 1] int64
    out_map: Optional[torch.Tensor]  # [n_out] int64 (gradient replays)
    n_out: int
    n_products: int

    @property
    def nbytes(self) -> int:
        """Device bytes held by this replay's index tensors."""
        return sum(t.nbytes for t in (self.idx_x, self.idx_y, self.lengths,
                                      self.out_map) if t is not None)


@dataclasses.dataclass(frozen=True)
class DeviceStream:
    """A plan's stream on its device: the forward replay, the two gradient
    replays (None in a stream built for one execution past the guard) and
    C's structure."""

    forward: StreamView
    grad_a: Optional[StreamView]
    grad_b: Optional[StreamView]
    c_rows: torch.Tensor      # [nnz_c] int32
    c_col_ptr: torch.Tensor   # [n + 1] int32
    shape: Tuple[int, int]

    @property
    def n_products(self) -> int:
        return self.forward.n_products

    @property
    def nbytes(self) -> int:
        """Device bytes held by the stream's index tensors."""
        return sum(t.nbytes for t in (self.forward, self.grad_a, self.grad_b,
                                      self.c_rows, self.c_col_ptr)
                   if t is not None)


def _lift(arr, dtype, dev) -> torch.Tensor:
    # a copy: the stream's arrays are frozen, and a CPU tensor would share
    # their memory
    return torch.as_tensor(np.array(arr, dtype), device=dev)


def _view(idx_x, idx_y, seg_ptr, dev, out_map=None) -> StreamView:
    p = len(idx_x)
    pad = -p % ALIGN
    lengths = np.append(np.diff(seg_ptr), pad)
    return StreamView(
        idx_x=_lift(np.append(idx_x, np.zeros(pad, np.int64)), np.int32,
                    dev),
        idx_y=_lift(np.append(idx_y, np.zeros(pad, np.int64)), np.int32,
                    dev),
        lengths=_lift(lengths, np.int64, dev),
        out_map=None if out_map is None else _lift(out_map, np.int64, dev),
        n_out=len(seg_ptr) - 1, n_products=p)


def _lift_stream(plan, s: ProductStream, grads: bool) -> DeviceStream:
    check_int32_stream(plan, s)
    dev = plan.device
    forward = _view(s.a_pos, s.b_pos, np.append(s.seg_starts, s.n_products),
                    dev)
    grad_a = grad_b = None
    if grads:
        seg_ids = stream_seg_ids(s)
        ga = grad_replay(s.a_pos, s.b_pos, seg_ids)
        gb = grad_replay(s.b_pos, s.a_pos, seg_ids)
        grad_a = _view(*ga[:3], dev, out_map=ga[3])
        grad_b = _view(*gb[:3], dev, out_map=gb[3])
    return DeviceStream(forward, grad_a, grad_b,
                        _lift(s.c_rows, np.int32, dev),
                        _lift(s.c_col_ptr, np.int32, dev), s.shape)


def device_stream(plan) -> Optional[DeviceStream]:
    """The plan's device stream, built at first use and kept on the plan
    (``plan.device_stream_nbytes``; ``plan_cache_info()
    ["device_stream_bytes"]``).  ``None`` when the plan-memory guard
    tripped."""
    s = plan.stream
    if s is None:
        return None
    memo = plan._stream_memo
    if "device" not in memo:
        memo["device"] = _lift_stream(plan, s, grads=True)
    return memo["device"]


def replay(view: StreamView, x: torch.Tensor,
           y: torch.Tensor) -> torch.Tensor:
    """The ``[..., n_out]`` segment sums of ``x[..., idx_x] * y[..., idx_y]``
    for one value set (``x``, ``y`` vectors) or B (``[B, n]`` stacks): one
    gather each, one multiply, one segmented sum over the flat products."""
    lead = tuple(x.shape[:-1])
    if view.n_products == 0 or view.n_out == 0:
        return torch.zeros(lead + (view.n_out,), dtype=torch.float32,
                           device=x.device)
    prod = x.index_select(-1, view.idx_x) * y.index_select(-1, view.idx_y)
    rows = prod.shape[0] if prod.dim() == 2 else 1
    lengths = view.lengths if rows == 1 else view.lengths.repeat(rows)
    sums = torch.segment_reduce(prod.reshape(-1), "sum", lengths=lengths,
                                unsafe=True)
    return sums.view(lead + (view.n_out + 1,))[..., : view.n_out]


def _scatter(view: StreamView, compact: torch.Tensor, n: int) -> torch.Tensor:
    """The compact gradient sums placed at their value positions (the last
    axis, each row of a stack alike); positions with no products get
    exactly 0."""
    out = torch.zeros(tuple(compact.shape[:-1]) + (n,), dtype=compact.dtype,
                      device=compact.device)
    return out.index_copy_(-1, view.out_map, compact)


def bilinear_custom_vjp(forward, grad_a, grad_b):
    """A differentiable bilinear stream contraction ``f(a_values, b_values)``.

    ``forward(a_values, b_values)`` is the primal replay.
    ``grad_a(g, a_values, b_values)`` and ``grad_b(g, a_values, b_values)``
    each take the output cotangent and both operands and return the
    cotangent of their operand, shaped like it (oversized value arrays get
    oversized cotangents).  A replay nobody asked for
    (``ctx.needs_input_grad``) is skipped.  Shared by the torch stream and
    the fused engine, which differ only in how a replay is lowered.
    """

    class Contract(torch.autograd.Function):
        @staticmethod
        def forward(ctx, a_values, b_values):
            ctx.save_for_backward(a_values, b_values)
            return forward(a_values, b_values)

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g):
            a_values, b_values = ctx.saved_tensors
            g = g.contiguous()
            need_a, need_b = ctx.needs_input_grad
            return (grad_a(g, a_values, b_values) if need_a else None,
                    grad_b(g, a_values, b_values) if need_b else None)

    return Contract.apply


def _torch_contract(ds: DeviceStream, dev):
    """The differentiable torch-stream contraction: forward and two
    gradient replays, for vectors and ``[B, nnz]`` stacks alike."""

    def forward(a_values, b_values):
        return replay(ds.forward, a_values, b_values)

    def grad_a(g, a_values, b_values):
        return _scatter(ds.grad_a, replay(ds.grad_a, g, b_values),
                        a_values.shape[-1])

    def grad_b(g, a_values, b_values):
        return _scatter(ds.grad_b, replay(ds.grad_b, g, a_values),
                        b_values.shape[-1])

    contract = bilinear_custom_vjp(forward, grad_a, grad_b)

    def fn(a_values, b_values):
        return contract(_operand(a_values, dev), _operand(b_values, dev))

    return fn


def stream_fn(plan):
    """The plan's differentiable function ``f(a_values, b_values) ->
    c_values``: C's values (f32, on the plan's device) on the stream's
    structure, for value vectors or ``[B, nnz]`` stacks.  Kept on the plan;
    a guarded plan raises the guard error."""
    memo = plan._stream_memo
    if "torch_fn" not in memo:
        ds = device_stream(plan)
        if ds is None:
            raise _guard_error(plan)
        memo["torch_fn"] = _torch_contract(ds, plan.device)
    return memo["torch_fn"]


def stream_fn_batched(plan):
    """:func:`stream_fn` for ``[B, nnz]`` stacks only (the reference's
    ``vmap``): one segmented sum for all B value sets, forward and
    backward, each set's values and gradients equal to an unbatched call's
    bit for bit."""
    fn = stream_fn(plan)

    def batched(a_values, b_values):
        if np.ndim(a_values) != 2 or np.ndim(b_values) != 2:
            raise ValueError("stream_fn_batched takes [B, nnz] value stacks")
        return fn(a_values, b_values)

    return batched


def _stream_of(plan) -> tuple:
    """(device stream, kept): the plan's, or past the guard one built on
    the plan's device for this call, its forward replay only."""
    ds = device_stream(plan)
    if ds is not None:
        return ds, True
    return _lift_stream(plan, build_product_stream(plan.a, plan.b),
                        grads=False), False


def _stats(stats, plan, ds, cached) -> None:
    if stats is not None:
        stats.update(engine="stream", backend=plan.backend,
                     device=str(plan.device),
                     stream_products=ds.n_products, stream_cached=cached,
                     result_shape=plan.shape)


def execute_torch(plan, a_values, b_values, *, stats: dict | None = None,
                  validate: str | None = None) -> CSC:
    """Numeric phase through the torch stream (the ``"torch"`` backend's
    ``"stream"`` engine).

    The result's values lie on the plan's device, on the stream's canonical
    structure (rows ascending in each column, one slot per pair (i, j) with
    at least one product, kept where the products cancel).  Not
    differentiable: use ``plan.stream_apply`` for that.
    """
    plan.a.check_compatible(a_values, validate)
    plan.b.check_compatible(b_values, validate)
    dev = plan.device
    ds, cached = _stream_of(plan)
    with torch.no_grad():
        vals = replay(ds.forward, _operand(a_values, dev),
                      _operand(b_values, dev))
    _stats(stats, plan, ds, cached)
    return CSC(vals, ds.c_rows, ds.c_col_ptr, plan.shape)


def execute_torch_batched(plan, a_values, b_values, *,
                          stats: dict | None = None,
                          validate: str | None = None) -> list:
    """Batched numeric phase through the torch stream: B value sets, one
    segmented sum.  Returns B CSCs whose values are the rows of one
    ``[B, nnz_c]`` tensor and which share C's structure tensors; result b
    is bit-identical to :func:`execute_torch` on value set b."""
    av = plan.a.batched_values(a_values, validate)
    bv = plan.b.batched_values(b_values, validate)
    batch = _check_batch(av, bv)
    dev = plan.device
    ds, cached = _stream_of(plan)
    with torch.no_grad():
        vals = replay(ds.forward, _operand(av, dev), _operand(bv, dev))
    _stats(stats, plan, ds, cached)
    if stats is not None:
        stats.update(batch=batch, path="flat")
    return [CSC(v, ds.c_rows, ds.c_col_ptr, plan.shape) for v in vals]
