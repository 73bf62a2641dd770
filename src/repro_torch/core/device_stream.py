"""Pieces shared by the stream engines on the device.

The counterpart of the shared parts of the JAX package's
``core/jax_stream.py``: the int32 index check, the per-product segment ids,
the guard error, and the bilinear backward.  That module's XLA lowering of
the stream (``backend="jax"``) has no counterpart in the port yet; the one
engine built on these pieces is the fused K1 engine (``core.fused_stream``).

**Differentiability.**  The contraction ``c[s] = sum_{q in s} a[a_pos[q]] *
b[b_pos[q]]`` is bilinear, so its backward is two more replays of the same
stream, with no new symbolic work::

    dL/da[p] = sum_{q : a_pos[q] = p} g[seg(q)] * b[b_pos[q]]
    dL/db[p] = sum_{q : b_pos[q] = p} g[seg(q)] * a[a_pos[q]]

:func:`bilinear_custom_vjp` wraps a forward replay and the two gradient
replays into a ``torch.autograd.Function``.
"""

from __future__ import annotations

import numpy as np
import torch

# int32 device indices: the plan-memory guard keeps streams far below 2**31
# products, but a_pos/b_pos index the operands' value arrays, whose nnz the
# guard does not bound, so the check covers both
_I32_MAX = np.iinfo(np.int32).max


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


def _guard_error(plan) -> ValueError:
    return ValueError(
        f"plan's product stream exceeds its plan-memory guard "
        f"(stream_limit={plan.stream_limit}), so there is no device-resident "
        "stream to differentiate through: only execute() rebuilds it "
        "transiently.  Raise plan_spgemm's stream_limit= when planning")


def bilinear_custom_vjp(forward, grad_a, grad_b):
    """A differentiable bilinear stream contraction ``f(a_values, b_values)``.

    ``forward(a_values, b_values)`` is the primal replay.
    ``grad_a(g, a_values, b_values)`` and ``grad_b(g, a_values, b_values)``
    each take the output cotangent and both operands and return the
    cotangent of their operand, shaped like it (oversized value arrays get
    oversized cotangents).  A replay nobody asked for
    (``ctx.needs_input_grad``) is skipped.
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
