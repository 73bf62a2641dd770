"""Activation-sharding hints: the port of the JAX package's
``repro/distributed/hints.py``.

The reference pins the sharding of the residual stream, the attention
heads and the MoE dispatch buffers with ``with_sharding_constraint``
wherever the dimensions divide the mesh's axes, and is a no-op without an
active mesh or on a 1-device one.  The port computes the same specs by the
same rule (``_dp_part``, the divisibility fallbacks, ``"model"`` used once
a tensor), but one process has no SPMD partitioner to hand a layout to: a
hint returns ``x`` itself, always, and under an active mesh of more than
one position (``with mesh:``, ``launch/mesh.py``) records ``(site, shape,
spec)`` on the mesh's context, where the reference's trace would hold the
constraint.  Inside a pipeline stage (the reference's manual axes under
``shard_map``) it records nothing.

Dim vocabulary: 'dp' (batch over pod+data), 'model', 'kv_or_seq', None.
"""

from __future__ import annotations

import math
import sys

from repro_torch.distributed.sharding import P, mesh_axis_sizes
from repro_torch.launch.mesh import active_context, current_mesh

__all__ = ["current_mesh", "hint", "hint_heads"]


def _dp_part(mesh, size):
    dp = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    sizes = mesh_axis_sizes(mesh)
    for k in range(len(dp), 0, -1):
        prod = math.prod(sizes[a] for a in dp[:k])
        if size % prod == 0 and prod > 1:
            return dp[:k] if k > 1 else dp[0]
    return None


def _recording():
    """The context a hint records on: the active mesh's, when it has more
    than one position and no pipeline stage is running; else None."""
    ctx = active_context()
    if ctx is None or ctx.manual or ctx.mesh is None or ctx.mesh.size == 1:
        return None
    return ctx


def _record(ctx, x, spec):
    caller = sys._getframe(2).f_code
    ctx.hints.append((caller.co_name, tuple(x.shape), spec))


def hint(x, *dims):
    """Record x's sharding under the active mesh; return ``x``."""
    ctx = _recording()
    if ctx is None or len(dims) != x.ndim:
        return x
    mesh = ctx.mesh
    model = mesh_axis_sizes(mesh).get("model", 1)
    parts = []
    used_model = False
    for size, d in zip(x.shape, dims):
        if d == "dp":
            parts.append(_dp_part(mesh, size))
        elif d == "model" and not used_model and model > 1 \
                and size % model == 0:
            parts.append("model")
            used_model = True
        else:
            parts.append(None)
    _record(ctx, x, P(*parts))
    return x


def hint_heads(x, *, batch_dim=0, head_dims=(2, 3)):
    """Attention tensors [B, S, Hkv, (G,) Dh]: the first head-ish dim that
    divides the model axis goes on it; otherwise heads stay unsharded
    (batch-DP attention, the non-divisible-head fallback).  Returns
    ``x``."""
    ctx = _recording()
    if ctx is None:
        return x
    mesh = ctx.mesh
    model = mesh_axis_sizes(mesh).get("model", 1)
    parts = [None] * x.ndim
    parts[batch_dim] = _dp_part(mesh, x.shape[batch_dim])
    if model > 1:
        for hd in head_dims:
            if hd < x.ndim - 1 and x.shape[hd] % model == 0:
                parts[hd] = "model"
                break
    _record(ctx, x, P(*parts))
    return x
