"""Gradient compression: int8 quantization with error feedback.

The port of the JAX package's ``repro/distributed/compression.py``, on the
port's tensor trees (nested dicts, ``training/tree.py``).  Gradients are
quantized to int8 with per-row f32 absmax scales; the quantization
residual is fed back into the next step, so the compression error stays
bounded instead of accumulating (EF-SGD).  Rounding is half to even in
both packages (``torch.round``, ``jnp.round``), so codes and scales equal
the reference's bit for bit on the same f32 inputs.

``psum_compressed`` runs under ``shard_map`` in the reference.  The port
drives the shards from one process, as the SpGEMM mesh does
(``spgemm_mesh.py``): :func:`psum_compressed` takes the shards' trees and
their devices and reduces them in shard order, with no atomics.
"""

from __future__ import annotations

import torch

from repro_torch.device import resolve_device

__all__ = ["dequantize_tree", "ef_compress", "psum_compressed",
           "quantize_tree"]


def tree_map(fn, tree, *rest):
    """``training.tree.tree_map``, imported at the call: the models import
    this package's hints, and the training package imports the models."""
    from repro_torch.training.tree import tree_map as walk

    return walk(fn, tree, *rest)


def _quantize(x):
    """(int8 codes, per-row f32 scales) of a tensor of rank 2 or more."""
    scale = x.abs().amax(dim=-1, keepdim=True) / 127.0
    scale = torch.clamp(scale, min=1e-20)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale.to(torch.float32)


def quantize_tree(tree):
    """int8 + per-row fp32 absmax scales; 1-D leaves pass through."""

    def q(x):
        if x.ndim < 2:
            return {"raw": x}
        codes, scale = _quantize(x)
        return {"q": codes, "scale": scale}

    return tree_map(q, tree)


def _is_quantized(node) -> bool:
    return isinstance(node, dict) and ("q" in node or "raw" in node)


def dequantize_tree(qtree):
    if _is_quantized(qtree):
        if "raw" in qtree:
            return qtree["raw"]
        return qtree["q"].to(torch.float32) * qtree["scale"]
    return {k: dequantize_tree(qtree[k]) for k in sorted(qtree)}


def ef_compress(grads, residual):
    """(compressed, new_residual): quantize grads+residual, keep the error."""
    if residual is None:
        residual = tree_map(
            lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                  device=g.device), grads)
    corrected = tree_map(lambda g, r: g.to(torch.float32) + r, grads,
                         residual)
    comp = quantize_tree(corrected)
    deq = dequantize_tree(comp)
    new_residual = tree_map(lambda c, d: c - d, corrected, deq)
    return comp, new_residual


def psum_compressed(shard_trees, devices):
    """The f32 mean over shards of int8-quantized gradients.

    ``shard_trees[d]`` is shard d's gradient tree, and ``devices[d]`` its
    device (a shard elsewhere is moved there first).  Each shard's leaves
    of rank 2 or more are quantized and dequantized on its own device, as
    each reference device does before its ``pmean``; 1-D leaves go as they
    are.  The shards are then added in ascending shard order on shard 0's
    device, with no atomics, the sum divided by the shard count, and the
    mean returned on each shard's device (``pmean``'s result is
    replicated): a list of trees, one a shard.
    """
    if len(shard_trees) != len(devices) or not shard_trees:
        raise ValueError(f"{len(shard_trees)} shard trees for "
                         f"{len(devices)} devices")
    devs = [resolve_device(d) for d in devices]
    n = len(devs)

    def reduce_leaf(*xs):
        parts = []
        for x, dev in zip(xs, devs):
            x = x.to(dev)
            if x.ndim >= 2:
                q, scale = _quantize(x)
                x = q.to(torch.float32) * scale
            parts.append(x)
        total = parts[0]
        for part in parts[1:]:
            total = total + part.to(total.device)
        mean = total / n
        return [mean.to(dev) for dev in devs]

    means = tree_map(reduce_leaf, *shard_trees)
    return [tree_map(lambda m, d=d: m[d], means) for d in range(n)]
