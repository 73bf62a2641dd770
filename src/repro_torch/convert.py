"""Carry operands across from the JAX package.

A ``repro.sparse.format.CSC`` (or ``BatchedCSC``), a param tree (FFN or
whole model) or a ``repro.models.sparse_ffn.SparseMatmul`` are handed over
as their numpy arrays, and a spgemm-path FFN overlay as the reference's
objects, whose patterns are read as numpy arrays, so that both packages
compute on the same matrices (or value stacks, weights, masks); this module
imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.sparse_ffn import SparseFFN, SparseMatmul
from repro_torch.sparse.format import CSC, BatchedCSC, csc_from_numpy


def csc_from_reference(values, row_indices, col_ptr, shape,
                       device=None) -> CSC:
    """The port's CSC of a JAX-package CSC given as numpy arrays.

    Structure stays host numpy (int32); values keep their dtype and go to
    ``device`` (default the card).  Over-allocated inputs are cut to nnz.
    """
    cp = np.asarray(col_ptr)
    nnz = int(cp[-1]) if len(cp) else 0
    m = csc_from_numpy(np.asarray(values)[:nnz],
                       np.asarray(row_indices)[:nnz], cp, shape)
    return m.to(resolve_device(device))


def batched_csc_from_reference(values, row_indices, col_ptr, shape,
                               device=None) -> BatchedCSC:
    """The port's BatchedCSC of a JAX-package BatchedCSC given as numpy
    arrays (``values [B, capacity]``).

    Structure stays host numpy (int32); values keep their dtype and go to
    ``device`` (default the card).  Over-allocated inputs are cut to nnz.
    """
    cp = np.asarray(col_ptr)
    nnz = int(cp[-1]) if len(cp) else 0
    vals = np.ascontiguousarray(np.asarray(values)[:, :nnz])
    return BatchedCSC(torch.from_numpy(vals).to(resolve_device(device)),
                      np.asarray(row_indices)[:nnz].astype(np.int32),
                      cp.astype(np.int32), tuple(int(s) for s in shape))


def model_params_from_reference(params, device=None) -> dict:
    """The port's param tree (nested dicts of f32 tensors on ``device``,
    default the card) of a JAX-package param tree given as numpy arrays:
    a whole LM's (stacked ``[n_rep, ...]`` leaves, the MoE layers'
    ``[n_rep, E, d, f]`` expert stacks, the hybrid family's unstacked
    ``shared`` table, and ``[n_rep, nnz]`` FFN value stacks after
    ``sparsify_ffn_params``) or one FFN's, subtree for subtree."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node, np.float32)).to(dev)

    return walk(params)


def train_state_from_reference(state, device=None) -> dict:
    """The port's train state of a JAX-package one given as numpy arrays
    (``{"params", "opt": {"step", "m", "v"}}``, 8-bit moments as
    ``{"q", "scale"}``), every leaf in its own dtype on ``device`` (default
    the card), so that both packages train from one state."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return torch.from_numpy(np.array(node)).to(dev)

    return {"params": walk(state["params"]), "opt": walk(state["opt"])}


# an FFN's params (``{"gate"/"up"/"down": {"w": [d_in, d_out]}}``) are a
# param tree like a model's
ffn_params_from_reference = model_params_from_reference


def sparse_matmul_from_reference(path, dense_w, block_idx, block_nnz, blocks,
                                 shape, density, device=None, *, w_csc=None,
                                 stream_limit=None) -> SparseMatmul:
    """The port's SparseMatmul of a JAX-package one given as its fields in
    numpy (``dense_w`` on the dense path, the padded BSR arrays on the bsr
    path, ``w_csc = (values, row_indices, col_ptr)`` and ``stream_limit`` on
    the spgemm path, None for the others), on ``device`` (default the card).

    The BSR indices are checked here, on the host: the kernel trusts them.
    The spgemm path's pattern stays host numpy, its values go to the device.
    """
    dev = resolve_device(device)
    shape = tuple(int(s) for s in shape)
    if path == "spgemm":
        values, row_indices, col_ptr = w_csc
        csc = csc_from_reference(np.array(values, np.float32), row_indices,
                                 col_ptr, shape, device=dev)
        return SparseMatmul("spgemm", None, None, None, None, shape,
                            float(density), w_csc=csc,
                            stream_limit=stream_limit)
    if path == "dense":
        w = np.asarray(dense_w, np.float32)
        if w.shape != shape:
            raise ValueError(f"dense_w {w.shape} is not {shape}")
        return SparseMatmul("dense", torch.from_numpy(w.copy()).to(dev),
                            None, None, None, shape, float(density))
    if path != "bsr":
        raise ValueError(
            f"unknown path {path!r}; 'dense', 'bsr' or 'spgemm'")
    bi = np.asarray(block_idx, np.int32)
    bn = np.asarray(block_nnz, np.int32)
    blk = np.asarray(blocks, np.float32)
    n_rb, max_nb, bm, bk = blk.shape
    n_cb = shape[1] // bk
    live = np.arange(max_nb)[None, :] < bn[:, None]
    if bi.shape != (n_rb, max_nb) or bn.shape != (n_rb,) \
            or shape != (n_rb * bm, n_cb * bk) or (bn > max_nb).any() \
            or (bn < 0).any() or (bi[live] < 0).any() \
            or (bi[live] >= n_cb).any():
        raise ValueError(
            f"BSR arrays {bi.shape}, {bn.shape}, {blk.shape} do not hold a "
            f"{shape} weight in {bm}x{bk} blocks")
    return SparseMatmul("bsr", None, *(torch.from_numpy(a.copy()).to(dev)
                                       for a in (bi, bn, blk)),
                        shape, float(density))


def overlay_from_reference(overlay, device=None) -> dict:
    """The port's spgemm-path FFN overlay of the JAX package's (the
    ``overlay`` that its ``sparsify_ffn_params`` returns, ``{"l{i}":
    SparseFFN}``): each matmul's pattern, rep-0 values, density and
    ``stream_limit`` read as numpy, on ``device`` (default the card).  The
    value stacks travel with the params (:func:`model_params_from_reference`),
    so both packages run the same weights on the same masks."""

    def matmul(m):
        c = m.w_csc
        return sparse_matmul_from_reference(
            "spgemm", None, None, None, None, c.shape, m.density, device,
            w_csc=(np.asarray(c.values), np.asarray(c.row_indices),
                   np.asarray(c.col_ptr)),
            stream_limit=m.stream_limit)

    return {li: SparseFFN(matmul(f.gate), matmul(f.up), matmul(f.down))
            for li, f in overlay.items()}
