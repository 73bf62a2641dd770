"""Carry operands across from the JAX package.

A ``repro.sparse.format.CSC`` (or ``BatchedCSC``) is handed over as its
numpy arrays, so that both packages multiply the same matrices (or value
stacks); this module imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from repro_torch.device import resolve_device
import torch

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
