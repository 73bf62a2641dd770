"""Dense oracle for SpGEMM: the ground truth every algorithm is tested
against (the counterpart of the JAX package's ``core/reference.py``)."""

from __future__ import annotations

import torch

from repro_torch.sparse.format import CSC, csc_from_dense, csc_to_dense


def dense_product(a: CSC, b: CSC) -> torch.Tensor:
    """A @ B as a dense tensor on A's values' device (B's values are moved
    there), in the operands' common dtype.  O(m*n*k): tests and small
    inputs only."""
    da, db = csc_to_dense(a), csc_to_dense(b)
    dtype = torch.promote_types(da.dtype, db.dtype)
    return da.to(dtype) @ db.to(device=da.device, dtype=dtype)


def spgemm_dense(a: CSC, b: CSC, tol: float = 0.0) -> CSC:
    """C = A @ B by densification, entries with |c| > tol kept."""
    return csc_from_dense(dense_product(a, b), tol=tol)
