"""Plain-torch oracles for the kernels (tests use them; the main path never
does).

All kernels operate on *padded-column* operands (rectangular views of CSC
from ``sparse.csc_to_padded_columns``): ``rows [n_cols, Z]``,
``vals [n_cols, Z]``, ``nnz [n_cols]``, padding slots masked by
``z >= nnz[col]``.  These are the JAX package's ``kernels/ref.py`` in torch,
including what ``spars_ref`` leaves out (see ``kernels.spars``).
"""

from __future__ import annotations

import torch


def _products(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz):
    """(rows, cols, values, live) of every padded product slot."""
    n_b, zb = b_rows.shape
    za = a_rows.shape[1]
    dev = a_vals.device
    k = b_rows.long()                                   # [n_b, zb]
    bmask = torch.arange(zb, device=dev)[None, :] < b_nnz[:, None]
    amask = torch.arange(za, device=dev)[None, None, :] < a_nnz[k][..., None]
    live = bmask[..., None] & amask                     # [n_b, zb, za]
    prod = a_vals[k] * b_vals[..., None]
    cols = torch.arange(n_b, device=dev)[:, None, None].expand_as(prod)
    return a_rows[k].long(), cols, prod, live


def spgemm_padded_ref(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                      m: int) -> torch.Tensor:
    """Dense C [m, n_b] for C = A @ B with both operands padded-column."""
    rows, cols, prod, live = _products(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                       b_nnz)
    c = torch.zeros((m, b_rows.shape[0]), dtype=prod.dtype,
                    device=prod.device)
    return c.index_put_((rows[live], cols[live]), prod[live], accumulate=True)


def spars_ref(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m: int):
    """SPARS computes the same C; flags mark cells a real product touched
    (a B entry on an empty A column touches nothing here)."""
    c = spgemm_padded_ref(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m)
    rows, cols, _, live = _products(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                    b_nnz)
    flags = torch.zeros_like(c)
    flags[rows[live], cols[live]] = 1.0
    return c, flags


def hash_tables_to_dense(table_keys, table_vals, m: int) -> torch.Tensor:
    """Reconstruct dense columns [m, L] from per-lane hash tables [H, L]."""
    h, lanes = table_keys.shape
    valid = table_keys >= 0
    rows = torch.where(valid, table_keys, 0).long().reshape(-1)
    cols = torch.arange(lanes, device=table_keys.device).repeat(h)
    vals = torch.where(valid, table_vals, 0.0).reshape(-1)
    out = torch.zeros((m, lanes), dtype=table_vals.dtype,
                      device=table_vals.device)
    return out.index_put_((rows, cols), vals, accumulate=True)
