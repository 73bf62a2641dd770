"""K2: SPA SpGEMM over groups of C columns (``csrc/spa.cu``).

The counterpart of the JAX package's Pallas SPA kernel
(``repro/kernels/spa.py::spa_spgemm``) and of its vmapped form
(``spa_spgemm_batched``): same padded-column operands, same dense
``[m, n_b]`` accumulator output (``[B, m, n_b]`` batched), same summation
order within every output cell.  On a CUDA tensor the wrappers launch the
hand-written kernel (a CTA per 8 C columns x 512 rows, every cell with
one owner, the batch a second grid axis) or raise; on a CPU tensor they
run :func:`spa_spgemm_batched_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, stream_handle
from repro_torch.kernels.spars import add_in_order, host_array


def _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m, batch, dev):
    """One K2 launch over ``batch`` value sets; output [batch, m, n_b], every
    cell written by the kernel."""
    n_b, zb = b_rows.shape
    out = torch.empty((batch, m, n_b), dtype=torch.float32, device=dev)
    _build.launch(
        "repro_spa_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), *a_rows.shape, b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, m, batch,
        out.data_ptr(), stream_handle(dev))
    return out


def spa_spgemm(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *, m: int,
               block_cols: int = 128, device=None) -> torch.Tensor:
    """Dense C [m, n_b] = A @ B, SPA dataflow.

    ``n_b`` must be a multiple of ``block_cols`` (callers pad; see
    ``kernels.ops``); ``block_cols`` shapes only the reference's grid.
    ``device``, when given, is where the operands must lie.
    """
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                         block_cols=block_cols, device=device)
    if dev.type == "cpu":
        return spa_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                                m=m)
    out = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m, 1, dev)
    spa_spgemm.n_launches += 1
    return out[0]


spa_spgemm.n_launches = 0


def spa_spgemm_batched(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *,
                       m: int, block_cols: int = 128,
                       device=None) -> torch.Tensor:
    """Dense C [B, m, n_b] for B same-pattern value sets, one launch.

    Only the values carry the batch axis (``a_vals [B, n_a, za]``,
    ``b_vals [B, n_b, zb]``); rows and nnz are shared.  Slice b equals
    :func:`spa_spgemm` on value set b bit for bit.
    """
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                         block_cols=block_cols, device=device, batched=True)
    if dev.type == "cpu":
        return spa_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                        b_nnz, m=m)
    out = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m,
                  a_vals.shape[0], dev)
    spa_spgemm_batched.n_launches += 1
    return out


spa_spgemm_batched.n_launches = 0


def spa_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *,
                     m: int) -> torch.Tensor:
    """The kernel's plain PyTorch version for one value set."""
    return spa_spgemm_batched_plain(a_rows, a_vals[None], a_nnz, b_rows,
                                    b_vals[None], b_nnz, m=m)[0]


def spa_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                             *, m: int) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's per-cell order.

    Every product ``a_vals[k, z] * b_vals[lane, e]`` (``k = b_rows[lane,
    e]``, ``e < b_nnz[lane]``, ``z < a_nnz[k]``) from the pattern on the
    host, one gather and multiply for all of them and every batch element;
    each (row, lane) cell adds its products with ``e`` ascending
    (:func:`~repro_torch.kernels.spars.add_in_order`), exactly as the
    kernel does (the rows of one A column are distinct, so a cell takes at
    most one product per ``e``).
    """
    batch = a_vals.shape[0]
    n_b = b_rows.shape[0]
    dev = a_vals.device
    out = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    a_nnz_h = host_array(a_nnz).astype(np.int64)
    b_rows_h = host_array(b_rows).astype(np.int64)
    b_nnz_h = host_array(b_nnz).astype(np.int64)
    za = a_rows.shape[1]
    e = np.arange(b_rows_h.shape[1])
    lane, ent = np.nonzero(e[None, :] < b_nnz_h[:, None])
    k = b_rows_h[lane, ent]
    live = np.arange(za)[None, :] < a_nnz_h[k][:, None]      # [entries, za]
    which, z = np.nonzero(live)
    lane, ent, k = lane[which], ent[which], k[which]
    if len(lane) == 0:
        return out
    order = np.lexsort((z, lane, ent))      # e, then lane, then z
    lane, ent, k, z = lane[order], ent[order], k[order], z[order]
    rows = host_array(a_rows).astype(np.int64)[k, z]
    rows = np.where(rows < 0, rows + m, rows)   # as tensor indexing wraps
    t = (lambda x: torch.from_numpy(x).to(dev))
    prod = a_vals[:, t(k), t(z)] * b_vals[:, t(lane), t(ent)]
    add_in_order(out, rows, lane, prod)
    return out
