"""K2: SPA SpGEMM over groups of C columns (``csrc/spa.cu``).

The counterpart of the JAX package's Pallas SPA kernel
(``repro/kernels/spa.py::spa_spgemm``): same padded-column operands, same
dense ``[m, n_b]`` accumulator output, same summation order within every
output cell.  On a CUDA tensor :func:`spa_spgemm` launches the hand-written
kernel (one warp per C column) or raises; on a CPU tensor it runs
:func:`spa_spgemm_plain`, the plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, stream_handle


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
    n_b, zb = b_rows.shape
    out = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    _build.launch(
        "repro_spa_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), a_rows.shape[1], b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, out.data_ptr(),
        stream_handle(dev))
    spa_spgemm.n_launches += 1
    return out


spa_spgemm.n_launches = 0


def spa_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, *,
                     m: int) -> torch.Tensor:
    """The kernel's plain PyTorch version, in the kernel's per-cell order.

    Loops over the B entry index ``e`` and vectorizes over (lane, z): within
    one ``e`` every (row, lane) cell written is distinct (the rows of one A
    column are distinct and each lane owns its column), so one indexed
    read-modify-write per ``e`` adds each cell's products with ``e``
    ascending, exactly as the kernel does.
    """
    n_b = b_rows.shape[0]
    za = a_rows.shape[1]
    dev = a_vals.device
    out = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    lanes = torch.arange(n_b, device=dev)[:, None].expand(n_b, za)
    z = torch.arange(za, device=dev)[None, :]
    n_e = int(b_nnz.max()) if n_b else 0   # entries past every b_nnz are no-ops
    for e in range(n_e):
        k = b_rows[:, e].long()
        live = (e < b_nnz)[:, None] & (z < a_nnz[k][:, None])   # [n_b, za]
        rows = a_rows[k].long()[live]
        cols = lanes[live]
        prod = a_vals[k][live] * b_vals[:, e][:, None].expand(n_b, za)[live]
        out[rows, cols] = out[rows, cols] + prod
    return out
