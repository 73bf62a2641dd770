"""K2: SPA SpGEMM over groups of C columns (``csrc/spa.cu``).

The counterpart of the JAX package's Pallas SPA kernel
(``repro/kernels/spa.py::spa_spgemm``) and of its vmapped form
(``spa_spgemm_batched``): same padded-column operands, same dense
``[m, n_b]`` accumulator output (``[B, m, n_b]`` batched), same summation
order within every output cell.  On a CUDA tensor the wrappers launch the
hand-written kernel (one warp per C column, the batch a second grid axis)
or raise; on a CPU tensor they run :func:`spa_spgemm_batched_plain`, the
plain PyTorch version.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, stream_handle


def _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, m, batch, dev):
    """One K2 launch over ``batch`` value sets; output [batch, m, n_b]."""
    n_b, zb = b_rows.shape
    out = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
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

    Loops over the B entry index ``e`` and vectorizes over (batch, lane,
    z): within one ``e`` every (row, lane) cell written is distinct (the
    rows of one A column are distinct and each lane owns its column), so
    one indexed read-modify-write per ``e`` adds each cell's products with
    ``e`` ascending, exactly as the kernel does, in every batch element.
    """
    batch = a_vals.shape[0]
    n_b = b_rows.shape[0]
    za = a_rows.shape[1]
    dev = a_vals.device
    out = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    lanes = torch.arange(n_b, device=dev)[:, None].expand(n_b, za)
    z = torch.arange(za, device=dev)[None, :]
    n_e = int(b_nnz.max()) if n_b else 0   # entries past every b_nnz are no-ops
    for e in range(n_e):
        k = b_rows[:, e].long()
        live = (e < b_nnz)[:, None] & (z < a_nnz[k][:, None])   # [n_b, za]
        rows = a_rows[k].long()[live]
        cols = lanes[live]
        prod = (a_vals[:, k][:, live]
                * b_vals[:, :, e, None].expand(batch, n_b, za)[:, live])
        out[:, rows, cols] = out[:, rows, cols] + prod
    return out
