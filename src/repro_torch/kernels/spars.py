"""K3: SPARS lock-step SpGEMM, the paper's Algorithm 3 (``csrc/spars.cu``).

The counterpart of the JAX package's Pallas SPARS kernel
(``repro/kernels/spars.py::spars_spgemm``): one lane per C column, one
product per lane per step, cursors ``vidx_b``/``vcnt_a``; outputs the dense
accumulator and the touched-row flags, both f32 ``[m, n_b]``.  On a CUDA
tensor :func:`spars_spgemm` launches the hand-written kernel (one thread per
lane) or raises; on a CPU tensor it runs :func:`spars_spgemm_plain`.

Both follow the reference kernel, not ``kernels.ref.spars_ref``: a B entry
that names an *empty* A column still takes a step, which adds a ±0 product
to row 0 of its lane and sets ``flags[0, lane]`` (``spars_ref`` does not).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, check_steps, \
    stream_handle


def spars_spgemm(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, *,
                 m: int, block_cols: int = 128, device=None):
    """(acc, flags), both [m, n_b] f32, SPARS dataflow.

    ``steps[i]`` is the trip count of lane block i (lanes
    ``[i*block_cols, (i+1)*block_cols)``); ``n_b % block_cols == 0``.
    """
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         block_cols=block_cols, device=device)
    n_b, zb = b_rows.shape
    check_steps(steps, n_b, block_cols)
    if dev.type == "cpu":
        return spars_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                  b_nnz, steps, m=m, block_cols=block_cols)
    acc = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    flags = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    _build.launch(
        "repro_spars_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), a_rows.shape[1], b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, steps.data_ptr(),
        block_cols, acc.data_ptr(), flags.data_ptr(), stream_handle(dev))
    spars_spgemm.n_launches += 1
    return acc, flags


spars_spgemm.n_launches = 0


class LockStep:
    """Lane cursors of the lock-step kernels (SPARS and HASH), vectorized
    over lanes: one :meth:`advance` per step, as in the reference's
    ``step`` body."""

    def __init__(self, a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                 block_cols: int):
        n_b = b_rows.shape[0]
        dev = b_rows.device
        self.a_rows, self.a_vals, self.a_nnz = a_rows, a_vals, a_nnz
        self.b_rows, self.b_vals, self.b_nnz = b_rows, b_vals, b_nnz
        self.lane = torch.arange(n_b, device=dev)
        self.lane_steps = steps.repeat_interleave(block_cols)
        self.vidx_b = torch.zeros(n_b, dtype=torch.int64, device=dev)
        self.vcnt_a = torch.zeros(n_b, dtype=torch.int64, device=dev)
        self.n_steps = int(steps.max()) if len(steps) else 0

    def active(self, s: int) -> torch.Tensor:
        """Lanes that take step ``s`` (cursor not past the last B entry, and
        within the lane block's trip count)."""
        return (self.vidx_b < self.b_nnz) & (s < self.lane_steps)

    def fetch(self, lanes):
        """(row, product) of each given lane's current step."""
        vb = self.vidx_b[lanes]
        k = self.b_rows[lanes, vb].long()
        ka = self.vcnt_a[lanes]
        prod = self.a_vals[k, ka] * self.b_vals[lanes, vb]
        return self.a_rows[k, ka].long(), prod

    def advance(self, lanes) -> None:
        """Cursor update (Algorithm 3 lines 15-19) of the given lanes."""
        k = self.b_rows[lanes, self.vidx_b[lanes]].long()
        last = self.vcnt_a[lanes] + 1 >= self.a_nnz[k]
        self.vcnt_a[lanes] = torch.where(last, 0, self.vcnt_a[lanes] + 1)
        self.vidx_b[lanes] = self.vidx_b[lanes] + last.long()


def spars_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                       *, m: int, block_cols: int = 128):
    """The kernel's plain PyTorch version, in the kernel's per-cell order.

    Loops over steps and vectorizes over lanes; each step writes one cell
    per active lane, in that lane's private column, so an indexed
    read-modify-write without accumulation is exact.
    """
    n_b = b_rows.shape[0]
    dev = a_vals.device
    acc = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    flags = torch.zeros((m, n_b), dtype=torch.float32, device=dev)
    ls = LockStep(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                  block_cols)
    for s in range(ls.n_steps):
        lanes = torch.nonzero(ls.active(s), as_tuple=True)[0]
        if len(lanes) == 0:
            break   # cursors only move on active lanes: none will wake
        rows, prod = ls.fetch(lanes)
        acc[rows, lanes] = acc[rows, lanes] + prod
        flags[rows, lanes] = 1.0
        ls.advance(lanes)
    return acc, flags
