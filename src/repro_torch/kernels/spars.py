"""K3: SPARS lock-step SpGEMM, the paper's Algorithm 3 (``csrc/spars.cu``).

The counterpart of the JAX package's Pallas SPARS kernel
(``repro/kernels/spars.py::spars_spgemm``) and of its vmapped form
(``spars_spgemm_batched``): one lane per C column, one product per lane per
step, cursors ``vidx_b``/``vcnt_a``; outputs the dense accumulator and the
touched-row flags, both f32 ``[m, n_b]`` (``[B, m, n_b]`` batched).  On a
CUDA tensor the wrappers launch the hand-written kernel (K2's slice kernel
in lock-step: a CTA per 8 C columns x 512 rows, every cell with one owner
and stored once, the batch a second grid axis) or raise; on a CPU tensor
they run :func:`spars_spgemm_batched_plain`.

Both follow the reference kernel, not ``kernels.ref.spars_ref``: a B entry
that names an *empty* A column still takes a step, which adds the product
of that column's padding slot 0 (row 0 and value 0 in a plan's operands) to
its lane and sets the slot's row in ``flags`` (``spars_ref`` does not).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._checks import check_operands, check_steps, \
    stream_handle


def _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, m,
            block_cols, batch, dev):
    """One K3 launch over ``batch`` value sets; (acc, flags) [batch, m,
    n_b], every cell of both written by the kernel."""
    n_b, zb = b_rows.shape
    acc = torch.empty((batch, m, n_b), dtype=torch.float32, device=dev)
    flags = torch.empty((batch, m, n_b), dtype=torch.float32, device=dev)
    _build.launch(
        "repro_spars_launch", a_rows.data_ptr(), a_vals.data_ptr(),
        a_nnz.data_ptr(), *a_rows.shape, b_rows.data_ptr(),
        b_vals.data_ptr(), b_nnz.data_ptr(), n_b, zb, steps.data_ptr(),
        block_cols, m, batch, acc.data_ptr(), flags.data_ptr(),
        stream_handle(dev))
    return acc, flags


def spars_spgemm(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, *,
                 m: int, block_cols: int = 128, device=None):
    """(acc, flags), both [m, n_b] f32, SPARS dataflow.

    ``steps[i]`` is the trip count of lane block i (lanes
    ``[i*block_cols, (i+1)*block_cols)``); ``n_b % block_cols == 0``.
    """
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         block_cols=block_cols, device=device)
    check_steps(steps, b_rows.shape[0], block_cols)
    if dev.type == "cpu":
        return spars_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals,
                                  b_nnz, steps, m=m, block_cols=block_cols)
    acc, flags = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         m, block_cols, 1, dev)
    spars_spgemm.n_launches += 1
    return acc[0], flags[0]


spars_spgemm.n_launches = 0


def spars_spgemm_batched(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         *, m: int, block_cols: int = 128, device=None):
    """(acc, flags), both [B, m, n_b] f32, for B same-pattern value sets in
    one launch.

    Only the values carry the batch axis (``a_vals [B, n_a, za]``,
    ``b_vals [B, n_b, zb]``); rows, nnz and the trip counts are shared.
    Slice b equals :func:`spars_spgemm` on value set b bit for bit.
    """
    dev = check_operands(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                         block_cols=block_cols, device=device, batched=True)
    check_steps(steps, b_rows.shape[0], block_cols)
    if dev.type == "cpu":
        return spars_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows,
                                          b_vals, b_nnz, steps, m=m,
                                          block_cols=block_cols)
    out = _launch(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps, m,
                  block_cols, a_vals.shape[0], dev)
    spars_spgemm_batched.n_launches += 1
    return out


spars_spgemm_batched.n_launches = 0


class LockStep:
    """Lane cursors of the lock-step kernels (SPARS and HASH), vectorized
    over lanes: one :meth:`advance` per step, as in the reference's
    ``step`` body.  The cursors depend on the pattern alone, so B value
    sets (``a_vals [B, n_a, za]``, ``b_vals [B, n_b, zb]``) share them."""

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
        """(row [L], product [B, L]) of each given lane's current step."""
        vb = self.vidx_b[lanes]
        k = self.b_rows[lanes, vb].long()
        ka = self.vcnt_a[lanes]
        prod = self.a_vals[:, k, ka] * self.b_vals[:, lanes, vb]
        return self.a_rows[k, ka].long(), prod

    def advance(self, lanes) -> None:
        """Cursor update (Algorithm 3 lines 15-19) of the given lanes."""
        k = self.b_rows[lanes, self.vidx_b[lanes]].long()
        last = self.vcnt_a[lanes] + 1 >= self.a_nnz[k]
        self.vcnt_a[lanes] = torch.where(last, 0, self.vcnt_a[lanes] + 1)
        self.vidx_b[lanes] = self.vidx_b[lanes] + last.long()


def spars_spgemm_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                       *, m: int, block_cols: int = 128):
    """The kernel's plain PyTorch version for one value set."""
    acc, flags = spars_spgemm_batched_plain(
        a_rows, a_vals[None], a_nnz, b_rows, b_vals[None], b_nnz, steps, m=m,
        block_cols=block_cols)
    return acc[0], flags[0]


def spars_spgemm_batched_plain(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz,
                               steps, *, m: int, block_cols: int = 128):
    """The kernel's plain PyTorch version, in the kernel's per-cell order.

    Loops over steps and vectorizes over (batch, lane); each step writes
    one cell per active lane, in that lane's private column, so an indexed
    read-modify-write without accumulation is exact.
    """
    batch = a_vals.shape[0]
    n_b = b_rows.shape[0]
    dev = a_vals.device
    acc = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    flags = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    ls = LockStep(a_rows, a_vals, a_nnz, b_rows, b_vals, b_nnz, steps,
                  block_cols)
    for s in range(ls.n_steps):
        lanes = torch.nonzero(ls.active(s), as_tuple=True)[0]
        if len(lanes) == 0:
            break   # cursors only move on active lanes: none will wake
        rows, prod = ls.fetch(lanes)
        acc[:, rows, lanes] = acc[:, rows, lanes] + prod
        flags[:, rows, lanes] = 1.0
        ls.advance(lanes)
    return acc, flags
