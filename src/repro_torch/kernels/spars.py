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

import numpy as np
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


def host_array(t: torch.Tensor) -> np.ndarray:
    """A pattern tensor read back to the host (numpy)."""
    return t.detach().cpu().numpy()


def lockstep_walk(a_nnz, b_rows, b_nnz, steps, block_cols: int):
    """The lock-step kernels' walk (SPARS and HASH), from the pattern alone.

    Lane ``l`` (a C column) steps through its B entries ``vb`` in order and,
    for each, through the entries ``ka`` of A column ``k = b_rows[l, vb]``
    (one step for an empty A column: the reference's cursor update, Algorithm
    3 lines 15-19), for at most its lane block's trip count
    ``steps[l // block_cols]`` steps.  Returns host int64 arrays ``(step,
    lane, vb, k, ka)``, one entry per step a lane takes, ordered by step and
    within a step by lane: the order in which the kernel's lock-step rounds
    take them.  The operands are read back once (a few host syncs a call,
    not one a step); B value sets share the walk."""
    a_nnz = host_array(a_nnz).astype(np.int64)
    b_rows = host_array(b_rows).astype(np.int64)
    b_nnz = host_array(b_nnz).astype(np.int64)
    n_b, zb = b_rows.shape
    lane_steps = np.repeat(host_array(steps).astype(np.int64), block_cols)
    entry = np.arange(zb)[None, :] < b_nnz[:, None]            # [n_b, zb]
    lane_e = np.nonzero(entry)[0]
    vb_e = np.nonzero(entry)[1]
    k_e = b_rows[lane_e, vb_e]
    cnt = np.maximum(a_nnz[k_e], 1)
    # a lane's steps, entry after entry
    idx = np.repeat(np.arange(len(k_e)), cnt)
    first = np.cumsum(cnt) - cnt
    ka = np.arange(len(idx)) - first[idx]
    lane_first = np.searchsorted(lane_e, np.arange(n_b))
    step = np.arange(len(idx)) - first[lane_first[lane_e[idx]]]
    keep = step < lane_steps[lane_e[idx]]
    idx, ka, step = idx[keep], ka[keep], step[keep]
    order = np.lexsort((lane_e[idx], step))
    idx, ka, step = idx[order], ka[order], step[order]
    return step, lane_e[idx], vb_e[idx], k_e[idx], ka


def add_in_order(out: torch.Tensor, rows: np.ndarray, cols: np.ndarray,
                 prod: torch.Tensor) -> None:
    """``out[:, rows[i], cols[i]] += prod[:, i]`` for every i, each cell's
    products added one at a time in the order of i.

    One indexed read-modify-write per rank: the i that are the j-th product
    of their cell (distinct cells) go together, j ascending, so each cell
    sums exactly as a loop over i would, with as many launches as the most
    products any one cell takes.  ``rows``/``cols``: host int64."""
    n = len(rows)
    if n == 0:
        return
    cell = rows * out.shape[-1] + cols
    by_cell = np.argsort(cell, kind="stable")
    sorted_cell = cell[by_cell]
    start = np.r_[True, sorted_cell[1:] != sorted_cell[:-1]]
    pos = np.arange(n)
    rank = np.empty(n, np.int64)
    rank[by_cell] = pos - np.maximum.accumulate(np.where(start, pos, 0))
    by_rank = np.argsort(rank, kind="stable")
    bounds = np.r_[0, np.cumsum(np.bincount(rank))]
    dev = out.device
    r = torch.from_numpy(rows[by_rank]).to(dev)
    c = torch.from_numpy(cols[by_rank]).to(dev)
    p = prod[:, torch.from_numpy(by_rank).to(dev)]
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        rj, cj = r[lo:hi], c[lo:hi]
        out[:, rj, cj] = out[:, rj, cj] + p[:, lo:hi]


def walk_rows(a_rows, walk) -> np.ndarray:
    """Each step's A row (host int64), in the walk's order."""
    return host_array(a_rows).astype(np.int64)[walk[3], walk[4]]


def walk_products(a_vals, b_vals, walk) -> torch.Tensor:
    """Each step's product ``[B, n]`` of every value set, in the walk's
    order: one gather and multiply for all steps."""
    _, lane, vb, k, ka = walk
    dev = a_vals.device
    t = (lambda x: torch.from_numpy(x).to(dev))
    return a_vals[:, t(k), t(ka)] * b_vals[:, t(lane), t(vb)]


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

    The walk (:func:`lockstep_walk`) comes from the pattern on the host;
    every step's product is one gather and multiply for all steps and value
    sets, and each cell -- a lane's private (row, column) -- adds its
    products in step order (:func:`add_in_order`), exactly as the kernel's
    rounds do.  The touched rows' flags are set once.
    """
    batch = a_vals.shape[0]
    n_b = b_rows.shape[0]
    dev = a_vals.device
    acc = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    flags = torch.zeros((batch, m, n_b), dtype=torch.float32, device=dev)
    walk = lockstep_walk(a_nnz, b_rows, b_nnz, steps, block_cols)
    if len(walk[0]) == 0:
        return acc, flags
    rows = walk_rows(a_rows, walk)
    rows = np.where(rows < 0, rows + m, rows)   # as tensor indexing wraps
    prod = walk_products(a_vals, b_vals, walk)
    lanes = walk[1]
    add_in_order(acc, rows, lanes, prod)
    flags[:, torch.from_numpy(rows).to(dev),
          torch.from_numpy(lanes).to(dev)] = 1.0
    return acc, flags
